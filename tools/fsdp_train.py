#!/usr/bin/env python3
"""Training with parameters, gradients and AdamW moments placed over the
cards of one host (FSDP on "data", tensor-parallel on "model").

Starts one process a card (NCCL; the rendezvous is a ``file://`` store
in a temp dir) and runs, each rank on its rows of every global batch:

  1. Qwen3-0.6B at full width on one card (rank 0 alone, no mesh): the
     baseline losses and peak;
  2. the same steps on the (cards, 1) and the (cards / 2, 2) meshes:
     every loss within ``--loss-rtol`` of the baseline's, a lower peak
     on every rank, and the bytes each rank holds for parameters,
     gradients and moments equal to the reference's placed bytes;
  3. OLMoE-1B-7B at full width and depth on (cards, 1) (its replicated
     bf16 weights, bf16 gradients and f32 moments, ~82.8 GB, fit no
     80 GB card): finite losses, held == placed;
  4. a sharded prefill and DECODE_STEPS decodes of Qwen3-0.6B at full
     width on (cards / 2, 2) under ``serving_rules``: each rank computes
     its H/2 q heads (the flash kernel K5 launched on them, a launch a
     layer) and its vocab block of the logits, which, gathered, must be
     one card's within ``SERVE_LOGIT_RTOL``.

Each run prints one JSON line from rank 0 (median step ms over the steps
after the first, tokens/s, the peak allocated GiB of each rank, held and
placed bytes, the collective bytes a step by mesh axis; the serving run
its prefill and decode ms beside one card's); any check that fails exits
non-zero.  Needs ``--cards``
CUDA devices; ``--device cpu`` rehearses it in gloo ranks at the reduced
configs (host-clock times, not device metrics).  ``--trace`` needs no
card: it runs each run's step once on fake tensors over a fake group of
``--cards`` ranks (``launch/dryrun.py``) and prints the peak bytes it
predicts for a rank, and the peak of the gradient step alone (the rest
is the optimizer's update).  On the cards each training run's line
carries rank 0's ``torch.profiler`` breakdown of one more step, after
the timed ones: device time by kind of kernel (collectives, GEMMs, the
rest) against the step's host-clock wall:

  python3 tools/fsdp_train.py --cards 4
  python3 tools/fsdp_train.py --device cpu --cards 4
  python3 tools/fsdp_train.py --trace --cards 4
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (arch, mesh, steps): the one-card baseline is mesh None
RUNS = (("qwen3_0_6b", None, 5), ("qwen3_0_6b", "cards", 5),
        ("qwen3_0_6b", "half", 5), ("olmoe_1b_7b", "cards", 4))
SEQ, GLOBAL_BATCH = 1024, 8
SMOKE_SEQ, SMOKE_BATCH = 32, 4
# sharded against one card, a loss a step: the losses are means over
# 8192 tokens of the same bf16 model, whose sums run in another order
# (the batch split over ranks, the gradients' reduce-scatter), far
# below a bf16 spacing of 2**-8 relative; in f32 (the CPU rehearsal)
# the twins' 1e-4 (tests/test_torch_fsdp.py)
LOSS_RTOL = {"cuda": 1e-3, "cpu": 1e-4}
# the serving run: a prompt of SERVE_PROMPT tokens for each of
# SERVE_BATCH sequences, then DECODE_STEPS decodes of fixed tokens
SERVE_BATCH, SERVE_PROMPT, DECODE_STEPS = 8, 1024, 16
SMOKE_SERVE_PROMPT = 16
# sharded logits against one card's, max abs difference over max abs
# logit: in bf16 the row-parallel sums round each rank's partial to bf16
# before the all-reduce, once a projection a layer (chip_smoke.py's
# SERVE_LOGIT_TOL for bf16 logits); in f32 the twins' 1e-4
# (tests/test_torch_tensor_parallel.py)
SERVE_LOGIT_RTOL = {"cuda": 5e-2, "cpu": 1e-4}


def held_and_placed(cfg, rules, trees: dict, device="cuda") -> dict:
    """{name: [held bytes, placed bytes]} for each list of trees in
    ``trees`` (parameters, gradients, moments: each a tree of the
    parameters' paths): the bytes this rank's tensors take, beside the
    bytes the reference's placements give a device for the config's
    global shapes (from the config alone, on fake tensors)."""
    import math
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import Model
    from repro_torch.models.sharding import NO_MESH, local_shape
    from repro_torch.tree import tree_flatten
    with FakeTensorMode():
        whole = tree_flatten(Model(cfg, NO_MESH).abstract(device))[1]
    places = tree_flatten(Model(cfg, rules).placements())[1]
    out = {}
    for name, group in trees.items():
        held = placed = 0
        for tree in group:
            leaves = tree_flatten(tree)[1]
            held += sum(t.numel() * t.element_size() for t in leaves)
            placed += sum(math.prod(local_shape(w.shape, pl))
                          * t.element_size()
                          for t, w, pl in zip(leaves, whole, places))
        out[name] = [held, placed]
    return out


def profile_step(run) -> dict:
    """One call of ``run`` under ``torch.profiler`` (CPU and CUDA): its
    host-clock wall, the device time of its kernels by kind (NCCL
    collectives, GEMMs, the rest; the collectives run on their own
    stream, so the kinds can overlap) and the eight longest kernels.
    None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # the profiler mirrors each NCCL kernel as an "nccl:..." range of the
    # same device time: those ranges are left out, not counted twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0
              and not e.key.startswith("nccl:")]
    if not events:
        return None
    kinds = {"collective": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        name = e.key.lower()
        kind = ("collective" if "nccl" in name else "gemm" if any(
            w in name for w in ("gemm", "nvjet", "xmma", "cutlass"))
            else "other")
        kinds[kind] += device_us(e) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {"wall_ms": wall * 1e3, "device_ms_by_kind": kinds,
            "device_busy_share": sum(kinds.values()) / (wall * 1e3),
            "top_kernels": [[e.key[:80], device_us(e) / 1e3, e.count]
                            for e in top]}


def one_run(arch, mesh_kind, steps, rank, world, device, smoke):
    """This rank's part of one run; the numbers rank 0 prints."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import _batch_rows
    from repro_torch.models.sharding import NO_MESH, rules_for_mesh
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.optim import adamw

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config(arch)
    cfg = cfg.reduced() if smoke else cfg
    seq, gb = (SMOKE_SEQ, SMOKE_BATCH) if smoke else (SEQ, GLOBAL_BATCH)
    if mesh_kind is None:
        rules, shape = NO_MESH, (1, 1)
    else:
        mp = 1 if mesh_kind == "cards" else 2
        rules = rules_for_mesh(make_mesh_for_devices(world, mp,
                                                     device=device))
        shape = (world // mp, mp)
    row = {"arch": cfg.name, "mesh": list(shape), "dtype": cfg.dtype,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(), "seq_len": seq,
           "global_batch": gb}
    if mesh_kind is None and rank != 0:
        return None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    grad_step, model = S.make_grad_step(cfg, rules)
    step, _ = S.make_train_step(cfg, rules, adamw.AdamWConfig(
        total_steps=steps, warmup_steps=1))
    params = model.init(0, device=device)
    state = adamw.init_state(params)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=gb, seed=0)
    rows = _batch_rows(rules, gb)

    def batch(i):
        return {k: torch.from_numpy(v[rows]).to(device)
                for k, v in batch_at_step(dc, i).items()
                if k in ("tokens", "labels")}

    grads, _, _ = grad_step(params, batch(0), global_batch=gb)
    row["bytes"] = held_and_placed(cfg, rules, {
        "params": [params], "grads": [grads],
        "moments": [state["m"], state["v"]]}, device)
    del grads
    losses, times = [], []
    D.reset_collectives()
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch(i), global_batch=gb)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    row["collective_bytes_per_step_by_axis"] = {
        a: {k: v // steps for k, v in c.items()}
        for a, c in D.COLLECTIVE_BYTES_BY_AXIS.items()}
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
            else 0.0)
    if on_card:
        # every rank of a mesh steps (the collectives need them all);
        # rank 0's line is the one printed
        out = {}

        def run():
            out["step"] = step(params, state, batch(0), global_batch=gb)
            float(out["step"][2]["loss"])
        row["profile"] = profile_step(run)
        params, state = out["step"][0], out["step"][1]
    peaks = [peak]
    if mesh_kind is not None:
        every = torch.zeros(world, dtype=torch.float64, device=device)
        every[rank] = peak
        dist.all_reduce(every)
        peaks = every.tolist()
    med = statistics.median(times[1:])
    row.update(losses=losses, step_ms=[t * 1e3 for t in times],
               median_step_ms=med * 1e3, tokens_per_s=gb * seq / med,
               peak_gib_by_rank=peaks)
    del params, state
    if not all(np.isfinite(v) for v in losses):
        raise SystemExit(f"{cfg.name} {shape}: non-finite loss {losses}")
    for name, (held, placed) in row["bytes"].items():
        if held != placed:
            raise SystemExit(f"{cfg.name} {shape}: {name} held {held} "
                             f"bytes, placed {placed}")
    return row


def serve_run(rank, world, device, smoke):
    """Rank 0 alone, then (world / 2, 2): Qwen3-0.6B's prefill and
    DECODE_STEPS decodes from the seed's weights under ``serving_rules``;
    the logits of each step gathered over vocab and batch.  Returns
    (one card's row, the mesh's row, with its logits' difference from
    one card's) on rank 0, (None, the mesh's row) elsewhere."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.launch.train import _batch_rows
    from repro_torch.models.attention import head_split
    from repro_torch.models.sharding import NO_MESH, rules_for_mesh

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config("qwen3_0_6b")
    cfg = cfg.reduced() if smoke else cfg
    prompt_len = SMOKE_SERVE_PROMPT if smoke else SERVE_PROMPT
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, prompt_len))
    toks = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, SERVE_BATCH))
    mesh_rules = rules_for_mesh(make_mesh_for_devices(world, 2,
                                                      device=device))

    def one(rules):
        srules = S.serving_rules(cfg, rules)
        prefill, model = S.make_prefill_step(cfg, srules)
        decode, _ = S.make_decode_step(cfg, srules)
        rows = _batch_rows(srules, SERVE_BATCH)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(0, device=device)

        def whole(logits):
            if srules.mesh is None:
                return logits.float().cpu().numpy()
            lg = D.all_gather(logits, srules.group("model"), dim=-1)
            return D.all_gather(lg, srules.group("data"), dim=0
                                ).float().cpu().numpy()

        with torch.no_grad():
            tokens = torch.tensor(prompt[rows], dtype=torch.int32,
                                  device=device)
            # a first prefill loads the kernels; the one timed is the next
            prefill(params, {"tokens": tokens})
            kfa.LAUNCHES_BY_PATH.clear()
            D.reset_collectives()
            sync()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": tokens})
            sync()
            prefill_s = time.perf_counter() - t0
            launches = {p: dict(c) for p, c in kfa.LAUNCHES_BY_PATH.items()}
            coll = {a: dict(c) for a, c in
                    D.COLLECTIVE_BYTES_BY_AXIS.items()}
            logits_shape = list(logits.shape)
            cache = model.pad_cache(cache, prompt_len + DECODE_STEPS)
            got, times = [whole(logits[:, -1])], []
            for i in range(DECODE_STEPS):
                tok = torch.tensor(toks[i][rows], dtype=torch.int32,
                                   device=device)
                pos = torch.full((tokens.shape[0],), prompt_len + i,
                                 dtype=torch.int32, device=device)
                sync()
                t0 = time.perf_counter()
                lg, cache = decode(params, cache, tok, pos)
                sync()
                times.append(time.perf_counter() - t0)
                got.append(whole(lg))
        n = head_split(cfg, srules)[0]
        row = {"arch": cfg.name, "run": "serve",
               "mesh": [1, 1] if srules.mesh is None else [world // 2, 2],
               "dtype": cfg.dtype, "batch": SERVE_BATCH,
               "prompt_len": prompt_len, "decode_steps": DECODE_STEPS,
               "q_heads_per_rank": cfg.n_heads // n,
               "prefill_ms": prefill_s * 1e3,
               "decode_ms": [t * 1e3 for t in times],
               "median_decode_ms": statistics.median(times) * 1e3,
               "k5_launches_per_rank": launches,
               "prefill_collective_bytes_by_axis": coll,
               "logits_shape_per_rank": logits_shape,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if on_card else 0.0)}
        del params, cache
        return row, got

    base = one(NO_MESH) if rank == 0 else None
    dist.barrier()
    row, got = one(mesh_rules)
    if on_card:
        want = {"mma": {"bfloat16": cfg.n_layers}}
        if row["k5_launches_per_rank"] != want:
            raise SystemExit(f"sharded prefill: K5 launches "
                             f"{row['k5_launches_per_rank']}, want {want}")
    if base is None:
        return None, row
    row["logits_rel_diff_vs_one_card"] = [
        float(np.abs(g - w).max() / np.abs(w).max())
        for g, w in zip(got, base[1])]
    return base[0], row


def trace(cards: int) -> None:
    """Each run's step traced as rank 0 of ``cards`` fake ranks: one JSON
    line a run with the predicted peak GiB of the whole step and of its
    gradient step alone (arguments included)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models.sharding import NO_MESH, rules_for_mesh

    device = dryrun.default_device()
    shape = ShapeConfig("fsdp_train", SEQ, GLOBAL_BATCH, "train")
    with dryrun.fake_group(cards):
        for arch, mesh_kind, _ in RUNS:
            cfg = get_config(arch)
            mp = 1 if mesh_kind in (None, "cards") else 2
            rules = NO_MESH if mesh_kind is None else rules_for_mesh(
                make_mesh_for_devices(cards, mp, device=device))
            mem = dryrun.trace_step(cfg, shape, rules, device=device,
                                    costs=False)["memory"]
            with FakeTensorMode():
                grad_step, _ = S.make_grad_step(cfg, rules)
                params, state = S.abstract_train_state(cfg, rules, device)
                batch = S.input_specs(cfg, shape, rules, device)
                tally = dryrun._Tally(costs=False)
                for t in tree_leaves((params, state, batch)):
                    tally.hold(t)
                with tally:
                    grad_step(params, batch, global_batch=GLOBAL_BATCH)
            print(json.dumps({"fsdp_trace": {
                "arch": cfg.name, "mesh": None if mesh_kind is None
                else [cards // mp, mp], "device": device,
                "held_gib": mem["argument_size_in_bytes"] / 2 ** 30,
                "peak_gib": (mem["argument_size_in_bytes"]
                             + mem["temp_size_in_bytes"]) / 2 ** 30,
                "grad_step_peak_gib": tally.peak / 2 ** 30}}), flush=True)


def rank_main(rank: int, world: int, store: str, device: str,
              smoke: bool, loss_rtol: float) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group

    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    rows = []
    try:
        for arch, mesh_kind, steps in RUNS:
            row = one_run(arch, mesh_kind, steps, rank, world, device,
                          smoke)
            dist.barrier()
            if device == "cuda":
                torch.cuda.empty_cache()
            if rank != 0:
                continue
            base = rows[0] if rows and arch == rows[0]["arch"] \
                and mesh_kind is not None else None
            if base is not None:
                rel = [abs(a - b) / abs(b)
                       for a, b in zip(row["losses"], base["losses"])]
                row["loss_rel_diff_vs_one_card"] = rel
                row["loss_rtol"] = loss_rtol
                if max(rel) > loss_rtol:
                    raise SystemExit(f"{row['arch']} {row['mesh']}: losses "
                                     f"{row['losses']} vs one card "
                                     f"{base['losses']} (rel {max(rel):.2e})")
                if device == "cuda" and not max(
                        row["peak_gib_by_rank"]) < base["peak_gib_by_rank"][0]:
                    raise SystemExit(f"{row['arch']} {row['mesh']}: peak "
                                     f"{row['peak_gib_by_rank']} GiB, one "
                                     f"card {base['peak_gib_by_rank']}")
            rows.append(row)
            print(json.dumps({"fsdp_train": row}), flush=True)
        base, served = serve_run(rank, world, device, smoke)
        dist.barrier()
        if rank == 0:
            rtol = SERVE_LOGIT_RTOL[device]
            served["logits_rtol"] = rtol
            print(json.dumps({"fsdp_serve": base}), flush=True)
            print(json.dumps({"fsdp_serve": served}), flush=True)
            rows += [base, served]
            if not max(served["logits_rel_diff_vs_one_card"]) <= rtol:
                raise SystemExit(f"sharded serving: logits "
                                 f"{served['logits_rel_diff_vs_one_card']} "
                                 f"off one card's (limit {rtol})")
        if rank == 0 and os.environ.get("FSDP_TRAIN_OUT"):
            with open(os.environ["FSDP_TRAIN_OUT"], "w") as f:
                json.dump(rows, f, indent=1)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="write the runs' JSON rows here")
    ap.add_argument("--trace", action="store_true",
                    help="predict each run's peak on fake tensors (no card)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    smoke = args.device == "cpu"
    if args.cards % 2:
        print("fsdp_train: needs an even number of cards", file=sys.stderr)
        return 1
    if args.trace:
        trace(args.cards)
        return 0
    if args.rank is not None:
        rank_main(args.rank, args.cards, args.store, args.device, smoke,
                  LOSS_RTOL[args.device])
        return 0
    import torch
    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        print(f"fsdp_train: needs {args.cards} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if args.out:
        env["FSDP_TRAIN_OUT"] = os.path.abspath(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--cards", str(args.cards),
             "--device", args.device, "--rank", str(r), "--store", store],
            env=dict(env, LOCAL_RANK=str(r))) for r in range(args.cards)]
        try:
            # a rank that fails leaves the others in a collective: stop
            # at the first failure (or after 1500 s), not at a join
            deadline = time.monotonic() + 1500
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        rcs = [p.returncode for p in procs]
    print(f"fsdp_train: {time.perf_counter() - t0:.1f} s, exit codes {rcs}",
          flush=True)
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
