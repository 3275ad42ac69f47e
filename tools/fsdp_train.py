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
  4. Mamba2-780M at full width on one card, on (cards, 1) and on
     (cards / 2, 2), where a rank computes its H/2 SSM heads, in bf16
     and in f32: losses within LOSS_RTOL of one card's in the same
     dtype.  Every run with a one-card baseline also holds its first
     gradient, gathered, against the baseline's leaf by leaf (normwise;
     in f32 within GRAD_RTOL), which tells a sharding fault from
     AdamW's amplification of rounding; the baseline prints, as a
     control, its own gradient against the mean of its SPLIT_BLOCKS row
     blocks' (a data split with no collective).  ``--cards 1`` runs the
     one-card baselines alone;
  5. a sharded prefill and DECODE_STEPS decodes on (cards / 2, 2) under
     ``serving_rules`` of each of SERVE_RUNS at full width (DeepSeek-V3
     cut to 4 layers): each rank computes its H/2 q heads (Qwen3's and
     Zamba2's shared block's on the flash kernel K5, a launch an
     attention layer), its H/2 SSM heads (Zamba2) or MLA heads
     (DeepSeek-V3) and its vocab block of the logits, which, gathered,
     must be one card's within ``SERVE_LOGIT_RTOL`` of the dtype.  An
     arch served in bf16 and then in f32 prints one card's bf16 logits
     against its f32 ones (the bf16 drift the sharded check sits in);
     a MoE arch prints the share of its expert slots one card drops,
     and is served again with a capacity factor at which none drop.

Each run prints one JSON line from rank 0 (median step ms over the steps
after the first, tokens/s, the peak allocated GiB of each rank, held and
placed bytes, the collective bytes a step by mesh axis; the serving run
its prefill and decode ms beside one card's); every run runs, and if a
check failed the tool exits non-zero after the last.  ``--archs`` keeps
only the runs of the archs it names.  Needs ``--cards``
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
  python3 tools/fsdp_train.py --cards 4 \
      --archs mamba2_780m,zamba2_2_7b,deepseek_v3_671b
  python3 tools/fsdp_train.py --cards 1 --archs mamba2_780m
  python3 tools/fsdp_train.py --device cpu --cards 4
  python3 tools/fsdp_train.py --trace --cards 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (arch, mesh, steps, dtype): the one-card baseline is mesh None; dtype
# None is the config's
RUNS = (("qwen3_0_6b", None, 5, None), ("qwen3_0_6b", "cards", 5, None),
        ("qwen3_0_6b", "half", 5, None), ("olmoe_1b_7b", "cards", 4, None),
        ("mamba2_780m", None, 5, None), ("mamba2_780m", "cards", 5, None),
        ("mamba2_780m", "half", 5, None),
        ("mamba2_780m", None, 5, "float32"),
        ("mamba2_780m", "cards", 5, "float32"),
        ("mamba2_780m", "half", 5, "float32"))
SEQ, GLOBAL_BATCH = 1024, 8
SMOKE_SEQ, SMOKE_BATCH = 32, 4
# sharded against one card, a loss a step, by the run's dtype: the
# losses are means over 8192 tokens of the same model, whose sums run in
# another order (the batch split over ranks, the gradients'
# reduce-scatter), far below a bf16 spacing of 2**-8 relative; in f32
# (the CPU rehearsal's configs too) the twins' 1e-4
# (tests/test_torch_fsdp.py)
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-4}
# the first gradient against one card's, normwise a leaf, in f32: the
# gloo twins' limit (tests/test_torch_tensor_parallel_mixers.py)
GRAD_RTOL = 1e-4
# the row blocks of the one-card baseline's data-split control
SPLIT_BLOCKS = 4
# the serving runs: a prompt of SERVE_PROMPT tokens for each of
# SERVE_BATCH sequences, then DECODE_STEPS decodes of fixed tokens, for
# each (arch, config fields cut on the cards).  DeepSeek-V3 runs again
# at a capacity factor of 4 (each expert takes 4x its mean share of the
# slots), and Zamba2 in f32 beside its bf16: the controls of the bf16
# sharded checks, to tell dropped slots and bf16 drift from a fault
SERVE_BATCH, SERVE_PROMPT, DECODE_STEPS = 8, 1024, 16
SERVE_RUNS = (("qwen3_0_6b", {}), ("zamba2_2_7b", {}),
              ("deepseek_v3_671b", {"n_layers": 4}),
              ("deepseek_v3_671b", {"n_layers": 4, "capacity_factor": 4.0}),
              ("zamba2_2_7b", {"dtype": "float32"}))
SMOKE_SERVE_PROMPT = 16
# sharded logits against one card's, max abs difference over max abs
# logit, by dtype: in bf16 the row-parallel sums round each rank's
# partial to bf16 before the all-reduce, once a projection a layer
# (chip_smoke.py's SERVE_LOGIT_TOL for bf16 logits); in f32 the twins'
# 1e-4 (tests/test_torch_tensor_parallel.py)
SERVE_LOGIT_RTOL = {"bfloat16": 5e-2, "float32": 1e-4}


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


def one_run(arch, mesh_kind, steps, dtype, rank, world, device, smoke,
            compare=False, base=None):
    """This rank's part of one run: (the numbers rank 0 prints, the
    first gradient by leaf on the host where this is a baseline that
    ``compare`` says a later run compares with).  ``base``: rank 0's
    baseline gradients, against which a mesh run's first gradient,
    gathered, is held leaf by leaf."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import _batch_rows
    from repro_torch.models.sharding import NO_MESH, gather, rules_for_mesh
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.optim import adamw
    from repro_torch.tree import keystr, tree_flatten

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config(arch)
    cfg = cfg.reduced() if smoke else cfg
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
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
        return None, None
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
    first = None
    if compare:
        paths, leaves = tree_flatten(grads)
        if mesh_kind is None:
            first = {keystr(p): g.cpu() for p, g in zip(paths, leaves)}
            # the control: the mean of the gradients of the batch's
            # SPLIT_BLOCKS row blocks (a (4, 1) rank's rows), on this card
            # with no collective: how far a data split's reordering alone
            # moves each leaf
            whole, split = batch(0), [torch.zeros_like(g, dtype=torch.float32)
                                      for g in leaves]
            for blk in range(SPLIT_BLOCKS):
                part = {k: v.chunk(SPLIT_BLOCKS)[blk]
                        for k, v in whole.items()}
                for s, g in zip(split, tree_flatten(
                        grad_step(params, part)[0])[1]):
                    s.add_(g.float(), alpha=1 / SPLIT_BLOCKS)
            row["first_grad_split_rel_err_by_leaf"] = {
                keystr(p): float((s - g.float()).norm()
                                 / g.float().norm().clamp(min=1e-30))
                for p, s, g in zip(paths, split, leaves)}
            del split
        else:
            errs = {}
            for p, g, pl in zip(paths, leaves,
                                tree_flatten(model.placements())[1]):
                g = gather(g, pl).float()
                if base is not None:
                    want = base[keystr(p)].to(device).float()
                    errs[keystr(p)] = float((g - want).norm()
                                            / want.norm().clamp(min=1e-30))
            row["first_grad_rel_err_by_leaf"] = errs
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
    return row, first


def attention_layers(cfg) -> int:
    """The layers of a prefill that launch K5: self-attention over the
    q heads (MLA and the SSM mixer take none)."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def serve_run(arch, cut, rank, world, device, smoke):
    """Rank 0 alone, then (world / 2, 2): ``arch``'s prefill and
    DECODE_STEPS decodes from the seed's weights under ``serving_rules``
    (its config's fields ``cut``; on the CPU the reduced config's, its
    depth kept); the logits of each step gathered over vocab and batch.
    Returns (one card's row, one card's logits, the mesh's row, with its
    logits' difference from one card's) on rank 0, (None, None, the
    mesh's row) elsewhere."""
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
    cfg = get_config(arch)
    if smoke:
        cut = {k: v for k, v in cut.items() if k != "n_layers"}
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, **cut)
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
        n = head_split(cfg, srules)[0] if cfg.n_heads else 1
        row = {"arch": cfg.name, "run": "serve",
               "mesh": [1, 1] if srules.mesh is None else [world // 2, 2],
               "dtype": cfg.dtype, "layers": cfg.n_layers,
               "batch": SERVE_BATCH,
               "prompt_len": prompt_len, "decode_steps": DECODE_STEPS,
               "q_heads_per_rank": cfg.n_heads // n,
               "ssm_heads_per_rank": (
                   cfg.ssm_heads // srules.model_ways(cfg.ssm_heads)
                   if cfg.family in ("ssm", "hybrid") else None),
               "prefill_ms": prefill_s * 1e3,
               "decode_ms": [t * 1e3 for t in times],
               "median_decode_ms": statistics.median(times) * 1e3,
               "k5_launches_per_rank": launches,
               "prefill_collective_bytes_by_axis": coll,
               "logits_shape_per_rank": logits_shape,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if on_card else 0.0)}
        if cfg.family == "moe" and srules.mesh is None:
            # the prompt's expert slots dropped at capacity (exact on
            # one card), summed over the MoE layers
            with torch.no_grad():
                _, aux = model.train_logits(params, tokens=tokens,
                                            return_hidden=True)
            row["capacity_factor"] = cfg.capacity_factor
            row["moe_drop_frac_summed"] = float(aux["moe_drop_frac"])
        del params, cache
        return row, got

    base = one(NO_MESH) if rank == 0 else None
    dist.barrier()
    row, got = one(mesh_rules)
    if on_card:
        layers = attention_layers(cfg)
        want = ({kfa.flash_path(getattr(torch, cfg.dtype)):
                 {cfg.dtype: layers}} if layers else {})
        if row["k5_launches_per_rank"] != want:
            raise SystemExit(f"sharded prefill: K5 launches "
                             f"{row['k5_launches_per_rank']}, want {want}")
    if base is None:
        return None, None, row
    row["logits_rel_diff_vs_one_card"] = rel_diffs(got, base[1])
    return base[0], base[1], row


def rel_diffs(got, want) -> list:
    """Each step's max abs difference over the max abs of ``want``."""
    import numpy as np
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


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
        for arch, mesh_kind, _, dtype in RUNS:
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
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
              smoke: bool, archs=None) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group

    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    # one card runs the baselines alone
    runs = [r for r in RUNS if (archs is None or r[0] in archs)
            and (world > 1 or r[1] is None)]
    serve_runs = [r for r in SERVE_RUNS if (archs is None or r[0] in archs)
                  and world > 1]
    # rank 0's failed checks: every run still runs (the ranks' collectives
    # stay in step), and the tool exits non-zero after the last
    rows, one_card, first_grads, failed = [], {}, {}, []
    try:
        for arch, mesh_kind, steps, dtype in runs:
            key = (arch, dtype)
            compare = any(r[0] == arch and r[1] is None and r[3] == dtype
                          for r in runs)
            row, first = one_run(arch, mesh_kind, steps, dtype, rank, world,
                                 device, smoke, compare=compare,
                                 base=first_grads.get(key))
            if first is not None:
                first_grads[key] = first
            dist.barrier()
            if device == "cuda":
                torch.cuda.empty_cache()
            if rank != 0:
                continue
            base = one_card.get(key) if mesh_kind is not None else None
            if mesh_kind is None:
                one_card[key] = row
            if base is not None:
                rel = [abs(a - b) / abs(b)
                       for a, b in zip(row["losses"], base["losses"])]
                rtol = LOSS_RTOL[row["dtype"]]
                row["loss_rel_diff_vs_one_card"] = rel
                row["loss_rtol"] = rtol
                if max(rel) > rtol:
                    failed.append(f"{row['arch']} {row['mesh']} "
                                  f"{row['dtype']}: losses {row['losses']} "
                                  f"vs one card {base['losses']} (rel "
                                  f"{max(rel):.2e}, limit {rtol})")
                if device == "cuda" and not max(
                        row["peak_gib_by_rank"]) < base["peak_gib_by_rank"][0]:
                    failed.append(f"{row['arch']} {row['mesh']}: peak "
                                  f"{row['peak_gib_by_rank']} GiB, one "
                                  f"card {base['peak_gib_by_rank']}")
                off = {k: v for k, v in
                       row["first_grad_rel_err_by_leaf"].items()
                       if v > GRAD_RTOL}
                if row["dtype"] == "float32" and off:
                    failed.append(f"{row['arch']} {row['mesh']} float32: "
                                  f"first gradient off one card's: {off}")
            rows.append(row)
            print(json.dumps({"fsdp_train": row}), flush=True)
        one_card_logits = {}
        for arch, cut in serve_runs:
            base, logits, served = serve_run(arch, cut, rank, world, device,
                                             smoke)
            dist.barrier()
            if device == "cuda":
                torch.cuda.empty_cache()
            if rank != 0:
                continue
            # one card's logits against an earlier dtype's of the arch
            for dtype, other in one_card_logits.get(arch, {}).items():
                if dtype != base["dtype"]:
                    base.setdefault("one_card_logits_rel_diff", {})[dtype] = \
                        rel_diffs(other, logits)
            one_card_logits.setdefault(arch, {})[base["dtype"]] = logits
            rtol = SERVE_LOGIT_RTOL[served["dtype"]]
            served["logits_rtol"] = rtol
            print(json.dumps({"fsdp_serve": base}), flush=True)
            print(json.dumps({"fsdp_serve": served}), flush=True)
            rows += [base, served]
            if not max(served["logits_rel_diff_vs_one_card"]) <= rtol:
                failed.append(f"sharded serving {served['arch']}: logits "
                              f"{served['logits_rel_diff_vs_one_card']} off "
                              f"one card's (limit {rtol})")
        if rank == 0 and os.environ.get("FSDP_TRAIN_OUT"):
            with open(os.environ["FSDP_TRAIN_OUT"], "w") as f:
                json.dump(rows, f, indent=1)
        if failed:
            raise SystemExit("fsdp_train: " + "; ".join(failed))
    except BaseException:
        # a rank that fails exits at once, so that the launcher stops
        # the others: they wait in a collective, and tearing the group
        # down here could wait with them until NCCL's timeout
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="write the runs' JSON rows here")
    ap.add_argument("--archs", default=None,
                    help="comma-separated archs whose runs to run "
                    "(default: every run)")
    ap.add_argument("--trace", action="store_true",
                    help="predict each run's peak on fake tensors (no card)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    smoke = args.device == "cpu"
    if args.cards % 2 and args.cards != 1:
        print("fsdp_train: needs one card or an even number",
              file=sys.stderr)
        return 1
    if args.trace:
        trace(args.cards)
        return 0
    if args.rank is not None:
        rank_main(args.rank, args.cards, args.store, args.device, smoke,
                  args.archs and args.archs.split(","))
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
             "--device", args.device, "--rank", str(r), "--store", store]
            + (["--archs", args.archs] if args.archs else []),
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
