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
  4. Mamba2-780M at full width on one card in f64 (the yardstick), then
     on one card, on (cards, 1) and on (cards / 2, 2), where a rank
     computes its H/2 SSM heads, in bf16 and in f32: losses within
     LOSS_RTOL of one card's in the same dtype.  Every run with a
     one-card baseline also holds its first gradient, gathered, against
     the baseline's leaf by leaf (normwise; in f32 within GRAD_RTOL),
     which tells a sharding fault from AdamW's amplification of
     rounding; the baseline prints, as a control, its own gradient
     against the mean of its SPLIT_BLOCKS row blocks' (a data split with
     no collective), and both against the f64 baseline's first gradient,
     and its losses against the f64 ones.  Where the f64 yardstick ran,
     an f32 mesh run's limits are drawn from it.  Two bf16 controls run
     on one card before the meshes, each the mesh's own arithmetic with
     no collective: "split" trains on the mean of its batch's
     SPLIT_BLOCKS row blocks' gradients, summed in bf16 as the (cards,
     1) mesh's reduce-scatter sums them; "rounded" computes each mixer's
     ``out_proj`` as the ROW_PARTS row-block partials of a 2-way model
     axis, each rounded to bf16 before their sum, as the (cards / 2, 2)
     mesh's row-parallel all-reduce does; a bf16 mesh run's loss limit
     is drawn from its control (:func:`limits`).
     ``--cards 1`` runs the one-card baselines and controls, then the depth
     sweep: the f64, f32 and f32 row-block-mean gradients of one batch
     at each of SWEEP_DEPTHS;
  5. a sharded prefill and DECODE_STEPS decodes on (cards / 2, 2) under
     ``serving_rules`` of each of SERVE_RUNS at full width (DeepSeek-V3
     cut to 4 layers): each rank computes its H/2 q heads (Qwen3's and
     Zamba2's shared block's on the flash kernel K5, a launch an
     attention layer), its H/2 SSM heads (Zamba2) or MLA heads
     (DeepSeek-V3) and its vocab block of the logits, which, gathered,
     must be one card's within ``SERVE_LOGIT_RTOL`` of the dtype (or the
     limit :func:`serve_limits` draws from one card's own runs in a
     wider dtype).  Zamba2 runs on one card alone in f64 (plain
     attention: K5 takes no f64), then in f32 and bf16 on both.  A MoE
     run counts the expert slots each step drops (``moe.count_drops``:
     on one card, and on the mesh summed over its ranks) and holds a
     sharded step against one card's only where neither has dropped a
     slot, nor the mesh routed a token to other experts, in it or before
     it (the cache carries every earlier step: :func:`held_steps`);
     DeepSeek-V3 runs again at PROMPT_CAPACITY_FACTOR for the prefill
     and DECODE_CAPACITY_FACTOR for the decodes, where none drops.  A
     MoE run's decodes also print, layer by layer, the attention's and
     the MLP's or experts' output on the mesh against one card's, and
     the tokens whose top-k experts differ (:func:`recorded_layers`);
     its one-card run prints the same against its own decodes of the
     batch in a (2, 2) mesh's data-rank blocks (a control with no
     collective).  ``--cards 1`` serves each run on one card alone.

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
  python3 tools/fsdp_train.py --cards 1 --archs mamba2_780m   # + depth sweep
  python3 tools/fsdp_train.py --cards 1 --archs deepseek_v3_671b
  python3 tools/fsdp_train.py --device cpu --cards 4
  python3 tools/fsdp_train.py --trace --cards 4
"""
from __future__ import annotations

import argparse
import contextlib
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
from typing import Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (arch, mesh, steps, dtype): the one-card baseline is mesh None; dtype
# None is the config's
RUNS = (("qwen3_0_6b", None, 5, None), ("qwen3_0_6b", "cards", 5, None),
        ("qwen3_0_6b", "half", 5, None), ("olmoe_1b_7b", "cards", 4, None),
        ("mamba2_780m", None, 5, "float64"),
        ("mamba2_780m", None, 5, None), ("mamba2_780m", "split", 5, None),
        ("mamba2_780m", "rounded", 5, None),
        ("mamba2_780m", "cards", 5, None), ("mamba2_780m", "half", 5, None),
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
# (tests/test_torch_fsdp.py).  Where the mesh's one-card control ran in
# the same call (CONTROL_OF), a bf16 run is held instead to twice the
# control's own largest loss distance from one card's: 48 bf16 layers
# of Mamba2 carry a rounding that the mesh's sums in another order move
# by more than 1e-3 (its (4, 1) and (2, 2) runs read 1.59e-3 and
# 2.00e-3 on H100s), and the control shows how far that arithmetic
# alone moves them
LOSS_RTOL = {"bfloat16": 1e-3, "float32": 1e-4}
# the first gradient against one card's, normwise a leaf, in f32: the
# gloo twins' limit (tests/test_torch_tensor_parallel_mixers.py); where
# the arch's f64 baseline ran in the same call, an f32 mesh run is held
# instead to twice one card's own f32 distance from f64, leaf by leaf,
# and its losses to twice one card's f32 losses' distance from the f64
# ones (limits): a mesh whose f32 result is as close to the exact
# one as one card's is within twice that of one card's
GRAD_RTOL = 1e-4
# the row blocks of the one-card baseline's data-split control (a (4, 1)
# mesh's data ranks), and the row-block partials of the "rounded"
# control's out_proj (a 2-way model axis's)
SPLIT_BLOCKS, ROW_PARTS = 4, 2
# the one-card control of each mesh kind, in bf16
CONTROL_OF = {"cards": "split", "half": "rounded"}
# --cards 1: the depths at which the depth sweep takes one batch's f64,
# f32 and f32 row-block-mean gradients (Mamba2's published depth last)
SWEEP_ARCH, SWEEP_DEPTHS, SMOKE_SWEEP_DEPTHS = ("mamba2_780m",
                                                (6, 12, 24, 48), (1, 2))
# the serving runs: a prompt of SERVE_PROMPT tokens for each of
# SERVE_BATCH sequences, then DECODE_STEPS decodes of fixed tokens, for
# each (arch, config fields cut on the cards; "decode_capacity_factor"
# sets the decodes' alone, "mesh": False serves on one card alone).
# Zamba2 runs in f64 on one card (the yardstick of its f32 runs) and in
# f32 beside its bf16 (the yardstick of its bf16 runs); DeepSeek-V3 runs
# again where no slot drops: at PROMPT_CAPACITY_FACTOR for the prompt
# (each expert takes 5x its mean share of the slots: at 4 a data rank of
# (2, 2) still dropped 19 of its 32768, and at 8 one card's prefill
# buffers overflow 80 GB, on an H100) and
# DECODE_CAPACITY_FACTOR for the decodes (a decode of SERVE_BATCH tokens
# has a capacity of 8 slots an expert on one card and 4 on a data rank
# of (2, 2), so every expert takes every token)
SERVE_BATCH, SERVE_PROMPT, DECODE_STEPS = 8, 1024, 16
PROMPT_CAPACITY_FACTOR, DECODE_CAPACITY_FACTOR = 5.0, 32.0
# a MoE run's one-card control decodes the batch in the row blocks of a
# (2, 2) mesh's data ranks
SERVE_DATA_BLOCKS = 2
SERVE_RUNS = (("qwen3_0_6b", {}),
              ("zamba2_2_7b", {"dtype": "float64", "mesh": False}),
              ("zamba2_2_7b", {"dtype": "float32"}), ("zamba2_2_7b", {}),
              ("deepseek_v3_671b", {"n_layers": 4}),
              ("deepseek_v3_671b", {
                  "n_layers": 4, "capacity_factor": PROMPT_CAPACITY_FACTOR,
                  "decode_capacity_factor": DECODE_CAPACITY_FACTOR}))
SMOKE_SERVE_PROMPT = 16
# sharded logits against one card's, max abs difference over max abs
# logit, by dtype: in bf16 the row-parallel sums round each rank's
# partial to bf16 before the all-reduce, once a projection a layer
# (chip_smoke.py's SERVE_LOGIT_TOL for bf16 logits); in f32 the twins'
# 1e-4 (tests/test_torch_tensor_parallel.py).  Where one card served the
# arch in a wider dtype in the same call, serve_limits draws the limit
# from it instead
SERVE_LOGIT_RTOL = {"bfloat16": 5e-2, "float32": 1e-4}
# the bf16 limit drawn from one card's bf16-vs-f32 drift: twice it plus
# this floor, as tests/test_torch_models.py's family logit twin draws
# its bf16 limit from the reference's drift
DRIFT_FLOOR = 1e-3


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


def rel_err(got, want) -> float:
    """Normwise ``|got - want| / |want|``, in f64."""
    got, want = got.double(), want.to(got.device).double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def split_mean(grad_step, params, batch, leaves):
    """The mean of the gradients of ``batch``'s SPLIT_BLOCKS row blocks
    (a (4, 1) rank's rows), on this card with no collective, summed in
    the wider of f32 and the gradients' dtype."""
    import torch
    from repro_torch.tree import tree_flatten
    out = [torch.zeros_like(g, dtype=torch.promote_types(torch.float32,
                                                         g.dtype))
           for g in leaves]
    for blk in range(SPLIT_BLOCKS):
        part = {k: v.chunk(SPLIT_BLOCKS)[blk] for k, v in batch.items()}
        for s, g in zip(out, tree_flatten(grad_step(params, part)[0])[1]):
            s.add_(g.to(s.dtype), alpha=1 / SPLIT_BLOCKS)
    return out


def split_grad_step(grad_step):
    """``grad_step`` over the SPLIT_BLOCKS row blocks of the batch, on
    this card with no collective: the mean of their gradients, summed
    in the gradients' dtype (bf16 in a bf16 model, as a (SPLIT_BLOCKS,
    1) mesh's reduce-scatter sums them), and of their losses."""
    import torch
    from repro_torch.tree import tree_map

    def step(params, batch, global_batch=None):
        total = losses = None
        for blk in range(SPLIT_BLOCKS):
            part = {k: v.chunk(SPLIT_BLOCKS)[blk] for k, v in batch.items()}
            grads, loss, _ = grad_step(params, part)
            total = grads if total is None else tree_map(torch.add, total,
                                                         grads)
            losses = loss if losses is None else losses + loss
        return (tree_map(lambda g: g / SPLIT_BLOCKS, total),
                losses / SPLIT_BLOCKS, {})
    return step


@contextlib.contextmanager
def rounded_partials(rounded: bool = True):
    """Within it, a Mamba2 mixer whose heads are all on this rank
    computes ``out_proj`` as the ROW_PARTS row-block partials of a
    model axis of ROW_PARTS ranks: each the product of its rows with an
    f32 accumulator, rounded to the activations' dtype, then summed in
    it, as ``layers.row_parallel_matmul`` and the all-reduce after it
    do (``rounded=False``: the plain product)."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import wide
    plain = ssm._out_proj

    def partials(y, w, rules, n, features):
        if n > 1 or not rounded:
            return plain(y, w, rules, n, features)
        parts = [(wide(yb) @ wide(wb)).to(y.dtype) for yb, wb in
                 zip(y.chunk(ROW_PARTS, -1), w.chunk(ROW_PARTS, 0))]
        return sum(parts[1:], parts[0])

    ssm._out_proj = partials
    try:
        yield
    finally:
        ssm._out_proj = plain


def one_run(arch, mesh_kind, steps, dtype, rank, world, device, smoke,
            compare=False, base=None, yard=None):
    """This rank's part of one run: (the numbers rank 0 prints, the
    first gradient by leaf on the host where this is a baseline that
    ``compare`` says a later run compares with).  ``mesh_kind``: None
    (one card), "cards", "half" (the meshes) or a one-card control
    ("split", "rounded": CONTROL_OF).  ``base``: rank 0's baseline
    gradients, against which a mesh run's or a control's first
    gradient, gathered, is held leaf by leaf; ``yard``: the f64
    baseline's first gradient, against which a baseline's and its
    data-split mean's are held leaf by leaf."""
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
    alone = mesh_kind is None or mesh_kind in CONTROL_OF.values()
    if alone:
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
    if mesh_kind in CONTROL_OF.values():
        row["control"] = mesh_kind
    if alone and rank != 0:
        return None, None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    grad_step, model = S.make_grad_step(cfg, rules)
    opt_cfg = adamw.AdamWConfig(total_steps=steps, warmup_steps=1)
    step, _ = S.make_train_step(cfg, rules, opt_cfg)
    if mesh_kind == "split":
        grad_step = split_grad_step(grad_step)

        def step(params, state, batch, global_batch=None):
            grads, loss, _ = grad_step(params, batch)
            params, state, m = adamw.apply_updates(opt_cfg, params, grads,
                                                   state)
            return params, state, {"loss": loss, **m}
    elif mesh_kind == "rounded":
        grad_step, step = (_under(rounded_partials, f)
                           for f in (grad_step, step))
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
            # the control: how far a data split's reordering alone moves
            # each leaf
            split = split_mean(grad_step, params, batch(0), leaves)
            row["first_grad_split_rel_err_by_leaf"] = {
                keystr(p): rel_err(s, g)
                for p, s, g in zip(paths, split, leaves)}
            if yard is not None:
                # the baseline's gradient and the control's against the
                # exact one (the f64 baseline's)
                row["first_grad_f64_rel_err_by_leaf"] = {
                    keystr(p): rel_err(g, yard[keystr(p)])
                    for p, g in zip(paths, leaves)}
                row["first_grad_split_f64_rel_err_by_leaf"] = {
                    keystr(p): rel_err(s, yard[keystr(p)])
                    for p, s in zip(paths, split)}
            del split
        else:
            errs = {}
            for p, g, pl in zip(paths, leaves,
                                tree_flatten(model.placements())[1]):
                g = gather(g, pl)
                if base is not None:
                    errs[keystr(p)] = rel_err(g, base[keystr(p)])
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
    if not alone:
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


def _under(context, fn):
    """``fn``, each call made within ``context()``."""
    def run(*args, **kw):
        with context():
            return fn(*args, **kw)
    return run


def rel_losses(row, want) -> list:
    """Each step's loss against ``want``'s, relative."""
    return [abs(a - b) / abs(b) for a, b in zip(row["losses"],
                                                 want["losses"])]


def limits(dtype, base, control=None):
    """(loss limit, {leaf: first-gradient limit}, the limit's origin) of
    a mesh run in ``dtype`` against one card's run ``base``: LOSS_RTOL
    and GRAD_RTOL, but drawn from a run of the same call where there is
    one: in f32 where ``base`` was held against the f64 baseline, twice
    ``base``'s own distance from it (its largest loss difference; its
    first gradient's, leaf by leaf); in bf16 where the mesh's one-card
    ``control`` ran, twice the control's largest loss distance from
    ``base`` (its first gradient's distance is printed, not held: in 48
    bf16 layers one card's lies ~1 from f64 a stacked leaf)."""
    exact = base.get("first_grad_f64_rel_err_by_leaf")
    if dtype == "float32" and exact:
        return (2 * max(base["loss_rel_diff_vs_f64"]),
                {k: 2 * v for k, v in exact.items()},
                "2 x one card's f32 vs f64")
    if dtype == "bfloat16" and control is not None:
        return (2 * max(control["loss_rel_diff_vs_one_card"]), {},
                f"2 x the {control['control']} control's")
    return LOSS_RTOL[dtype], {}, "LOSS_RTOL"


def depth_sweep(arch, device, smoke) -> list:
    """``--cards 1``: at each of SWEEP_DEPTHS (the arch's config at that
    depth; SMOKE_SWEEP_DEPTHS of the reduced one on the CPU), one batch's
    first gradient in f64, in f32, and in f32 as the mean of its
    SPLIT_BLOCKS row blocks' (:func:`split_mean`), from one seed's
    weights (the f32 model's are the f64 model's, rounded): a row a depth
    with each f32 gradient's distance from the f64 one, leaf by leaf, and
    the two f32 losses beside the f64 one.  A distance that grows with
    depth alike for both f32 gradients is the model's f32 conditioning;
    one that only the split shows is a mixing of rows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import steps as S
    from repro_torch.models.sharding import NO_MESH
    from repro_torch.tree import keystr, tree_flatten

    cfg = get_config(arch)
    cfg = cfg.reduced() if smoke else cfg
    seq, gb = (SMOKE_SEQ, SMOKE_BATCH) if smoke else (SEQ, GLOBAL_BATCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=gb, seed=0)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in batch_at_step(dc, 0).items()
             if k in ("tokens", "labels")}
    rows = []
    for depth in (SMOKE_SWEEP_DEPTHS if smoke else SWEEP_DEPTHS):
        row = {"arch": cfg.name, "layers": depth, "seq_len": seq,
               "global_batch": gb}
        got = {}
        for dtype in ("float64", "float32"):
            c = dataclasses.replace(cfg, n_layers=depth, dtype=dtype)
            grad_step, model = S.make_grad_step(c, NO_MESH)
            params = model.init(0, device=device)
            grads, loss, _ = grad_step(params, batch)
            paths, leaves = tree_flatten(grads)
            row[f"loss_{dtype}"] = float(loss)
            if dtype == "float64":
                exact = leaves
            else:
                split = split_mean(grad_step, params, batch, leaves)
                got = {"f64_rel_err_by_leaf": leaves,
                       "split_f64_rel_err_by_leaf": split}
            del params, grads
        for name, tree in got.items():
            row[name] = {keystr(p): rel_err(g, e)
                         for p, g, e in zip(paths, tree, exact)}
        row["split_rel_err_by_leaf"] = {
            keystr(p): rel_err(s, g) for p, s, g in
            zip(paths, got["split_f64_rel_err_by_leaf"],
                got["f64_rel_err_by_leaf"])}
        del exact, got, leaves, split
        if device == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
    return rows


def attention_layers(cfg) -> int:
    """The layers of a prefill that launch K5: self-attention over the
    q heads (MLA and the SSM mixer take none)."""
    if cfg.use_mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def serve_run(arch, cut, rank, world, device, smoke):
    """Rank 0 alone, then (world / 2, 2) unless ``cut`` says ``"mesh":
    False``: ``arch``'s prefill and DECODE_STEPS decodes from the seed's
    weights under ``serving_rules`` (its config's fields ``cut``; on the
    CPU the reduced config's, its depth kept; f64 on plain attention);
    the logits of each step gathered over vocab and batch, and for a MoE
    the slots each step dropped (on the mesh summed over its ranks), its
    decodes' layers, and on one card its data-split control.
    Returns (one card's row and logits, the mesh's row and logits) on
    rank 0, (None, None, the mesh's row, None) elsewhere; the mesh's
    are None where it does not run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.launch.train import _batch_rows
    from repro_torch.models import attention, moe
    from repro_torch.models.attention import head_split
    from repro_torch.models.sharding import (NO_MESH, placement_of,
                                             rules_for_mesh)
    from repro_torch.tree import tree_map

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cut = dict(cut)
    on_mesh = cut.pop("mesh", True)
    decode_factor = cut.pop("decode_capacity_factor", None)
    cfg = get_config(arch)
    if smoke:
        cut = {k: v for k, v in cut.items() if k != "n_layers"}
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, **cut)
    decode_cfg = (cfg if decode_factor is None else
                  dataclasses.replace(cfg, capacity_factor=decode_factor))
    prompt_len = SMOKE_SERVE_PROMPT if smoke else SERVE_PROMPT
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, prompt_len))
    toks = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, SERVE_BATCH))
    on_mesh = on_mesh and world > 1
    mesh_rules = (rules_for_mesh(make_mesh_for_devices(world, 2,
                                                       device=device))
                  if on_mesh else None)

    def one(rules):
        srules = S.serving_rules(cfg, rules)
        prefill, model = S.make_prefill_step(cfg, srules)
        decode, _ = S.make_decode_step(decode_cfg, srules)
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

        def copied(cache):
            # a copy of a held cache, each leaf with its placement
            def leaf(t):
                c = t.clone()
                c.placement = placement_of(t)
                return c
            return tree_map(leaf, cache)

        def rows_whole(t):
            # a tensor of this rank's batch rows, gathered over "data"
            if srules.mesh is not None:
                t = D.all_gather(t.contiguous(), srules.group("data"), dim=0)
            return t.float().cpu().numpy() if t.is_floating_point() \
                else t.cpu().numpy()

        def split_decodes(start):
            # the control of a MoE run on one card: the same decodes from
            # the same cache, the batch taken in SERVE_DATA_BLOCKS blocks
            # of rows (a (2, 2) mesh's data ranks, each with its own
            # capacity), joined: (each step's logits, its layers)
            blocks = []
            width = SERVE_BATCH // SERVE_DATA_BLOCKS
            for blk in range(SERVE_DATA_BLOCKS):
                sl = slice(blk * width, (blk + 1) * width)
                part = tree_map(lambda t: t[:, sl].clone(), start)
                steps = []
                for i in range(DECODE_STEPS):
                    tok = torch.tensor(toks[i][sl], dtype=torch.int32,
                                       device=device)
                    pos = torch.full((width,), prompt_len + i,
                                     dtype=torch.int32, device=device)
                    with recorded_layers() as seen:
                        lg, part = decode(params, part, tok, pos)
                    steps.append((whole(lg), {k: [rows_whole(t) for t in v]
                                              for k, v in seen.items()}))
                blocks.append(steps)
            logits = [np.concatenate([b[i][0] for b in blocks])
                      for i in range(DECODE_STEPS)]
            joined = [{k: [np.concatenate([b[i][1][k][j] for b in blocks])
                           for j in range(len(v))]
                       for k, v in blocks[0][i][1].items()}
                      for i in range(DECODE_STEPS)]
            return logits, joined

        def dropped(calls):
            # this step's dropped slots, summed over the mesh's ranks
            n = sum(calls, torch.zeros((), dtype=torch.long, device=device))
            if srules.mesh is not None:
                dist.all_reduce(n)
            return int(n)

        with torch.no_grad():
            tokens = torch.tensor(prompt[rows], dtype=torch.int32,
                                  device=device)
            # a first prefill loads the kernels; the one timed is the next
            prefill(params, {"tokens": tokens})
            build.reset()
            D.reset_collectives()
            sync()
            t0 = time.perf_counter()
            with moe.count_drops() as calls:
                logits, cache = prefill(params, {"tokens": tokens})
            sync()
            prefill_s = time.perf_counter() - t0
            launches = {}  # K5's, {path: {dtype: n}}
            for key, n in build.snapshot().items():
                if key.kernel == "flash":
                    by_dtype = launches.setdefault(key.path, {})
                    by_dtype[key.dtype] = by_dtype.get(key.dtype, 0) + n
            coll = {a: dict(c) for a, c in
                    D.COLLECTIVE_BYTES_BY_AXIS.items()}
            drops = [dropped(calls)]
            logits_shape = list(logits.shape)
            cache = model.pad_cache(cache, prompt_len + DECODE_STEPS)
            before = copied(cache) if cfg.family == "moe" else None
            start = (copied(cache) if cfg.family == "moe"
                     and srules.mesh is None else None)
            got, times = [whole(logits[:, -1])], []
            layers = []
            for i in range(DECODE_STEPS):
                tok = torch.tensor(toks[i][rows], dtype=torch.int32,
                                   device=device)
                pos = torch.full((tokens.shape[0],), prompt_len + i,
                                 dtype=torch.int32, device=device)
                sync()
                t0 = time.perf_counter()
                with moe.count_drops() as calls:
                    lg, cache = decode(params, cache, tok, pos)
                sync()
                times.append(time.perf_counter() - t0)
                drops.append(dropped(calls))
                got.append(whole(lg))
                if cfg.family == "moe":
                    # the same step again, its layers recorded, on a copy
                    # of the cache it read (not timed)
                    with recorded_layers() as seen:
                        decode(params, before, tok, pos)
                    layers.append({k: [rows_whole(t) for t in v]
                                   for k, v in seen.items()})
                before = copied(cache) if cfg.family == "moe" else None
            if start is not None:
                split = split_decodes(start)
        n = head_split(cfg, srules)[0] if cfg.n_heads else 1
        row = {"arch": cfg.name, "run": "serve",
               "mesh": [1, 1] if srules.mesh is None else [world // 2, 2],
               "dtype": cfg.dtype, "layers": cfg.n_layers,
               "batch": SERVE_BATCH,
               "prompt_len": prompt_len, "decode_steps": DECODE_STEPS,
               "attention": attention.ATTENTION_BACKEND,
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
        if cfg.family == "moe":
            row.update(capacity_factor=cfg.capacity_factor,
                       decode_capacity_factor=decode_cfg.capacity_factor,
                       moe_layers=cfg.n_layers - cfg.n_dense_layers,
                       dropped_slots=drops)
        if start is not None:
            row["split_decode_logits_rel_diff"] = rel_diffs(split[0],
                                                            got[1:])
            row["split_decode_layers"] = layer_diffs(split[1], layers)
        del params, cache, before, start
        return row, (got, layers)

    base = None
    if rank == 0:
        # K5 takes no f64: an f64 run's attention is the plain one
        backend = attention.ATTENTION_BACKEND
        if cfg.dtype == "float64":
            attention.ATTENTION_BACKEND = "sdpa"
        try:
            base = one(NO_MESH)
        finally:
            attention.ATTENTION_BACKEND = backend
    dist.barrier()
    if not on_mesh:
        return (None, None, None, None) if base is None else (
            base[0], base[1][0], None, None)
    row, got = one(mesh_rules)
    if on_card:
        layers = attention_layers(cfg)
        want = ({kfa.flash_path(getattr(torch, cfg.dtype)):
                 {cfg.dtype: layers}} if layers else {})
        if row["k5_launches_per_rank"] != want:
            raise SystemExit(f"sharded prefill: K5 launches "
                             f"{row['k5_launches_per_rank']}, want {want}")
    if base is None:
        return None, None, row, None
    (got, layers), (want, one_layers) = got, base[1]
    row["logits_rel_diff_vs_one_card"] = rel_diffs(got, want)
    if layers:
        row["decode_layers_vs_one_card"] = layer_diffs(layers, one_layers)
    return base[0], want, row, got


def held_steps(one, sharded) -> list:
    """The steps (0: the prefill) whose sharded logits are held against
    one card's: every step, but for a MoE those before which, and in
    which, neither dropped an expert slot and no decode sent a token to
    other experts than one card's (a step's cache holds every earlier
    step's).  Either is another function of the batch: the
    expert-parallel dispatch takes its capacity from a data rank's
    tokens, as the reference's does, and bf16 sums in another order flip
    near-tied top-k choices (one card's split control shows both).  The
    others are held by the counts printed."""
    steps = range(1 + sharded["decode_steps"])
    if "dropped_slots" not in sharded:
        return list(steps)
    moved = [0] + sharded.get("decode_layers_vs_one_card", {}).get(
        "tokens_rerouted", [0] * sharded["decode_steps"])
    clean = [one["dropped_slots"][i] == 0 == sharded["dropped_slots"][i]
             and moved[i] == 0 for i in steps]
    return [i for i in steps if all(clean[:i + 1])]


@contextlib.contextmanager
def recorded_layers():
    """Within it, the outputs of each layer's attention and of its MLP
    or experts, and each MoE router's top-k experts, in call order:
    {"attention": [...], "ffn": [...], "experts": [...]} (the tool's
    wrappers of the model's own functions, put back on exit)."""
    from repro_torch.models import moe, transformer
    seen = {"attention": [], "ffn": [], "experts": []}
    first = lambda out: out[0]
    hooks = {(transformer, "mla_attention"): ("attention", first),
             (transformer, "gqa_attention"): ("attention", first),
             (transformer, "mlp"): ("ffn", lambda out: out),
             (transformer, "moe_block"): ("ffn", first),
             (moe, "_router"): ("experts", lambda out: out[2])}
    saved = {key: getattr(*key) for key in hooks}

    def wrap(key):
        fn, (kind, pick) = saved[key], hooks[key]

        def run(*args, **kw):
            out = fn(*args, **kw)
            seen[kind].append(pick(out))
            return out
        return run

    for key in hooks:
        setattr(*key, wrap(key))
    try:
        yield seen
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)


def layer_diffs(mesh_steps, one_steps) -> dict:
    """A MoE run's decodes, mesh against one card, from each side's
    :func:`recorded_layers` of each step (whole batches): each layer's
    attention and MLP/experts output, max abs difference over one card's
    max abs, and the tokens whose top-k experts differ."""
    import numpy as np

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    out = {"attention": [], "ffn": [], "tokens_rerouted": []}
    for got, want in zip(mesh_steps, one_steps):
        for kind in ("attention", "ffn"):
            out[kind].append([rel(a, b) for a, b in zip(got[kind],
                                                        want[kind])])
        out["tokens_rerouted"].append(sum(
            int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
            for a, b in zip(got["experts"], want["experts"])))
    return out


def serve_limits(dtype, logits, one_card_logits) -> Tuple[float, str]:
    """(limit, its origin) of a sharded run in ``dtype`` against one card:
    SERVE_LOGIT_RTOL, but where one card also served the arch in a wider
    dtype in the same call (``one_card_logits``: {dtype: its logits}),
    drawn from one card's own distance from that run (``logits``: one
    card's in ``dtype``): in f32, twice its largest distance from f64; in
    bf16, twice its largest drift from f32 plus DRIFT_FLOOR."""
    wider = {"float32": "float64", "bfloat16": "float32"}.get(dtype)
    if wider not in one_card_logits:
        return SERVE_LOGIT_RTOL[dtype], "SERVE_LOGIT_RTOL"
    far = max(rel_diffs(logits, one_card_logits[wider]))
    if dtype == "float32":
        return 2 * far, f"2 x one card's f32 vs f64 ({far:.3e})"
    return (2 * far + DRIFT_FLOOR,
            f"2 x one card's bf16 vs f32 ({far:.3e}) + {DRIFT_FLOOR}")


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
            if mesh_kind in CONTROL_OF.values():
                continue        # one card's step and memory
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

    # f32 matmuls and convolutions in f32, not TF32, as chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    # one card runs the baselines and controls alone
    runs = [r for r in RUNS if (archs is None or r[0] in archs)
            and (world > 1 or r[1] is None
                 or r[1] in CONTROL_OF.values())]
    # one card alone serves each run on it alone (a MoE's with its
    # split control)
    serve_runs = [r for r in SERVE_RUNS if archs is None or r[0] in archs]
    # rank 0's failed checks: every run still runs (the ranks' collectives
    # stay in step), and the tool exits non-zero after the last
    rows, one_card, first_grads, failed = [], {}, {}, []
    controls = {}       # {(arch, dtype, control): its row}
    try:
        for arch, mesh_kind, steps, dtype in runs:
            key = (arch, dtype)
            compare = any(r[0] == arch and r[1] is None and r[3] == dtype
                          for r in runs)
            yard = (first_grads.get((arch, "float64"))
                    if dtype != "float64" and mesh_kind is None else None)
            row, first = one_run(arch, mesh_kind, steps, dtype, rank, world,
                                 device, smoke, compare=compare,
                                 base=first_grads.get(key), yard=yard)
            if first is not None:
                first_grads[key] = first
            dist.barrier()
            if device == "cuda":
                torch.cuda.empty_cache()
            if rank != 0:
                continue
            base = one_card.get(key) if mesh_kind is not None else None
            if mesh_kind in CONTROL_OF.values():
                controls[key + (mesh_kind,)] = row
                if base is not None:
                    row["loss_rel_diff_vs_one_card"] = rel_losses(row, base)
                base = None     # a measurement, held to no limit
            if mesh_kind is None:
                one_card[key] = row
                exact = one_card.get((arch, "float64"))
                if exact is not None and exact is not row:
                    row["loss_rel_diff_vs_f64"] = rel_losses(row, exact)
            if base is not None:
                rel = rel_losses(row, base)
                control = controls.get(key + (CONTROL_OF[mesh_kind],))
                rtol, grad_rtol, origin = limits(row["dtype"], base, control)
                row["loss_rel_diff_vs_one_card"] = rel
                row.update(loss_rtol=rtol, loss_rtol_from=origin)
                if control is not None:
                    row["control_first_grad_rel_err_by_leaf"] = control[
                        "first_grad_rel_err_by_leaf"]
                if max(rel) > rtol:
                    failed.append(f"{row['arch']} {row['mesh']} "
                                  f"{row['dtype']}: losses {row['losses']} "
                                  f"vs one card {base['losses']} (rel "
                                  f"{max(rel):.2e}, limit {rtol}: "
                                  f"{origin})")
                if device == "cuda" and not max(
                        row["peak_gib_by_rank"]) < base["peak_gib_by_rank"][0]:
                    failed.append(f"{row['arch']} {row['mesh']}: peak "
                                  f"{row['peak_gib_by_rank']} GiB, one "
                                  f"card {base['peak_gib_by_rank']}")
                row["first_grad_rtol_by_leaf"] = grad_rtol
                off = {k: v for k, v in
                       row["first_grad_rel_err_by_leaf"].items()
                       if v > grad_rtol.get(k, GRAD_RTOL)}
                if row["dtype"] == "float32" and off:
                    failed.append(f"{row['arch']} {row['mesh']} float32: "
                                  f"first gradient off one card's: {off}")
            rows.append(row)
            print(json.dumps({"fsdp_train": row}), flush=True)
        if world == 1 and (archs is None or SWEEP_ARCH in archs):
            for row in depth_sweep(SWEEP_ARCH, device, smoke):
                rows.append(row)
                print(json.dumps({"fsdp_depth": row}), flush=True)
        # {arch: {dtype: one card's logits}}: the wider runs' logits that
        # a narrower run's limit and distances are drawn from
        one_card_logits = {}
        for arch, cut in serve_runs:
            base, logits, served, got = serve_run(arch, cut, rank, world,
                                                  device, smoke)
            dist.barrier()
            if device == "cuda":
                torch.cuda.empty_cache()
            if rank != 0:
                continue
            wider = one_card_logits.setdefault(arch, {})
            # one card's logits against each wider dtype's of the arch,
            # and the mesh's against them
            for row, mine in ((base, logits), (served, got)):
                if row is not None:
                    row["logits_rel_diff_vs_one_card_in"] = {
                        dtype: rel_diffs(mine, other)
                        for dtype, other in wider.items()
                        if dtype != row["dtype"]}
            print(json.dumps({"fsdp_serve": base}), flush=True)
            rows.append(base)
            if served is not None:
                rtol, origin = serve_limits(served["dtype"], logits, wider)
                held = held_steps(base, served)
                served.update(logits_rtol=rtol, logits_rtol_from=origin,
                              logits_held_steps=held)
                print(json.dumps({"fsdp_serve": served}), flush=True)
                rows.append(served)
                off = [served["logits_rel_diff_vs_one_card"][i] for i in held]
                if off and not max(off) <= rtol:
                    failed.append(f"sharded serving {served['arch']}: "
                                  f"logits {off} off one card's at steps "
                                  f"{held} (limit {rtol}: {origin})")
            wider[base["dtype"]] = logits
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
