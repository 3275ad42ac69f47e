"""Multi-pod dry-run: every (architecture x input shape) cell's step on
fake tensors over a fake 256- or 512-rank process group.

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell's step against ``ShapeDtypeStruct`` inputs on
placeholder devices.  The port runs the step once, eagerly, as rank 0
of the mesh, on fake tensors (``FakeTensorMode``) over a process group
of the ``fake`` backend, whose collectives move nothing:

  * the single-pod (16, 16) mesh (256 ranks, axes data x model), and
  * the 2-pod (2, 16, 16) mesh (512 ranks, axes pod x data x model).

Nothing is allocated and no card is needed.  Rank 0 computes what a
rank of the mesh computes: its slice of the batch along the batch axes,
and within it its model block of each layer (its q heads, ff width,
experts and vocab; k/v whole where the model axis does not divide the
kv heads, and the SSM mixer and MLA's up-projections whole), its leaves
gathered over the batch/FSDP axes only.  What it reports for the step,
rank 0's per-device program as the reference's HLO is:

  * ``memory`` — ``argument_size_in_bytes``: the bytes the port's rank
    holds (its blocks of the parameters, optimizer state or cache, and
    its slice of the batch: every abstract leaf is a fake tensor of its
    placed shape); ``argument_size_placed_in_bytes``: the same arguments
    built with no mesh (the config's global shapes), each cut to its
    leaf's placement (the reference's own per-device figure, counted
    apart from the held blocks, so the two agree only where every leaf
    is held at its placement); ``temp_size_in_bytes``:
    the peak of live bytes during the step beyond the arguments,
    counted by storage, so a view is never counted twice;
    ``output_size_in_bytes``: the outputs' bytes.  The reference's
    ``alias_`` and ``generated_code_size_in_bytes`` have no counterpart
    and read None.
  * costs — FLOPs from ``FlopCounterMode`` over the whole depth (an
    eager trace counts every layer, so the reference's extrapolation
    from two unrolled depths is not needed; :func:`_depth_handle` stays
    for the tests that hold the costs linear in depth); bytes accessed:
    the input and output bytes of every aten op that is not a view,
    unfused, so the memory term is an upper bound; collective bytes:
    the operand bytes ``core.distributed`` counts by kind.  All three
    are scaled by the chips, as in the reference.  ``collectives_by_axis``
    keeps the collective bytes by mesh axis, unscaled (rank 0's).
  * ``roofline`` — ``launch.roofline.Roofline`` with the H100's figures.

``FlopCounterMode`` counts matmul-class operators (and attention by
its registered formula), where XLA's cost analysis also counts
elementwise work, so the port's ``useful_flops_frac`` reads higher
than the reference's.  ``compile_s`` keeps the reference's name; here
it is the seconds the trace took.

The fake tensors live on :func:`default_device`: the card's type where
this torch is built with CUDA (whether or not a card is present), the
CPU otherwise, because a CPU-only build links no CUDA device guard for
autograd or Python indexing of a fake CUDA tensor.  On the CPU the
flash-attention wrapper takes its plain version, whose FLOPs are the
kernel's formula but whose (B, H, Sq, Sk) scores are live memory.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCH_IDS, SHAPES, cell_supported, get_config
from ..core import distributed as D
from ..models import Model
from ..models.sharding import (NO_MESH, local_shape, placement_of,
                               rules_for_mesh)
from . import roofline as rf
from .mesh import make_production_mesh, n_chips
from .steps import (abstract_serve_state, abstract_train_state,
                    input_specs, make_decode_step, make_prefill_step,
                    make_train_step, serving_rules)

# operator namespaces whose calls move bytes: aten's and the port's
# kernels' (``repro_torch::flash_attention_fwd``)
COMPUTING = ("aten", "repro_torch")

def default_device() -> str:
    """Where the fake tensors live: ``"cuda"`` when this torch is built
    with CUDA, else ``"cpu"`` (see the module's docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _depth_handle(cfg):
    """(u_full, make(u)) — rebuild the config at ``u`` depth units, so
    that per-unit costs can be held linear in depth (the reference's
    premise for extrapolating from two small depths)."""
    fam = cfg.family
    if fam == "dense" or fam == "ssm":
        return cfg.n_layers, lambda u: dataclasses.replace(cfg, n_layers=u)
    if fam == "moe":
        nd = cfg.n_dense_layers
        return (cfg.n_layers - nd,
                lambda u: dataclasses.replace(cfg, n_layers=nd + u))
    if fam == "hybrid":
        per = cfg.attn_every
        return (cfg.n_layers // per,
                lambda u: dataclasses.replace(cfg, n_layers=u * per))
    if fam == "encdec":
        return (cfg.n_layers,
                lambda u: dataclasses.replace(cfg, n_layers=u,
                                              n_encoder_layers=u))
    raise ValueError(fam)


class _Tally(TorchDispatchMode):
    """Counts, over the ops it sees: live bytes by storage (each one
    added when an op first returns it and taken off when it is freed)
    and their peak; with ``costs``, the input and output bytes of each
    operator that computes (aten's and the port's kernels'; not a view,
    nor a query such as ``prim::device``)."""

    def __init__(self, costs: bool):
        super().__init__()
        self.costs = costs
        self.live = self.peak = 0
        self.accessed = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live (once); returns its new bytes."""
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        if self.costs and func.namespace in COMPUTING and not func.is_view:
            self.accessed += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors (a view
    counts once, with its base)."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def _nbytes(t: torch.Tensor, shape=None) -> int:
    n = 1
    for s in (t.shape if shape is None else shape):
        n *= int(s)
    return n * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _arguments(cfg, shape, rules, device) -> tuple:
    """(params, state, batch) of the cell's step as fake tensors of this
    rank's blocks under ``rules`` (a serving cell's under
    ``serving_rules``; the batch: its slice along the batch axes, as
    ``train.run`` hands it out); ``state`` is None for a prefill."""
    if shape.kind == "train":
        params, state = abstract_train_state(cfg, rules, device)
        return params, state, input_specs(cfg, shape, rules, device)
    srules = serving_rules(cfg, rules)
    batch = input_specs(cfg, shape, srules, device)
    if shape.kind == "prefill":
        return Model(cfg, srules).abstract(device), None, batch
    params, state = abstract_serve_state(cfg, srules, shape, device)
    return params, state, batch


def trace_step(cfg, shape, rules, *, device: Optional[str] = None,
               costs: bool = True) -> dict:
    """Run the cell's step once on abstract state inside one
    ``FakeTensorMode``, as this rank of ``rules``' mesh (train, prefill
    with ``serving_rules``, or decode, as the reference's
    ``_lower_step`` builds it).  Returns this rank's ``memory``,
    ``flops``, ``flops_by_op`` (the same by operator: K5's
    ``repro_torch.flash_attention_fwd`` on a CUDA device, the plain
    version's ``aten.bmm`` on the CPU), ``bytes``, ``coll`` (collective
    operand bytes by kind) and ``coll_by_axis`` (the same by mesh axis),
    unscaled, and the trace's ``seconds``."""
    device = device or default_device()
    t0 = time.perf_counter()
    with FakeTensorMode():
        params, state, batch = _arguments(cfg, shape, rules, device)
        if shape.kind == "train":
            step, _ = make_train_step(cfg, rules)
            args, kw = (params, state, batch), {"global_batch":
                                                shape.global_batch}
        elif shape.kind == "prefill":
            step, _ = make_prefill_step(cfg, serving_rules(cfg, rules))
            args, kw = (params, batch), {}
        else:
            step, _ = make_decode_step(cfg, serving_rules(cfg, rules))
            args, kw = (params, state, batch["token"], batch["pos"]), {}
        leaves = _tensors((params, state, batch))
        # the reference's per-device bytes: the config's global shapes
        # (the same arguments built with no mesh) through each leaf's
        # placement, apart from the blocks this rank holds
        whole = _tensors(_arguments(cfg, shape, NO_MESH, device))
        if len(whole) != len(leaves):
            raise RuntimeError(f"{len(leaves)} arguments under the mesh, "
                               f"{len(whole)} without one")
        placed = sum(_nbytes(w, local_shape(w.shape, placement_of(t)))
                     for t, w in zip(leaves, whole))
        D.reset_collectives()
        tally = _Tally(costs)
        held = sum(tally.hold(t) for t in leaves)
        flop_ctx = (FlopCounterMode(display=False) if costs
                    else contextlib.nullcontext())
        with flop_ctx as fc, tally:
            out = step(*args, **kw)
        out_bytes = storage_bytes(out)
        del out
    memory = {"temp_size_in_bytes": float(tally.peak - held),
              "argument_size_in_bytes": float(held),
              "argument_size_placed_in_bytes": float(placed),
              "output_size_in_bytes": float(out_bytes),
              "alias_size_in_bytes": None,
              "generated_code_size_in_bytes": None}
    return {"memory": memory,
            "flops": float(fc.get_total_flops()) if costs else None,
            "flops_by_op": ({str(k): int(v) for k, v in
                             fc.get_flop_counts()["Global"].items()}
                            if costs else None),
            "bytes": float(tally.accessed) if costs else None,
            "coll": dict(D.COLLECTIVE_BYTES),
            "coll_by_axis": {a: dict(c) for a, c in
                             D.COLLECTIVE_BYTES_BY_AXIS.items()},
            "device": device, "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks, joined if none stands and destroyed on exit; one that stands
    is used as it is if it is fake and of that size."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry-run needs a 'fake' process group of {world} "
                f"ranks; this process joined a {dist.get_backend()!r} one "
                f"of {dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                verbose: bool = True, costs: bool = True,
                cfg=None, device: Optional[str] = None) -> dict:
    """One cell on the production mesh (``cfg`` overrides the arch's
    config, e.g. at another depth).  Returns the reference's record:
    ``memory`` and, with ``costs``, ``roofline``; a cell that
    ``cell_supported`` rules out is ``"skipped"``."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    device = device or default_device()
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rules = rules_for_mesh(mesh)
        chips = n_chips(mesh)
        tr = trace_step(cfg, shape, rules, device=device, costs=costs)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "chips": chips, "device": device,
              "compile_s": tr["seconds"], "memory": tr["memory"],
              "flops_per_rank": tr["flops"],
              "flops_by_operator_per_rank": tr["flops_by_op"],
              "collectives_by_axis": tr["coll_by_axis"]}
    label = f"{arch} x {shape_name} x {'2x16x16' if multi_pod else '16x16'}"
    if not costs:
        if verbose:
            print(f"== {label} OK [{result['compile_s']:.1f}s] "
                  f"mem={result['memory']}")
        return result
    # the trace is the per-device program: scale by chips so that the
    # roofline numerators are global (the per-chip divisor cancels back)
    coll = tr["coll"]
    roof = rf.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=tr["flops"] * chips, hlo_bytes=tr["bytes"] * chips,
        coll_bytes=float(sum(coll.values())) * chips,
        coll_breakdown={k: int(v) for k, v in coll.items()},
        model_flops=rf.model_flops_for(cfg, shape),
        bytes_per_device=tr["memory"]["temp_size_in_bytes"])
    result["roofline"] = roof.row()
    if verbose:
        print(f"== {label} ({chips} chips, {device}) "
              f"[{result['compile_s']:.1f}s trace]")
        print(f"   memory: {result['memory']}")
        print(f"   cost_analysis: flops={roof.hlo_flops:.3e} "
              f"bytes={roof.hlo_bytes:.3e}")
        print(f"   collectives: { {k: v for k, v in coll.items() if v} }")
        print(f"   collectives by axis (rank 0): {tr['coll_by_axis']}")
        print(f"   roofline: compute={roof.compute_s:.4f}s "
              f"memory={roof.memory_s:.4f}s "
              f"collective={roof.collective_s:.4f}s "
              f"-> dominant={roof.dominant} "
              f"useful={roof.useful_flops_frac:.2%} "
              f"frac={roof.roofline_frac:.2%}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Dry-run each (arch x shape) cell's step on fake "
                    "tensors over a fake 256/512-rank group (no card).")
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all LM archs)")
    ap.add_argument("--shape", default=None,
                    help="shape name (default: all four)")
    ap.add_argument("--all", action="store_true",
                    help="run the full 40-cell sweep")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-costs", action="store_true",
                    help="memory proof only")
    ap.add_argument("--out", default=None, help="write JSON results here")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch
             else [a for a in ARCH_IDS if a != "blasx_gemm"])
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(dryrun_cell(arch, shape, multi_pod=mp,
                                               costs=not args.no_costs))
                except Exception as e:   # one cell's failure is recorded
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "multi" if mp else "single",
                                    "status": "failed", "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {len(failures)} FAILED")
    for f in failures:
        print("   FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
