#!/usr/bin/env python3
"""The ring GEMM's hop/matmul overlap on several cards of one host.

Starts one process a card (NCCL; the rendezvous is a ``file://`` store
in a temp dir), builds a (1, n) (data, model) mesh, and on the model
axis times ``distributed_gemm`` in ring and gspmd modes beside the two
parts of the ring alone: its n row-block products with no hop, and its
n - 1 hops of an accumulator block with no product.  Each result is
checked against an f64 oracle on the card (the reference's 1e-3 limit
at its K = 128, scaled by sqrt(K / 128)); a result past its limit
exits non-zero.  Prints one JSON line per dtype from rank 0.  Needs
``--cards`` CUDA devices; ``--device cpu`` rehearses it in gloo ranks
(host-clock times, not device metrics):

  python3 tools/ring_overlap.py --cards 4 --n 16384
  python3 tools/ring_overlap.py --device cpu --cards 4 --n 256
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 5
# the reference's limits at K = 128 (test_distributed.py), max abs
TOL = {"float32": 1e-3, "bfloat16": 1.0}


def _events_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` by CUDA events after one warm-up (on
    the CPU: the host clock)."""
    import torch
    fn()
    if not torch.cuda.is_initialized():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rank_main(rank: int, world: int, store: str, n: int,
              device: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import (init_process_group,
                                         make_mesh_for_devices)

    torch.backends.cuda.matmul.allow_tf32 = False
    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    try:
        mesh = make_mesh_for_devices(world, world, device=device)
        group = mesh.get_group("model")
        gen = torch.Generator(device=device).manual_seed(0)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            a = torch.randn((n, n), generator=gen, device=device).to(dt)
            b = torch.randn((n, n), generator=gen, device=device).to(dt)
            tol = TOL[name] * math.sqrt(n / 128)
            kc, mb = n // world, n // world
            a_blk, b_blk = a[:, rank * kc:(rank + 1) * kc], \
                b[rank * kc:(rank + 1) * kc]
            row = {"dtype": name, "n": n, "cards": world}
            for mode in ("ring", "gspmd"):
                D.reset_collectives()
                c = D.distributed_gemm(a, b, mesh, mode=mode)
                sync()
                row[f"{mode}_collectives"] = dict(D.COLLECTIVES)
                if rank == 0:
                    # the oracle in f64, one row block at a time
                    err = max(float((c[i:i + mb].double() - a[i:i + mb]
                                     .double() @ b.double()).abs().max())
                              for i in range(0, n, mb))
                    row[f"{mode}_max_abs_err"] = err
                    if err > tol:
                        raise SystemExit(f"{mode} {name}: max abs {err:.3e}"
                                         f" > {tol:.3e}")
                del c
                dist.barrier()
                row[f"{mode}_ms"] = _events_ms(
                    lambda: D.distributed_gemm(a, b, mesh, mode=mode))
            row["tol"] = tol
            # the ring's products alone (its operands widened once, its n
            # row blocks, no hop) and its hops alone (n - 1 accumulator
            # blocks, no product)
            def products():
                x, w = a_blk.float(), b_blk.float()
                return [x[i * mb:(i + 1) * mb] @ w for i in range(world)]
            row["ring_products_ms"] = _events_ms(products)
            acc = D._dot(a_blk[:mb], b_blk)

            def hops():
                x = acc
                for _ in range(world - 1):
                    x, reqs = D._hop(x, group)
                    for r in reqs:
                        r.wait()
            dist.barrier()
            row["ring_hops_ms"] = _events_ms(hops)
            row["hop_bytes"] = acc.numel() * acc.element_size()
            dist.barrier()
            if rank == 0:
                print(json.dumps({"ring_overlap": row}), flush=True)
            del a, b, a_blk, b_blk, acc
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args.rank, args.cards, args.store, args.n, args.device)
        return 0
    import torch
    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        print(f"ring_overlap: needs {args.cards} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--cards", str(args.cards), "--n",
             str(args.n), "--device", args.device, "--rank", str(r),
             "--store", store],
            env=dict(os.environ, LOCAL_RANK=str(r))) for r in range(args.cards)]
        try:
            # a rank that fails leaves the others in a collective: stop
            # at the first failure (or after 600 s), not at a join
            deadline = time.monotonic() + 600
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
    print(f"ring_overlap: {time.perf_counter() - t0:.1f} s, exit codes {rcs}",
          flush=True)
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
