"""Faults planted in the program underneath a run, for the tests that
see ``correct`` come out false.  Each breaks the timed path the way a
wrong optimisation could:

  ``unchanged``    the output is never written: C keeps its initial state
  ``half``         half of each k-chain left out, the rest scaled up to
                   the whole (the mean over what is left)
  ``altered``      one element of C changed by 1 where it is produced
  ``no_exchange``  (ring) the hops between ranks left out

``python faults.py --fault <name> <ring rank arguments>`` runs one rank
of the ring driver with the fault planted.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))
SRC = BENCH_DIR.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

BLAS_FAULTS = ("unchanged", "half", "altered")
RING_FAULTS = ("unchanged", "half", "altered", "no_exchange")


def plant_blas(fault: str, setattr_):
    """Break ``BlasxContext.gemm``'s path with ``setattr_(obj, name,
    value)`` (pytest's ``monkeypatch.setattr``)."""
    from repro_torch.backends.base import GroupResult
    from repro_torch.backends.cuda_backend import CudaBackend
    from repro_torch.core.tiling import TiledMatrix

    write = TiledMatrix.write_tile
    if fault == "unchanged":
        setattr_(TiledMatrix, "write_tile", lambda self, i, j, value: None)
    elif fault == "altered":
        def altered(self, i, j, value):
            if (i, j) == (0, 0):
                value = value.clone()
                value[0, 0] += 1.0
            write(self, i, j, value)
        setattr_(TiledMatrix, "write_tile", altered)
    elif fault == "half":
        run = CudaBackend.run_group

        def half(self, key, a_tiles, b_tiles):
            s = key.steps
            h = max(1, s // 2)
            items = len(a_tiles) // s
            keep = [i * s + j for i in range(items) for j in range(h)]
            res = run(self, dataclasses.replace(key, steps=h),
                      [a_tiles[x] for x in keep], [b_tiles[x] for x in keep])
            return GroupResult([p * (s / h) for p in res.products],
                               res.launches, res.engine)
        setattr_(CudaBackend, "run_group", half)
    else:
        raise ValueError(f"no such fault {fault!r}")


def plant_ring(fault: str) -> None:
    """Break ``distributed_gemm``'s ring in this rank's process."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D

    rsm = D.ring_reduce_scatter_matmul
    if fault == "no_exchange":
        D._hop = lambda send, group: (send.clone(), [])
    elif fault == "unchanged":
        D.ring_reduce_scatter_matmul = lambda x, w, group: torch.zeros(
            -(-x.shape[0] // dist.get_world_size(group)), w.shape[1],
            dtype=torch.promote_types(x.dtype, w.dtype), device=x.device)
    elif fault == "half":
        def half(x, w, group):
            d, idx = dist.get_world_size(group), dist.get_rank(group)
            return rsm(x * (2.0 if idx < d // 2 else 0.0), w, group)
        D.ring_reduce_scatter_matmul = half
    elif fault == "altered":
        def altered(x, w, group):
            y = rsm(x, w, group)
            if dist.get_rank(group) == 0:
                y[0, 0] += 1.0
            return y
        D.ring_reduce_scatter_matmul = altered
    else:
        raise ValueError(f"no such fault {fault!r}")


if __name__ == "__main__":
    args = sys.argv[1:]
    plant_ring(args[args.index("--fault") + 1])
    from yardstick import registry
    sys.exit(registry.load_module("drivers", "ring").rank_main(args))
