"""Quickstart for the PyTorch/CUDA port: the two-layer BLASX API.

High-level layer: a persistent ``BlasxContext`` runs all six L3
routines on 3 simulated devices with warm ALRU/MESI-X tile caches:
operands registered once (``ctx.tile``) are fetched once, and every
later routine that touches them is served from cache (watch the
per-call H2D column fall).  Low-level layer: the same engine behind
strict CBLAS signatures for legacy callers.  The tiles compute on the
card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import (BlasxContext, CblasNoTrans, CblasRowMajor,
                             cblas_dgemm)
from repro_torch.core import (ref_gemm, ref_symm, ref_syr2k, ref_syrk,
                              ref_trmm, ref_trsm)
from repro_torch.core.runtime import RuntimeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tiles compute (default: the card)")
    ap.add_argument("--n", type=int, default=1024,
                    help="matrix order (tiles of n/4, at most 256)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n = args.n
    tile = min(256, max(1, n // 4))
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))
    C = rng.standard_normal((n, n))
    T = A + n * np.eye(n)                      # well-conditioned triangular

    cfg = RuntimeConfig(n_devices=3, policy="blasx",
                        p2p_groups=[[0], [1, 2]],   # Everest topology
                        cache_bytes=256 << 20, mode="sim",
                        device=args.device)

    with BlasxContext(cfg, tile=tile) as ctx:
        # register once: every routine below reuses these cached tiles
        Ah, Bh, Th = ctx.tile(A), ctx.tile(B), ctx.tile(T)

        cases = [
            ("gemm", lambda: ctx.gemm(Ah, Bh, C, alpha=1.2, beta=0.3),
             ref_gemm(A, B, C, alpha=1.2, beta=0.3)),
            ("syrk", lambda: ctx.syrk(Ah, C, alpha=0.9, beta=0.5),
             ref_syrk(A, C, alpha=0.9, beta=0.5)),
            ("syr2k", lambda: ctx.syr2k(Ah, Bh, C, alpha=0.9, beta=0.5),
             ref_syr2k(A, B, C, alpha=0.9, beta=0.5)),
            ("symm", lambda: ctx.symm(Ah, Bh, C, alpha=1.1, beta=0.2),
             ref_symm(A, B, C, alpha=1.1, beta=0.2)),
            ("trmm", lambda: ctx.trmm(Ah, Bh, alpha=0.7),
             ref_trmm(A, B, alpha=0.7)),
            ("trsm", lambda: ctx.trsm(Th, Bh, alpha=0.7),
             ref_trsm(T, B, alpha=0.7)),
        ]
        print("routine   max|err|   per-call ledger (warm context)")
        for name, fn, want in cases:
            out = fn()
            err = np.abs(np.asarray(out.array()) - np.asarray(want)).max()
            c = ctx.last_call
            print(f"{name:8s} {err:10.2e}   h2d={c.h2d_bytes/1e6:7.1f}MB "
                  f"p2p={c.d2d_bytes/1e6:6.1f}MB "
                  f"d2h={c.d2h_bytes/1e6:6.1f}MB  l1_hits={c.l1_hits}")

        # async serving-shaped traffic: submissions overlap the host,
        # shared weights (Bh) stay cached across the whole batch
        futs = [ctx.submit("gemm", ctx.tile(x), Bh)
                for x in (rng.standard_normal((max(1, n // 4), n))
                          for _ in range(4))]
        warm = [f.result() for f in futs]
        print(f"\nasync batch: {len(warm)} gemms, last-call h2d="
              f"{ctx.last_call.h2d_bytes/1e6:.1f}MB (weights served "
              "from the warm L1/L2 tile caches)")

        st = ctx.stats()
        print(f"session: {st['calls']} calls, "
              f"h2d={st['comm_bytes']['h2d']/1e9:.2f}GB "
              f"p2p={st['comm_bytes']['d2d']/1e9:.2f}GB")

        # legacy layer: strict CBLAS signatures, in-place C update
        Cb = np.array(C, copy=True)
        cblas_dgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, n, n, n,
                    1.2, A, n, B, n, 0.3, Cb, n, ctx=ctx)
    err = np.abs(Cb - np.asarray(ref_gemm(A, B, C, alpha=1.2, beta=0.3))).max()
    print(f"\ncblas_dgemm max|err| = {err:.2e} (legacy layer, same engine)")


if __name__ == "__main__":
    main()
