"""``python -m repro_torch.serve --demo`` — drive the server without
client code: two tenants on a two-context pool, one interactive with a
warm weight handle and a cache quota protecting it, one flooding batch
traffic; prints the per-tenant stats ledger and exits non-zero if the
scenario misbehaves.  It computes on the card unless ``--device cpu``
is given; without a card the default fails."""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from ..core.runtime import RuntimeConfig
from . import BATCH, INTERACTIVE, BlasxServer


def demo(n: int = 96, tile: int = 32, floods: int = 8,
         serves: int = 6, device: str = "cuda") -> int:
    rng = np.random.default_rng(0)
    cfg = RuntimeConfig(n_devices=2, mode="sim", cache_bytes=8 << 20,
                        device=device)
    with BlasxServer(cfg, pool_size=2, tile=tile, max_depth=64,
                     quotas={"flood": 256 << 10}) as srv:
        w = srv.tile("interactive-app",
                     rng.standard_normal((n, n)))
        x = srv.tile("interactive-app",
                     rng.standard_normal((n, n)))
        big = rng.standard_normal((2 * n, 2 * n))
        futs = [srv.submit("flood", "gemm", big, big, priority=BATCH)
                for _ in range(floods)]
        outs = [srv.submit("interactive-app", "gemm", x, w,
                           priority=INTERACTIVE)
                for _ in range(serves)]
        ref = x.array() @ w.array()
        for f in outs:
            if not np.allclose(f.result(timeout=60).array(), ref,
                               atol=1e-8):
                print("demo FAILED: wrong gemm result", file=sys.stderr)
                return 1
        for f in futs:
            f.result(timeout=60)
        st = srv.stats()
    for tenant, row in sorted(st["tenants"].items()):
        print(f"{tenant:16s} completed={row['completed']:3d} "
              f"rejected={row['rejected']:3d} "
              f"p50={row['latency_p50_ms']:8.2f}ms "
              f"p99={row['latency_p99_ms']:8.2f}ms "
              f"wait_p50={row['queue_wait_p50_ms']:8.2f}ms "
              f"quota_evictions={row['quota_evictions']}")
    print(f"pool={st['pool_size']} lane_load={st['lane_load']} "
          f"affinity={st['affinity']} device={device}")
    if st["tenants"]["interactive-app"]["completed"] != serves:
        print("demo FAILED: interactive requests lost", file=sys.stderr)
        return 1
    print("demo OK")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.serve",
        description="BlasxServer smoke entrypoint")
    ap.add_argument("--demo", action="store_true",
                    help="run the two-tenant demo scenario")
    ap.add_argument("--n", type=int, default=96,
                    help="interactive matrix size (default 96)")
    ap.add_argument("--device", default="cuda",
                    help="where tiles are computed: cuda (default, needs "
                         "a card) or cpu")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.print_help()
        return 2
    return demo(n=args.n, device=args.device)


if __name__ == "__main__":  # pragma: no cover - exercised by CI
    sys.exit(main())
