"""``python -m repro_torch.analysis`` — run the static analyses over
the port (and the optional witness smoke) from the command line.

Stdlib-only at import on purpose, like the reference's: the gate runs
straight off a checkout (``PYTHONPATH=src python -m
repro_torch.analysis --strict src/repro_torch``), and only
``--witness-smoke`` imports torch and the port, inside its function.

Exit status: 0 when every finding is covered by the baseline (or with
no ``--strict``, always unless the run itself errors); 1 under
``--strict`` when unsuppressed findings remain, and for the witness
smoke on any inversion or when no lock was witnessed; 2 for usage/IO
errors.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from . import assertions, determinism, locks
from .findings import (Baseline, Finding, RULES, normalize_path,
                       split_findings)


def _collect_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            out.append(p)
        else:
            raise FileNotFoundError(f"not a python file or directory: {raw}")
    return out


def run_analyses(paths: Sequence[str]) -> Tuple[List[Finding], int]:
    """All findings over the given files/dirs + number of files read.

    Per-module rules run file by file; the lock-order graph is built
    once over the whole set (cycles cross module boundaries — the
    Alru<->MesixDirectory shape lives in two files).
    """
    files = _collect_files(paths)
    findings: List[Finding] = []
    modules: List[Tuple[ast.Module, str]] = []
    for f in files:
        rel = normalize_path(f)
        try:
            tree = ast.parse(f.read_text(encoding="utf-8"))
        except SyntaxError as e:
            raise SyntaxError(f"{f}: {e}") from e
        modules.append((tree, rel))
        findings.extend(locks.check_lock_discipline(tree, rel))
        findings.extend(determinism.check_determinism(tree, rel))
        findings.extend(assertions.check_assertions(tree, rel))
    findings.extend(locks.check_lock_order(modules))
    return findings, len(files)


def _witness_smoke(verbose: bool, device: str) -> int:
    """Drive a threads-mode multi-device workload (context routines +
    the serving front end) under the lock-witness on ``device``;
    non-zero exit on any dynamic lock-order inversion, or when no port
    lock was witnessed (a filter that matches nothing proves nothing)."""
    from .witness import LockWitness

    witness = LockWitness()
    with witness.activate():
        # imports happen inside the activation so module-level locks
        # (kernel launch counts, build cache, tuning shared cache,
        # default-context registry) are witnessed
        import numpy as np

        from repro_torch.api.context import BlasxContext
        from repro_torch.core.runtime import RuntimeConfig
        from repro_torch.serve.server import BlasxServer

        rng = np.random.default_rng(0)
        n = 192
        a = rng.standard_normal((n, n))
        b = rng.standard_normal((n, n))
        spd = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
        cfg = RuntimeConfig(n_devices=2, mode="threads", device=device)

        ctx = BlasxContext(cfg, tile=64)
        try:
            ctx.gemm(a, b)
            ctx.syrk(a)
            ctx.trsm(spd, b, uplo="L")
        finally:
            ctx.close()

        srv = BlasxServer(cfg, pool_size=2, tile=64)
        try:
            futs = [srv.submit(t, "gemm", a, b)
                    for t in ("alice", "bob", "alice", "bob")]
            for f in futs:
                f.result(timeout=120)
        finally:
            srv.close()

    print(witness.report() if verbose else
          witness.report().splitlines()[0])
    return 1 if witness.inversions() or not witness.witnessed_locks else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lock-discipline, lock-order, determinism and "
                    "assertion-strength analyses for the PyTorch port")
    parser.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files/directories to scan (default: src/repro_torch)")
    parser.add_argument(
        "--strict", action="store_true",
        help="exit 1 if any finding is not covered by the baseline")
    parser.add_argument(
        "--baseline", default=None, metavar="JSON",
        help="suppression baseline (default: the committed "
             "src/repro_torch/analysis/baseline.json)")
    parser.add_argument(
        "--json", action="store_true",
        help="emit findings as JSON instead of text")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    parser.add_argument(
        "--witness-smoke", action="store_true",
        help="run a threads-mode workload under the runtime "
             "lock-witness; exit 1 on any dynamic inversion")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the witness smoke computes (default: the card, "
             "which raises without one)")
    parser.add_argument(
        "--verbose", action="store_true",
        help="show suppressed findings / full witness report too")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    if args.witness_smoke:
        return _witness_smoke(args.verbose, args.device)

    try:
        baseline = Baseline.load(args.baseline)
        findings, n_files = run_analyses(args.paths)
    except (FileNotFoundError, ValueError, SyntaxError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    unsup, sup = split_findings(findings, baseline)

    if args.json:
        print(json.dumps({
            "files": n_files,
            "findings": [vars(f) | {"key": f.key, "suppressed": False}
                         for f in unsup]
            + [vars(f) | {"key": f.key, "suppressed": True}
               for f in sup],
        }, indent=2))
    else:
        for f in unsup:
            print(f.render())
        if args.verbose:
            for f in sup:
                print(f"{f.render()}  [suppressed]")
        stale = baseline.unused(findings)
        for rule, key in stale:
            print(f"warning: stale baseline entry {rule} {key}",
                  file=sys.stderr)
        print(f"repro_torch.analysis: {n_files} files, "
              f"{len(unsup)} findings, {len(sup)} suppressed")

    return 1 if (args.strict and unsup) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
