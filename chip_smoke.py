#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device — the card's name and power limit (nvidia-smi) and
   ``torch.cuda.get_device_name``; exits 1 without CUDA.
2. build  — compiles ``src/repro_torch/kernels/csrc/blasx_gemm.cu`` with
   nvcc and prints the build seconds and ptxas's register report.
3. kernel — the hand-written batched long-K GEMM against its plain
   PyTorch version on the card, in f64/f32/bf16/f16, at the runtime's
   shape (G,S,M,K,N) = (4,16,1024,1024,1024), a ragged shape and small
   odd shapes, by normwise relative error; at the runtime's shape it
   times the kernel, the plain version and ``torch.matmul`` on the
   folded shape (a yardstick only), beside the least time the card
   could take (``bound_ms``).
4. main path — ``BlasxContext(backend="cuda", device="cuda")`` runs the
   paper's Fig. 7/10 regime (N=16384, tile 1024, 2 simulated devices)
   for DGEMM, SGEMM and a bf16 GEMM, an f16 GEMM at N=8192, SYRK/SYMM/
   TRMM/TRSM at N=8192 in f32 and a 2-device threads-mode DGEMM at
   N=4096, each checked against an f64 oracle on the card, with the
   kernel's launch counter held against the ledger.

The last two lines are a JSON object describing each kernel and then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/blasx_gemm.cu"
# the Pallas kernel it replaces: matmul_pallas, which reaches
# pl.pallas_call (body _matmul_kernel at :37, wrapper ops.matmul at
# ops.py:50, batched by pallas_backend._batched_pallas_contract at :47)
REPLACES = "src/repro/kernels/matmul.py:74"

# least-time model (NVIDIA H100 SXM data sheet, dense): FP64 on the
# tensor cores, FP32 outside them (TF32 is not the same arithmetic),
# bf16/fp16 on the tensor cores; HBM3 at 3.35 TB/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12,
              "float16": 989e12}
PEAK_NAME = {"float64": "FP64 tensor 67 TFLOP/s",
             "float32": "FP32 non-tensor 67 TFLOP/s",
             "bfloat16": "BF16 dense tensor 989 TFLOP/s",
             "float16": "FP16 dense tensor 989 TFLOP/s"}
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version, normwise relative error: f64 and f32 are
# FMA sums in another order (f32 never takes TF32); bf16/f16 round the
# f32 sums to 8/11 bits
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-4, "bfloat16": 2e-2,
              "float16": 2e-2}
MAIN_SHAPE = (4, 16, 1024, 1024, 1024)
SHAPES = [MAIN_SHAPE, (3, 2, 1000, 997, 1003), (1, 1, 1024, 1024, 1024),
          (1, 1, 1, 7, 5), (2, 3, 65, 33, 129), (5, 1, 17, 300, 31),
          (1, 4, 128, 64, 64)]
DTYPES = ("float64", "float32", "bfloat16", "float16")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def normwise(got, want) -> float:
    import torch
    g, w = got.to(torch.float64), want.to(torch.float64)
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w))


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(shape, dtype: str):
    """(bound_ms, bound_by): the larger of the flops over the dtype's
    peak and the bytes (inputs read once, output written once) over
    the memory rate."""
    from repro_torch.core.dtypes import canonical_dtype
    g, s, m, k, n = shape
    itemsize = canonical_dtype(dtype).itemsize
    flops = 2 * g * s * m * k * n
    nbytes = (g * s * (m * k + k * n) + g * m * n) * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {card} | torch: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build("blasx_gemm")
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.1f} s", flush=True)
    report = path.with_suffix(".ptxas.txt")
    if report.is_file():
        fn = None
        for line in report.read_text().splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                t = re.search(r"batched_gemm_kernelI(\w+?)Li(\d+)ELi(\d+)ELi(\d+)E",
                              fn)
                label = ("%s %sx%sx%s" % t.groups()) if t else fn[:40]
                print(f"[build] ptxas {label}: {line.split(':', 1)[1].strip()}")
            if "spill" in line and not re.search(r"\b0 bytes spill stores", line):
                print(f"[build] ptxas spill: {line.strip()}")
    return secs


def phase_kernel(card: str):
    import torch
    from repro_torch.core.dtypes import accumulator_dtype, canonical_dtype
    from repro_torch.kernels.matmul import batched_contract
    from repro_torch.kernels.ref import batched_contract_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name in DTYPES:
        dt = canonical_dtype(name)
        worst, max_abs = 0.0, 0.0
        for shape in SHAPES:
            g, s, m, k, n = shape
            a = torch.randn((g, s, m, k), generator=gen, device="cuda",
                            dtype=torch.float32).to(dt)
            b = torch.randn((g, s, k, n), generator=gen, device="cuda",
                            dtype=torch.float32).to(dt)
            got = batched_contract(a, b)
            torch.cuda.synchronize()
            want = batched_contract_ref(a, b)
            err = normwise(got, want)
            abs_err = float((got.to(torch.float64)
                             - want.to(torch.float64)).abs().max())
            print(f"[kernel] {name} {shape}: normwise {err:.3e} "
                  f"max_abs {abs_err:.3e} (tol {KERNEL_TOL[name]:.0e})",
                  flush=True)
            check(err <= KERNEL_TOL[name],
                  f"kernel {name} {shape} normwise {err:.3e} > "
                  f"{KERNEL_TOL[name]:.0e}")
            worst = max(worst, err)
            if shape == MAIN_SHAPE:
                max_abs = abs_err
                acc = accumulator_dtype(dt)
                a2 = a.transpose(1, 2).reshape(g, m, s * k).contiguous()
                b2 = b.reshape(g, s * k, n)
                reps = 5
                ms = time_ms(lambda: batched_contract(a, b), reps)
                plain_ms = time_ms(lambda: batched_contract_ref(a, b), reps)
                lib_ms = time_ms(lambda: torch.matmul(a2, b2), reps)
                bound_ms, bound_by = bound(shape, name)
                flops = 2 * g * s * m * k * n
                print(f"[kernel] {name} {shape}: kernel {ms:.3f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f}"
                      f" ms, torch.matmul folded {lib_ms:.3f} ms, bound "
                      f"{bound_ms:.3f} ms ({bound_by}; {PEAK_NAME[name]}) "
                      f"acc {acc} | {card}", flush=True)
                results[name] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound_ms,
                                     bound_by=bound_by, max_abs_err=max_abs)
                del a2, b2
        results[name]["worst_normwise"] = worst
    return results


def _rand(gen, n, m, dtype, scale=1.0):
    import torch
    return (torch.randn((n, m), generator=gen, device="cuda",
                        dtype=torch.float64 if dtype == torch.float64
                        else torch.float32) * scale).to(dtype)


def phase_main_path(card: str, n_gemm: int):
    import torch
    from repro_torch.api import BlasxContext
    from repro_torch.core import blas3
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.kernels import matmul as kmm

    gen = torch.Generator(device="cuda").manual_seed(7)
    launches_by_ledger = {}

    def ctx_for(mode="sim"):
        return BlasxContext(RuntimeConfig(
            n_devices=2, backend="cuda", device="cuda",
            cache_bytes=8 << 30, mode=mode), tile=1024)

    def report(label, n, flops, wall, err, tol, ctx):
        ls = ctx.stats()["launch"]
        print(f"[main] {label} N={n}: {wall:.3f} s wall, "
              f"{flops / wall / 1e9:.1f} GFLOP/s, normwise {err:.3e} "
              f"(tol {tol:.0e}), launches {ls['kernel_launches']}, "
              f"engines {sorted(ls['engine_flops'])} | {card}", flush=True)
        check(err <= tol, f"{label} normwise {err:.3e} > {tol:.0e}")
        return ls

    def gemm(label, n, dtype, tol, mode="sim"):
        a_dev, b_dev = _rand(gen, n, n, dtype), _rand(gen, n, n, dtype)
        a_host, b_host = a_dev.cpu(), b_dev.cpu()
        ctx = ctx_for(mode)
        before = kmm.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctx.gemm(a_host, b_host)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = out.tiled.data.to("cuda")
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        want = torch.matmul(a_dev.to(acc), b_dev.to(acc))
        ls = report(label, n, 2 * n ** 3, wall, normwise(got, want), tol,
                    ctx)
        check(set(ls["engine_flops"]) == {"cuda"},
              f"{label}: engines {ls['engine_flops']} (want only cuda)")
        check(kmm.LAUNCHES - before == ls["kernel_launches"],
              f"{label}: kernel counted {kmm.LAUNCHES - before} launches, "
              f"ledger {ls['kernel_launches']}")
        launches_by_ledger[label] = ls["kernel_launches"]
        ctx.close()

    # the paper's DGEMM/SGEMM regime; then the half precisions
    gemm("dgemm", n_gemm, torch.float64, 1e-12)
    gemm("sgemm", n_gemm, torch.float32, 1e-5)
    gemm("bf16 gemm", n_gemm, torch.bfloat16, 2e-2)
    gemm("f16 gemm", 8192, torch.float16, 2e-2)

    # the other routines at N=8192 in f32, against the f64 oracle on the
    # card; tolerance 1e-4 normwise (f32 sums of 8192 terms, and TRSM's
    # chained tile solves)
    n = 8192
    a = _rand(gen, n, n, torch.float32)
    b = _rand(gen, n, n, torch.float32)
    a_tri = torch.triu(a) + n * torch.eye(n, device="cuda")
    cases = [
        ("syrk", lambda c: c.syrk(a.cpu()),
         lambda: blas3.ref_syrk(a), n ** 3),
        ("symm", lambda c: c.symm(a.cpu(), b.cpu()),
         lambda: blas3.ref_symm(a, b), 2 * n ** 3),
        ("trmm", lambda c: c.trmm(a.cpu(), b.cpu()),
         lambda: blas3.ref_trmm(a, b), n ** 3),
        ("trsm", lambda c: c.trsm(a_tri.cpu(), b.cpu()),
         lambda: blas3.ref_trsm(a_tri, b), n ** 3),
    ]
    for label, run, oracle, flops in cases:
        ctx = ctx_for()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ls = report(f"{label} f32", n, flops, wall,
                    normwise(out.tiled.data.to("cuda"), oracle()), 1e-4, ctx)
        engines = set(ls["engine_flops"])
        if label == "symm":
            # full-fill off-diagonal blocks on the kernel, sym-fill
            # diagonal blocks on the torch fallback
            check(engines == {"cuda", "torch"}, f"symm engines {engines}")
        elif label == "syrk":
            # every SYRK step multiplies full tiles: all on the kernel
            check(engines == {"cuda"}, f"syrk engines {engines}")
        else:
            check(engines == {"torch"}, f"{label} engines {engines}")
        ctx.close()

    # the faithful threaded engine: one host thread per simulated device
    gemm("threads dgemm", 4096, torch.float64, 1e-12, mode="threads")
    return launches_by_ledger


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import matmul as kmm

    card = phase_device()
    build_s = phase_build()
    kern = phase_kernel(card)
    # the counts start at 0 for the main path; the kernel phase's
    # comparison launches do not count
    kmm.LAUNCHES = 0
    kmm.LAUNCHES_BY_DTYPE.clear()
    phase_main_path(card, 16384)
    launches = {name: kmm.LAUNCHES_BY_DTYPE.get(name, 0) for name in DTYPES}
    for name in DTYPES:
        check(launches[name] > 0,
              f"kernel for {name} never launched on the main path")
    print(f"[done] build {build_s:.1f} s | {card}")
    kernels = [{
        "name": f"blasx_batched_gemm<{name}>", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches[name],
        "max_abs_err": kern[name]["max_abs_err"],
        "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
        "bound_ms": kern[name]["bound_ms"],
        "bound_by": kern[name]["bound_by"],
        "library_ms": kern[name]["library_ms"],
    } for name in DTYPES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
