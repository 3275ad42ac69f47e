#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device — the card's name and power limit (nvidia-smi) and
   ``torch.cuda.get_device_name``; exits 1 without CUDA.
2. build  — compiles ``src/repro_torch/kernels/csrc/blasx_gemm.cu`` and
   ``flash_attention.cu`` with nvcc, one process each, both at once, and
   prints the build seconds and ptxas's register report.
3. kernel — the hand-written batched long-K GEMM against its plain
   PyTorch version on the card, in f64/f32/bf16/f16, at the runtime's
   shape (G,S,M,K,N) = (4,16,1024,1024,1024), ragged shapes and small
   odd shapes, by normwise relative error.  Each call's path
   (``kernel_path``: wgmma for aligned f16/bf16, dmma for f64, simt for
   f32 and unaligned 16-bit shapes) is printed; the shapes cover each
   tensor-core path's hazards (one 64-tile, ragged M/N across item
   boundaries, M = 1, K = 8).  At the runtime's shape it times the
   kernel on each compiled block of its path, the plain version and
   ``torch.matmul`` on the folded shape (a yardstick only), beside the
   least time the card could take (``bound_ms``); the 16-bit simt path
   is timed at an unaligned shape of the same size.
4. main path — ``BlasxContext(backend="cuda", device="cuda")`` runs the
   paper's Fig. 7/10 regime (N=16384, tile 1024, 2 simulated devices)
   for DGEMM, SGEMM and a bf16 GEMM, an f16 GEMM at N=8192, SYRK/SYMM/
   TRMM/TRSM at N=8192 in f32 and a 2-device threads-mode DGEMM at
   N=4096, each checked against an f64 oracle on the card, with the
   kernel's launch counter held against the ledger; every bf16/f16
   launch must take the wgmma path and every f64 launch the dmma path
   (``LAUNCHES_BY_PATH``).
5. epilogue — the same GEMM kernel with a bias row and each activation
   (the reference's fused epilogue) against its plain version in f32,
   bf16 and f16, at the MLP's shape (M,K,N) = (1024,1024,3072) (the
   wgmma path in 16 bits) and ragged shapes (simt); timed in bf16 at
   the MLP shape beside its bound and ``torch.addmm`` plus the
   activation (a yardstick only), by CUDA events, and for information
   by the device time ``torch.profiler`` records (these calls are about
   as short as their host side, which the events include).
6. attention — the flash-attention kernel against its plain version on
   the reference's test cases, the serving path's prefill shape (B=1,
   S=1024, H=16, Hkv=8, D=128) and the tensor-core path's hazards (D = 8
   and 16, Sq = 1, Sk = 65, non-causal Sq != Sk, a bhsd view), in f32
   (max abs) and bf16/f16 (max abs and normwise), on the path
   ``flash_path`` names (mma for aligned 16-bit operands, simt for f32
   and a 16-bit seq stride off a multiple of 8), each launch checked in
   ``LAUNCHES_BY_PATH``; timed at the prefill shape on each
   (path, dtype) beside its bound and ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it), by CUDA events and by the
   device time ``torch.profiler`` records.
7. serve — ``repro_torch.launch.serve.run`` at Qwen3-0.6B's full width in
   bf16 (random weights from a seed): 16 requests of 1024-token prompts,
   32 new tokens each, 8 slots.  Checks every request and token, every
   logit finite, the flash kernel launched once per layer and prefill
   (28 x 16), every launch bf16 on the mma path, and one prompt's last
   logits through the kernel against
   the plain "sdpa" attention backend on the card.

Phases 4 and 7 are the main paths: each kernel's launch count is set to
0 just before each and read just after it.  The last two lines are a
JSON object describing each kernel and then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/blasx_gemm.cu"
# the Pallas kernel it replaces: matmul_pallas, which reaches
# pl.pallas_call (body _matmul_kernel at :37, wrapper ops.matmul at
# ops.py:50, batched by pallas_backend._batched_pallas_contract at :47)
REPLACES = "src/repro/kernels/matmul.py:74"
# the epilogue variant replaces the bias body _matmul_bias_kernel
EPILOGUE_REPLACES = "src/repro/kernels/matmul.py:56"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# flash_attention_bhsd, which reaches pl.pallas_call (body _flash_kernel
# at :29, layout wrapper flash_attention at :132)
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:78"
SOURCES = ("blasx_gemm", "flash_attention")

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
# epilogue vs plain version, normwise: the GEMM's tolerances
EPI_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
EPI_MAIN = (1024, 1024, 3072)   # Qwen3-0.6B's MLP up/gate projection
EPI_SHAPES = [EPI_MAIN, (100, 70, 130), (1, 200, 300), (513, 129, 257)]
ACTIVATIONS = (None, "relu", "gelu", "silu", "tanh")
# flash vs plain version, max abs: the reference's test tolerances
# (f32 sums in another order; bf16 rounds the output to 8 bits); f16 is
# held to bf16's limits, which its longer mantissa makes stricter for it
FLASH_TOL = {"float32": 2e-5, "bfloat16": 5e-2, "float16": 5e-2}
# 16-bit also normwise: at the prefill shape a typical |o| is ~0.076, so
# 5e-2 max abs is loose.  On an H100 the sound kernel read <= 4.5e-5 and
# the subtlest fault planted by tools/flash_fault_margin.py (the output
# rounded toward zero) 3.9e-3 (PERF.md); P rounded once to bf16 before
# PV (the FA-2/3 shortcut) reads ~2e-3 on the CPU
FLASH_NORMWISE_TOL = {"bfloat16": 1e-3, "float16": 1e-3}
FLASH_DTYPES = ("float32", "bfloat16", "float16")
# (B, Sq, Sk, H, Hkv, D, causal): test_kernels.py's FLASH_CASES, then
# the serving path's prefill shape
FLASH_MAIN = (1, 1024, 1024, 16, 8, 128, True)
FLASH_CASES = [(2, 256, 256, 4, 4, 64, True), (1, 200, 200, 4, 2, 32, True),
               (2, 128, 384, 8, 2, 64, False), (1, 130, 130, 2, 1, 16, True),
               (1, 64, 64, 1, 1, 128, True), FLASH_MAIN]
# the mma path's hazards: D = 8 and 16 across blocks, Sq = 1, one key
# past a block, non-causal Sq != Sk, causal Sq < Sk
FLASH_HAZARDS = [(2, 37, 37, 4, 2, 8, True), (2, 130, 130, 4, 1, 8, True),
                 (1, 300, 170, 4, 2, 16, True), (1, 1, 1, 4, 2, 128, True),
                 (1, 1, 200, 4, 2, 64, False), (1, 65, 65, 4, 2, 128, True),
                 (1, 100, 65, 4, 2, 32, False), (1, 70, 200, 2, 1, 64, True)]
# the serve phase: Qwen3-0.6B, 28 layers, bf16
SERVE = dict(arch="qwen3_0_6b", smoke=False, batch_slots=8, prompt_len=1024,
             max_len=1088, requests=16, max_new=32, seed=0, device="cuda")
# the reference's bf16 flash tolerance; on an H100 the sound kernel read
# 1.6e-2 and a planted 16-key drop on the last q-block 1.3e-1 (PERF.md)
SERVE_LOGIT_TOL = 5e-2
MAIN_SHAPE = (4, 16, 1024, 1024, 1024)
# the tensor-core paths' hazards: one 64-tile, ragged M/N with aligned
# strides across item boundaries, M = 1 with K = N = 8, and an uneven
# 200 x 96 x 136; then unaligned shapes (simt in 16 bits)
SHAPES = [MAIN_SHAPE, (1, 1, 64, 64, 64), (2, 3, 1000, 64, 1000),
          (1, 1, 1, 8, 8), (3, 2, 200, 96, 136), (3, 2, 1000, 997, 1003),
          (1, 1, 1024, 1024, 1024), (1, 1, 1, 7, 5), (2, 3, 65, 33, 129),
          (5, 1, 17, 300, 31), (1, 4, 128, 64, 64)]
# the 16-bit simt path timed at the runtime's size, K off the 8 TMA needs
SIMT_SHAPE = (4, 16, 1024, 1020, 1024)
DTYPES = ("float64", "float32", "bfloat16", "float16")
HALF = ("bfloat16", "float16")
# the path the BLAS main path's launches must take, by dtype
MAIN_PATH = {"float64": "dmma", "float32": "simt", "bfloat16": "wgmma",
             "float16": "wgmma"}
# profiler device times an entry may carry beside its CUDA-event times
DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")


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


def device_ms(fn, reps: int):
    """Mean device time of one call: the kernels' time that
    ``torch.profiler`` records over ``reps`` calls after one warm-up
    call, gaps between kernels excluded; None when the profile holds no
    device time.  Informational beside :func:`time_ms`, for calls about
    as short as their host side."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in _kernel_events(prof))
    return busy_us / reps / 1e3 if busy_us > 0 else None


def warm_profiler() -> None:
    """One short profiler session, so that the tracer is set up before
    any session whose numbers are kept (a first session taken after much
    unprofiled work once came back empty on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x * 2).sum().item()


def least_time(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by): the larger of the flops over the dtype's
    peak and the bytes (inputs read once, outputs written once) over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def bound(shape, dtype: str):
    """The batched GEMM's least time at (G, S, M, K, N)."""
    from repro_torch.core.dtypes import canonical_dtype
    g, s, m, k, n = shape
    itemsize = canonical_dtype(dtype).itemsize
    return least_time(2 * g * s * m * k * n,
                      (g * s * (m * k + k * n) + g * m * n) * itemsize, dtype)


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {card} | torch: {name} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    return card


def _timed_build(name):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build(name)
    return path, time.perf_counter() - t0


def _kernel_label(mangled: str) -> str:
    """``wgmma_gemm bf16 128`` from a mangled template kernel's name."""
    t = re.search(r"(batched_gemm|wgmma_gemm|dmma_gemm|flash_fwd|flash_mma)"
                  r"_kernelI"
                  r"((?:\d+\w+?|[df])?)((?:Li\d+E)+)", mangled)
    if not t:
        return mangled[:40]
    name, typ, ints = t.groups()
    typ = {"d": "f64", "f": "f32", "6__half": "f16",
           "13__nv_bfloat16": "bf16"}.get(typ, typ)
    return " ".join(x for x in (name, typ, "x".join(
        re.findall(r"Li(\d+)E", ints))) if x)


def phase_build():
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_timed_build, SOURCES))
    secs = time.perf_counter() - t0
    for path, one in built:
        print(f"[build] {path.name} in {one:.1f} s", flush=True)
        report = path.with_suffix(".ptxas.txt")
        if not report.is_file():
            continue
        fn = None
        for line in report.read_text().splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"[build] ptxas {_kernel_label(fn)}: "
                      f"{line.split(':', 1)[1].strip()}")
            if "spill" in line and not re.search(r"\b0 bytes spill stores", line):
                print(f"[build] ptxas spill: {line.strip()}")
    print(f"[build] both sources in {secs:.1f} s", flush=True)
    return secs


def phase_kernel(card: str):
    import torch
    from repro_torch.core.dtypes import accumulator_dtype, canonical_dtype
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels.matmul import batched_contract
    from repro_torch.kernels.ref import batched_contract_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}

    def operands(shape, dt):
        g, s, m, k, n = shape
        return (torch.randn((g, s, m, k), generator=gen, device="cuda",
                            dtype=torch.float32).to(dt),
                torch.randn((g, s, k, n), generator=gen, device="cuda",
                            dtype=torch.float32).to(dt))

    def timed(name, path, shape, a, b):
        """Time the kernel on every compiled block of its path (the
        default's time is the entry's), the plain version and the
        library call, at ``shape``."""
        g, s, m, k, n = shape
        flops = 2 * g * s * m * k * n
        default = kmm.default_blocks(m, n, k, a.element_size(), path)
        per_block = {}
        for blocks in kmm.compiled_blocks(path):
            if path == "simt" and blocks != default:
                continue  # simt: the default block only
            per_block[blocks] = time_ms(
                lambda: batched_contract(a, b, blocks=blocks), 20)
            print(f"[kernel] {name} {path} {shape} blocks {blocks}: "
                  f"{per_block[blocks]:.4f} ms "
                  f"({flops / per_block[blocks] / 1e9:.1f} TFLOP/s)"
                  f"{' (default)' if blocks == default else ''} | {card}",
                  flush=True)
        ms = per_block[default]
        a2 = a.transpose(1, 2).reshape(g, m, s * k).contiguous()
        b2 = b.reshape(g, s * k, n)
        plain_ms = time_ms(lambda: batched_contract_ref(a, b), 5)
        lib_ms = time_ms(lambda: torch.matmul(a2, b2), 20)
        bound_ms, bound_by = bound(shape, name)
        print(f"[kernel] {name} {path} {shape}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f}"
              f" ms, torch.matmul folded {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {PEAK_NAME[name]}) "
              f"acc {accumulator_dtype(a.dtype)} | {card}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by, shape=shape,
                    blocks={"x".join(map(str, k)): v
                            for k, v in per_block.items()})

    for name in DTYPES:
        dt = canonical_dtype(name)
        worst = {}
        for shape in SHAPES:
            g, s, m, k, n = shape
            path = kmm.kernel_path(dt, m, k, n)
            a, b = operands(shape, dt)
            got = batched_contract(a, b)
            torch.cuda.synchronize()
            want = batched_contract_ref(a, b)
            err = normwise(got, want)
            abs_err = float((got.to(torch.float64)
                             - want.to(torch.float64)).abs().max())
            print(f"[kernel] {name} {path} {shape}: normwise {err:.3e} "
                  f"max_abs {abs_err:.3e} (tol {KERNEL_TOL[name]:.0e})",
                  flush=True)
            check(err <= KERNEL_TOL[name],
                  f"kernel {name} {path} {shape} normwise {err:.3e} > "
                  f"{KERNEL_TOL[name]:.0e}")
            worst[path] = max(worst.get(path, 0.0), err)
            if name in HALF and shape in (MAIN_SHAPE, (3, 2, 1000, 997, 1003)):
                # the unrounded f32 sums (out_acc) on each 16-bit path
                wide = batched_contract(a, b, torch.float32)
                torch.cuda.synchronize()
                err = normwise(wide, batched_contract_ref(a, b,
                                                          torch.float32))
                print(f"[kernel] {name} {path} {shape} f32 out: normwise "
                      f"{err:.3e} (tol {KERNEL_TOL['float32']:.0e})",
                      flush=True)
                check(err <= KERNEL_TOL["float32"],
                      f"kernel {name} {path} {shape} f32 out normwise "
                      f"{err:.3e}")
                del wide
            if shape == MAIN_SHAPE:
                results[(name, path)] = timed(name, path, shape, a, b)
                results[(name, path)]["max_abs_err"] = abs_err
            del a, b, got, want
        if name in HALF:
            a, b = operands(SIMT_SHAPE, dt)
            g, s, m, k, n = SIMT_SHAPE
            check(kmm.kernel_path(dt, m, k, n) == "simt",
                  f"{SIMT_SHAPE} should take the simt path")
            err = normwise(batched_contract(a, b), batched_contract_ref(a, b))
            check(err <= KERNEL_TOL[name], f"kernel {name} simt "
                  f"{SIMT_SHAPE} normwise {err:.3e}")
            results[(name, "simt")] = timed(name, "simt", SIMT_SHAPE, a, b)
            got, want = batched_contract(a, b), batched_contract_ref(a, b)
            results[(name, "simt")]["max_abs_err"] = float(
                (got.double() - want.double()).abs().max())
            del a, b, got, want
        for path, w in worst.items():
            print(f"[kernel] {name} {path}: worst normwise {w:.3e} over "
                  f"its shapes", flush=True)
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


def phase_epilogue(card: str):
    """The GEMM kernel's fused epilogue (bias row + activation) against
    its plain version; timed in bf16 with bias + silu at the MLP shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = {}
    for name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, name)
        worst = 0.0
        for m, k, n in EPI_SHAPES:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
            bias = torch.randn((n,), generator=gen, device="cuda")
            for act in ACTIVATIONS:
                got = ops.matmul(a, b, bias, activation=act)
                torch.cuda.synchronize()
                want = matmul_ref(a, b, bias, act)
                err = normwise(got, want)
                check(err <= EPI_TOL[name],
                      f"epilogue {name} {(m, k, n)} {act}: normwise "
                      f"{err:.3e} > {EPI_TOL[name]:.0e}")
                worst = max(worst, err)
                if (m, k, n) == EPI_MAIN and act == "silu" and \
                        name == "bfloat16":
                    max_abs = float((got.float() - want.float()).abs().max())
                    reps = 20
                    ms = time_ms(lambda: ops.matmul(a, b, bias,
                                                    activation="silu"), reps)
                    plain_ms = time_ms(lambda: matmul_ref(a, b, bias, "silu"),
                                       reps)
                    bias_t = bias.to(dt)
                    lib_ms = time_ms(lambda: F.silu(torch.addmm(bias_t, a, b)),
                                     reps)
                    flops = 2 * m * k * n
                    # a, b and c in bf16, the bias row in f32
                    bound_ms, bound_by = least_time(
                        flops, (m * k + k * n + m * n) * 2 + n * 4, name)
                    path = kmm.kernel_path(dt, m, k, n)
                    print(f"[epilogue] bf16 {path} {(m, k, n)} bias+silu, "
                          f"CUDA events: kernel {ms:.4f} ms "
                          f"({flops / ms / 1e9:.1f} TFLOP/s), plain "
                          f"{plain_ms:.4f} ms, torch.addmm+silu {lib_ms:.4f}"
                          f" ms, bound {bound_ms:.4f} ms ({bound_by}) | "
                          f"{card}", flush=True)
                    # the same calls' device time, gaps and host excluded
                    # (information only: the entry's times are the events')
                    dev = dict(
                        device_ms=device_ms(lambda: ops.matmul(
                            a, b, bias, activation="silu"), reps),
                        plain_device_ms=device_ms(
                            lambda: matmul_ref(a, b, bias, "silu"), reps),
                        library_device_ms=device_ms(
                            lambda: F.silu(torch.addmm(bias_t, a, b)), reps))
                    shown = {key: "not measured" if v is None
                             else f"{v:.4f} ms" for key, v in dev.items()}
                    print(f"[epilogue] bf16 {path} {(m, k, n)} bias+silu, "
                          f"device time: kernel {shown['device_ms']}, plain "
                          f"{shown['plain_device_ms']}, torch.addmm+silu "
                          f"{shown['library_device_ms']} | {card}",
                          flush=True)
                    out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               max_abs_err=max_abs, path=path, **dev)
        print(f"[epilogue] {name}: {len(EPI_SHAPES)} shapes x "
              f"{len(ACTIVATIONS)} activations, bias, worst normwise "
              f"{worst:.3e} (tol {EPI_TOL[name]:.0e})", flush=True)
    return out


def flash_bound(case, dtype: str):
    """(bound_ms, bound_by, flops) for one flash call: 4*D flops for
    every (q, k) pair the mask keeps (QK^T and PV), q, k, v read once and
    o written once."""
    b, sq, sk, h, hkv, d, causal = case
    itemsize = 4 if dtype == "float32" else 2
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * d * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * sk * hkv * d) * itemsize
    return (*least_time(flops, nbytes, dtype), flops)


def _flash_qkv(gen, case, dt, pad=0):
    """q, k, v of ``case`` in ``dt``; ``pad`` > 0 widens each seq row by
    that many elements (a seq stride off the 8 the mma path reads)."""
    import torch
    b, sq, sk, h, hkv, d, _ = case

    def one(s, heads):
        x = torch.randn((b, s, heads * d + pad), generator=gen,
                        device="cuda").to(dt)
        return x[..., :heads * d].unflatten(-1, (heads, d))
    return one(sq, h), one(sk, hkv), one(sk, hkv)


def phase_attention(card: str):
    """The flash kernel against its plain version in f32, bf16 and f16
    on the reference's cases, the mma path's hazards, a bhsd view and an
    unaligned 16-bit layout, each on the path ``flash_path`` names; timed
    at the serving path's prefill shape on each (path, dtype) beside its
    bound and SDPA (a yardstick: the port never calls it), by CUDA events
    and by profiler device time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(99)
    results = {}

    def held(label, name, path, fn, want):
        """Run ``fn()``, check its launch landed on ``path`` and its
        error; returns (max abs, normwise)."""
        before = kfa.LAUNCHES_BY_PATH.get(path, {}).get(name, 0)
        got = fn()
        torch.cuda.synchronize()
        after = kfa.LAUNCHES_BY_PATH.get(path, {}).get(name, 0)
        check(after == before + 1, f"flash {name} {label}: launch not on "
              f"the {path} path ({kfa.LAUNCHES_BY_PATH})")
        max_abs = float((got.float() - want.float()).abs().max())
        check(max_abs <= FLASH_TOL[name], f"flash {name} {path} {label}: "
              f"max abs {max_abs:.3e} > {FLASH_TOL[name]:.0e}")
        err = 0.0
        if name in FLASH_NORMWISE_TOL:
            err = normwise(got, want)
            check(err <= FLASH_NORMWISE_TOL[name],
                  f"flash {name} {path} {label}: normwise {err:.3e} > "
                  f"{FLASH_NORMWISE_TOL[name]:.0e}")
        return max_abs, err

    def timed(name, path, case, q, k, v, max_abs, err):
        b, sq, sk, h, hkv, d, causal = case
        reps = 20
        kern = lambda: kfa.flash_attention(q, k, v, causal=causal)
        ms = time_ms(kern, reps)
        plain = lambda: flash_attention_ref(q, k, v, causal=causal)
        plain_ms = time_ms(plain, 5)
        # SDPA wants (B, H, S, D) and as many kv heads as q heads
        g = h // hkv
        qs = q.transpose(1, 2).contiguous()
        ks = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)
        lib_ms = time_ms(sdpa, reps)
        dev = dict(device_ms=device_ms(kern, reps),
                   plain_device_ms=device_ms(plain, 5),
                   library_device_ms=device_ms(sdpa, reps))
        bound_ms, bound_by, flops = flash_bound(case, name)
        shown = {key: "not measured" if x is None else f"{x:.4f} ms"
                 for key, x in dev.items()}
        print(f"[attention] {name} {path} {case}: CUDA events: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; device time: "
              f"kernel {shown['device_ms']}, plain "
              f"{shown['plain_device_ms']}, SDPA "
              f"{shown['library_device_ms']}; bound {bound_ms:.4f} ms "
              f"({bound_by}; {PEAK_NAME[name]}); max abs {max_abs:.3e}, "
              f"normwise {err:.3e} | {card}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs,
                    **dev)

    def layouts(name, dt, worst):
        """16-bit only: the reference kernel's bhsd layout (permuted
        views, read in place: mma), then a seq stride off a multiple of 8
        (simt), checked on a hazard and timed at the prefill shape."""
        view = lambda x: x.permute(1, 0, 2)[None]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((8, 150, 64), (2, 150, 64), (2, 150, 64)))
        check(kfa.flash_path(dt, 64, view(q), view(k), view(v)) == "mma",
              "the bhsd views should take mma")
        want = flash_attention_ref(view(q), view(k), view(v))[0]
        w = held("bhsd (8,150,64)/(2,150,64)", name, "mma",
                 lambda: kfa.flash_attention_bhsd(q, k, v),
                 want.permute(1, 0, 2))
        worst["mma"] = tuple(map(max, zip(worst["mma"], w)))
        for case in ((1, 200, 200, 4, 2, 64, True), FLASH_MAIN):
            q, k, v = _flash_qkv(gen, case, dt, pad=1)
            check(kfa.flash_path(dt, case[5], q, k, v) == "simt",
                  f"{case} with a ragged seq stride should take simt")
            want = flash_attention_ref(q, k, v, causal=case[6])
            w = held(f"{case} seq stride {q.stride(1)}", name, "simt",
                     lambda: kfa.flash_attention(q, k, v, causal=case[6]),
                     want)
            worst["simt"] = tuple(map(max, zip(worst.get("simt", (0, 0)),
                                               w)))
            if case == FLASH_MAIN:
                results[(name, "simt")] = timed(name, "simt", case, q, k, v,
                                                *w)

    for name in FLASH_DTYPES:
        dt = getattr(torch, name)
        worst = {}
        for case in FLASH_CASES + FLASH_HAZARDS:
            causal, d = case[6], case[5]
            q, k, v = _flash_qkv(gen, case, dt)
            path = kfa.flash_path(dt, d, q, k, v)
            check(path == ("simt" if name == "float32" else "mma"),
                  f"flash {name} {case} takes {path}")
            want = flash_attention_ref(q, k, v, causal=causal)
            w = held(str(case), name, path, lambda: kfa.flash_attention(
                q, k, v, causal=causal), want)
            worst[path] = tuple(map(max, zip(worst.get(path, (0, 0)), w)))
            if case == FLASH_MAIN:
                results[(name, path)] = timed(name, path, case, q, k, v, *w)
            del q, k, v, want
        if name != "float32":
            layouts(name, dt, worst)
        for path, (max_abs, err) in sorted(worst.items()):
            nw = (f", worst normwise {err:.3e} (tol "
                  f"{FLASH_NORMWISE_TOL[name]:.0e})"
                  if name in FLASH_NORMWISE_TOL else "")
            print(f"[attention] {name} {path}: worst max abs {max_abs:.3e} "
                  f"(tol {FLASH_TOL[name]:.0e}){nw}", flush=True)
    return results


def phase_serve(card: str):
    """The serving main path at Qwen3-0.6B's full width, bf16, on the
    card; its flash launches counted from 0 around ``run``.  Returns the
    kernels' launch counts by name."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, run
    from repro_torch.models import Model
    from repro_torch.models import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(SERVE["arch"])
    check(attn.ATTENTION_BACKEND == "flash", "the default backend is flash")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = run(ServeConfig(**SERVE))
    torch.cuda.synchronize()
    launches = _read_counts()
    n_tok = SERVE["requests"] * SERVE["max_new"]
    print(f"[serve] {cfg.name} {cfg.dtype} x{cfg.n_layers} layers: "
          f"{out['requests']} requests, {out['tokens']} tokens, "
          f"{out['steps']} decode steps in {out['wall_s']:.3f} s wall "
          f"(prefill {out['prefill_s']:.3f} s, decode {out['decode_s']:.3f}"
          f" s, {out['tok_per_s']:.1f} tok/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
          f"launches {launches['flash_path']} | {card}", flush=True)
    check(out["device"].startswith("cuda"), f"served on {out['device']}")
    check(out["requests"] == SERVE["requests"], "not every request finished")
    check(out["tokens"] == n_tok and all(
        len(t) == SERVE["max_new"] for t in out["outputs"].values()),
        f"{out['tokens']} tokens, want {n_tok}")
    check(out["nonfinite_logits"] == 0,
          f"{out['nonfinite_logits']} prefills/steps had non-finite logits")
    want = cfg.n_layers * SERVE["requests"]
    check(launches["flash_path"] == {"mma": {"bfloat16": want}},
          f"flash launches {launches['flash_path']}, want {want} bf16 on "
          f"the mma path (layers x prefills)")

    # one prompt's last logits through the kernel against the plain
    # "sdpa" backend, on the same weights (same seed) on the card
    model = Model(cfg)
    params = model.init(SERVE["seed"], device="cuda")
    rng = np.random.default_rng(SERVE["seed"])
    prompt = rng.integers(0, cfg.vocab_size, (SERVE["prompt_len"],))
    tokens = torch.from_numpy(prompt[None]).to(params["embed"].device)
    logits = {}
    try:
        for backend in ("flash", "sdpa"):
            attn.ATTENTION_BACKEND = backend
            logits[backend], _ = model.prefill(params, tokens=tokens)
    finally:
        attn.ATTENTION_BACKEND = "flash"
    err = normwise(logits["flash"], logits["sdpa"])
    same = int(torch.argmax(logits["flash"])) == int(
        torch.argmax(logits["sdpa"]))
    print(f"[serve] prefill logits, flash vs sdpa backend: normwise "
          f"{err:.3e} (tol {SERVE_LOGIT_TOL:.0e}), same greedy token "
          f"{same}; first request's greedy token {out['outputs'][0][0]}",
          flush=True)
    check(bool(torch.isfinite(logits["flash"]).all()), "non-finite logits")
    check(err <= SERVE_LOGIT_TOL,
          f"flash vs sdpa logits normwise {err:.3e} > {SERVE_LOGIT_TOL:.0e}")
    profile_serving(card, model, params, tokens)
    del model, params
    return out, launches


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def _kernel_events(prof):
    """The profile's device-side events (kernels, copies) with device
    time.  A host-side op carries its kernels' time too, so summing
    every event would count each kernel twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]


def profile_serving(card: str, model, params, tokens):
    """Where one prefill and one 8-slot decode step spend the card's
    time: ``torch.profiler`` over each, device time by kernel, and the
    device's busy share of the host-clock wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, cache = model.prefill(params, tokens=tokens)
    cache = model.pad_cache(cache, SERVE["max_len"])
    slots = SERVE["batch_slots"]
    cache = {"blocks": {k: torch.repeat_interleave(a, slots, dim=1)
                        for k, a in cache["blocks"].items()}}
    tok = tokens[0, -slots:].clone()
    pos = torch.full((slots,), SERVE["prompt_len"], dtype=torch.int64,
                     device=tokens.device)
    runs = {"prefill": lambda: model.prefill(params, tokens=tokens),
            "decode step": lambda: model.decode(params, cache, tok, pos)}
    for label, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _kernel_events(prof)
        busy_us = sum(_device_us(e) for e in events)
        if busy_us == 0:
            print(f"[profile] {label}: the profiler saw no device time; "
                  f"device busy share not measured | {card}", flush=True)
            continue
        top = sorted(events, key=_device_us, reverse=True)[:6]
        print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device busy "
              f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
              f"{sum(e.count for e in events)} device ops | {card}",
              flush=True)
        for e in top:
            print(f"[profile]   {_device_us(e) / 1e3:8.3f} ms "
                  f"{100 * _device_us(e) / busy_us:5.1f}% x{e.count:<5d} "
                  f"{e.key[:90]}", flush=True)


def _reset_counts():
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    kmm.LAUNCHES = 0
    kmm.LAUNCHES_BY_DTYPE.clear()
    kmm.LAUNCHES_BY_PATH.clear()
    kmm.LAUNCHES_EPILOGUE = 0
    kfa.LAUNCHES = 0
    kfa.LAUNCHES_BY_DTYPE.clear()
    kfa.LAUNCHES_BY_PATH.clear()


def _read_counts():
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    return {"gemm": dict(kmm.LAUNCHES_BY_DTYPE),
            "gemm_path": {p: dict(d) for p, d in kmm.LAUNCHES_BY_PATH.items()},
            "epilogue": kmm.LAUNCHES_EPILOGUE,
            "flash_path": {p: dict(d)
                           for p, d in kfa.LAUNCHES_BY_PATH.items()}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    warm_profiler()
    build_s = phase_build()
    kern = phase_kernel(card)
    epi = phase_epilogue(card)
    flash = phase_attention(card)
    # main path 1, the BLAS library: the counts start at 0; the
    # comparison phases' launches do not count
    _reset_counts()
    phase_main_path(card, 16384)
    blas = _read_counts()
    print(f"[main] GEMM launches by path: {blas['gemm_path']} | {card}",
          flush=True)
    for name in DTYPES:
        n = blas["gemm"].get(name, 0)
        check(n > 0, f"kernel for {name} never launched on the BLAS main path")
        on_path = blas["gemm_path"].get(MAIN_PATH[name], {}).get(name, 0)
        check(on_path == n, f"{name}: {on_path} of {n} BLAS main-path "
              f"launches took the {MAIN_PATH[name]} path")
    # main path 2, serving (counted from 0 inside)
    _, serve = phase_serve(card)
    print(f"[done] build {build_s:.1f} s, total "
          f"{time.perf_counter() - t_start:.1f} s | {card}")

    def launches(path, name):
        return sum(run["gemm_path"].get(path, {}).get(name, 0)
                   for run in (blas, serve))

    def entry(name, path, source, replaces, launches, r):
        e = {"name": name, "route": "cuda", "path": path,
             "source": source, "replaces": replaces, "launches": launches,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        e.update({k: r[k] for k in DEVICE_KEYS if k in r})
        return e

    # one GEMM entry per path and dtype; the simt path (the kernel of
    # PR 11) keeps its entries' names, the tensor-core paths add theirs
    kernels = [entry(f"blasx_batched_gemm<{name}>" if path == "simt"
                     else f"blasx_batched_gemm<{name},{path}>", path,
                     KERNEL_SOURCE, REPLACES, launches(path, name),
                     kern[(name, path)]) for name, path in kern]
    kernels.append(entry("blasx_gemm_epilogue<bfloat16>", epi["path"],
                         KERNEL_SOURCE, EPILOGUE_REPLACES,
                         blas["epilogue"] + serve["epilogue"], epi))
    # one flash entry per path and dtype; the simt entries keep their
    # earlier names, the mma path adds its own
    kernels += [entry(f"flash_attention<{name}>" if path == "simt"
                      else f"flash_attention<{name},{path}>", path,
                      FLASH_SOURCE, FLASH_REPLACES,
                      sum(run["flash_path"].get(path, {}).get(name, 0)
                          for run in (blas, serve)), flash[(name, path)])
                 for name, path in flash]
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
