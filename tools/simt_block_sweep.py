#!/usr/bin/env python3
"""Time f32 simt blocks the GEMM library does not compile.

Run from the root of the repository, on a machine with an NVIDIA card:

    python3 tools/simt_block_sweep.py

The f32 simt path of ``kernels/csrc/blasx_gemm.cu`` is compiled for the
blocks of its ``BLASX_SIMT_BLOCKS`` table only, each at
``__launch_bounds__(256, 2)``: at most 128 registers a thread, two
blocks an SM.  This script builds a copy of that source (under
``build/simt_sweep/``, never the library the port loads) whose table is
the compiled one plus candidates, with one block an SM (at most 255
registers) for tiles larger than 128 x 128, and times every block in
both copy variants through the library's own C entry:

  * the runtime's group (G,S,M,K,N) = (4,16,1024,1024,1024) on the
    16-byte variant;
  * (4,16,1024,1020,1024) with A one element past an aligned base, on
    the 4-byte variant (``chip_smoke.py``'s SIMT_SHAPE).

Each block is held against the plain version (normwise, 1e-4) before it
is timed, by CUDA events over 20 calls after a warm-up, beside
``torch.matmul`` on the folded shape.  ptxas's registers and stack for
each instantiation are printed.  The last line is a JSON object of
every reading.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402

# (block_m, block_n, block_k, stages) tried beside the compiled table
CANDIDATES = [(128, 256, 16, 3), (128, 128, 8, 4)]
MAIN_SHAPE = (4, 16, 1024, 1024, 1024)
SIMT_SHAPE = (4, 16, 1024, 1020, 1024)
TOL = 1e-4
OUT_DIR = ROOT / "build" / "simt_sweep"

_TABLE = re.compile(r"#define BLASX_SIMT_BLOCKS\(X\)(?:[^\n]*\\\n)*[^\n]*\n")
_BOUNDS = "__launch_bounds__(kSimtThreads, 2)"


def with_blocks(source: str, blocks) -> str:
    """``source`` with its simt table replaced by ``blocks`` ((bm, bn, bk,
    stages) each) and the simt kernel's launch bounds at one block an SM
    for tiles larger than 128 x 128 (two, as compiled, for the others)."""
    if len(_TABLE.findall(source)) != 1 or source.count(_BOUNDS) != 1:
        raise ValueError("blasx_gemm.cu's simt table or launch bounds "
                         "moved: update tools/simt_block_sweep.py")
    table = " ".join(f"X({bm}, {bn}, {bk}, {st})"
                     for bm, bn, bk, st in blocks)
    source = _TABLE.sub(f"#define BLASX_SIMT_BLOCKS(X) {table}\n", source)
    return source.replace(
        _BOUNDS, "__launch_bounds__(kSimtThreads, BM * BN > 128 * 128 ? 1 : 2)")


def sweep_blocks():
    """The compiled table, then the candidates it lacks."""
    table = [(*b, st) for b, st in kmm.BLOCKS["simt"].items()]
    return table + [c for c in CANDIDATES if c not in table]


def build_sweep(blocks):
    """Compile the swept source; (its library, ptxas's lines by kernel)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "blasx_gemm_sweep.cu"
    src.write_text(with_blocks((build.CSRC / "blasx_gemm.cu").read_text(),
                               blocks))
    lib = OUT_DIR / "libblasx_gemm_sweep.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    report, fn = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"entry function '([^']+)'|properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
        m = re.search(r"sgemm_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      fn or "")
        if m and ("registers" in line or "stack frame" in line):
            report.setdefault(tuple(map(int, m.groups())), []).append(
                line.split(":", 1)[-1].strip())
    return ctypes.CDLL(str(lib)), report


def main() -> int:
    import torch
    from repro_torch.kernels.ref import batched_contract_ref

    if not torch.cuda.is_available():
        print("simt_block_sweep: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    blocks = sweep_blocks()
    lib, report = build_sweep(blocks)
    fn = lib.blasx_batched_gemm
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for key, lines in sorted(report.items()):
        print(f"[ptxas] sgemm {'x'.join(map(str, key))}: {'; '.join(lines)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def time_ms(f, reps=20):
        f()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    readings = {"card": card, "blocks": {}, "matmul_ms": {}}
    for shape, offset in ((MAIN_SHAPE, 0), (SIMT_SHAPE, 1)):
        g, s, m, k, n = shape
        buf = torch.randn(g * s * m * k + offset, generator=gen,
                          device="cuda")
        a = buf[offset:].view(g, s, m, k)
        b = torch.randn((g, s, k, n), generator=gen, device="cuda")
        vec = kmm.simt_vec(a, b)
        want = batched_contract_ref(a, b).double()
        c = torch.empty((g, m, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        variant = kmm.SIMT_COPIES[vec]
        for bm, bn, bk, st in blocks:
            def call():
                rc = fn(kmm.PATH_CODES["simt"], 1, 0, a.data_ptr(),
                        b.data_ptr(), None, 0, c.data_ptr(), g, s, m, k, n,
                        k, n, bm, bn, bk, st, vec, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
            call()
            torch.cuda.synchronize()
            err = float(torch.linalg.norm(c.double() - want)
                        / torch.linalg.norm(want))
            if err > TOL:
                raise RuntimeError(f"{(bm, bn, bk, st)} {variant}: normwise "
                                   f"{err:.3e} > {TOL:.0e}")
            ms = time_ms(call)
            key = f"{bm}x{bn}x{bk}x{st} {variant}"
            readings["blocks"][key] = {"ms": ms, "normwise": err,
                                       "shape": list(shape),
                                       "a_offset": offset}
            print(f"[sweep] f32 simt {variant} {shape} A +{offset} block "
                  f"{bm}x{bn}x{bk}, {st} stages: {ms:.4f} ms, normwise "
                  f"{err:.3e} | {card}", flush=True)
        a2 = a.transpose(1, 2).reshape(g, m, s * k).contiguous()
        b2 = b.reshape(g, s * k, n)
        lib_ms = time_ms(lambda: torch.matmul(a2, b2))
        readings["matmul_ms"][str(list(shape))] = lib_ms
        print(f"[sweep] torch.matmul folded {shape}: {lib_ms:.4f} ms | "
              f"{card}", flush=True)
        del a, b, buf, c, want, a2, b2
    print(card)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
