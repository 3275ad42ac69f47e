#!/usr/bin/env python3
"""Time f32 simt flash blocks and thread counts the library does not compile.

Run from the root of the repository, on a machine with an NVIDIA card:

    python3 tools/flash_simt_sweep.py

The f32 simt path of ``kernels/csrc/flash_attention.cu`` is compiled for
the blocks of its ``FLASH_SIMT_BLOCKS`` table only, at ``kSimtThreads``
threads a block.  This script builds copies of that source (under
``build/flash_sweep/``, never the library the port loads), one for each
thread count of ``THREADS`` (one nvcc each, all started together), whose
table holds every block of ``BLOCKS`` at the one head dim it times, and
times every (threads, block),
each with each q-tile's keys split over two blocks and without, at the
serving prefill's shape (B 1, S 1024, H 16, Hkv 8, D 128, causal)
through the library's own C entry.  Each is held against the
plain version (max abs 2e-5, the reference's f32 limit) before it is
timed, by CUDA events over 20 calls after a warm-up, beside SDPA in f32
(a yardstick: the port never calls it).  ptxas's registers, shared
memory and spills for each simt instantiation are printed.  The last
line is a JSON object of every reading.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

THREADS = (128, 256)
BLOCKS = ((64, 32), (64, 64), (128, 32))
CASE = (1, 1024, 1024, 16, 8, 128, True)  # (B, Sq, Sk, H, Hkv, D, causal)
TOL = 2e-5
OUT_DIR = ROOT / "build" / "flash_sweep"

_TABLE = re.compile(r"#define FLASH_SIMT_BLOCKS\(X\) [^\n]*\n")
_DIMS = re.compile(r"#define FLASH_HEAD_DIMS\(X\) [^\n]*\n")
_THREADS = re.compile(r"constexpr int kSimtThreads = \d+;")


def with_table(source: str, threads: int, blocks, d: int) -> str:
    """``source`` with its simt table replaced by ``blocks``, its head
    dims by ``d`` alone and its simt block of ``threads`` threads."""
    if any(len(x.findall(source)) != 1 for x in (_TABLE, _DIMS, _THREADS)):
        raise ValueError("flash_attention.cu's simt table, head dims or "
                         "thread count moved: update "
                         "tools/flash_simt_sweep.py")
    table = " ".join(f"X({bq}, {bk})" for bq, bk in blocks)
    source = _TABLE.sub(f"#define FLASH_SIMT_BLOCKS(X) {table}\n", source)
    source = _DIMS.sub(f"#define FLASH_HEAD_DIMS(X) X({d})\n", source)
    return _THREADS.sub(f"constexpr int kSimtThreads = {threads};", source)


def build_one(threads: int):
    """Compile the source at ``threads``; (its library, ptxas's lines by
    (D, BQ, BK) of each simt instantiation)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"flash_attention_{threads}.cu"
    src.write_text(with_table(
        (build.CSRC / "flash_attention.cu").read_text(), threads, BLOCKS,
        CASE[5]))
    lib = OUT_DIR / f"libflash_attention_{threads}.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({threads} threads):\n{proc.stderr}")
    report, fn = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"entry function '([^']+)'|properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
        m = re.search(r"flash_simt_kernelILi(\d+)ELi(\d+)ELi(\d+)E", fn or "")
        if m and ("registers" in line or "stack frame" in line):
            report.setdefault(tuple(map(int, m.groups())), []).append(
                line.split(":", 1)[-1].strip())
    return ctypes.CDLL(str(lib)), report


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import flash_attention_ref

    if not torch.cuda.is_available():
        print("flash_simt_sweep: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(THREADS)) as pool:
        built = dict(zip(THREADS, pool.map(build_one, THREADS)))
    for threads, (_, report) in built.items():
        for (d, bq, bk), lines in sorted(report.items()):
            print(f"[ptxas] flash_simt {threads} threads D {d} {bq}x{bk}: "
                  f"{'; '.join(lines)}")

    b, sq, sk, h, hkv, d, causal = CASE
    gen = torch.Generator(device="cuda").manual_seed(99)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
    k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda")
    v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda")
    want = flash_attention_ref(q, k, v, causal=causal)
    o = torch.empty_like(q)
    strides = [x.stride(i) if x.shape[i] > 1 else 0
               for x in (q, k, v, o) for i in range(3)]
    stream = torch.cuda.current_stream().cuda_stream

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

    def workspace(bq, split):
        """The split's partials and finish counts (the kernel sets each
        count back to 0), or none."""
        if not split:
            return None, None
        tiles = b * h * -(-sq // bq)
        return (torch.empty(2 * tiles * bq * (d + 2), device="cuda"),
                torch.zeros(tiles, device="cuda", dtype=torch.int32))

    readings = {"card": card, "case": list(CASE), "blocks": {}}
    for threads, (lib, report) in built.items():
        fn = lib.flash_attention_fwd
        fn.argtypes = kfa._entry().argtypes
        fn.restype = ctypes.c_int
        for (bq, bk), split in itertools.product(BLOCKS, (False, True)):
            ws, counts = workspace(bq, split)
            ptrs = [None if x is None else x.data_ptr() for x in (ws, counts)]

            def call():
                rc = fn(kfa.PATH_CODES["simt"], 1, d, bq, bk, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), o.data_ptr(), *ptrs, b,
                        h, hkv, sq, sk, d ** -0.5, int(causal), *strides,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
            o.zero_()
            call()
            torch.cuda.synchronize()
            err = float((o - want).abs().max())
            label = f"{threads} {bq}x{bk}{' split' if split else ''}"
            if err > TOL:
                raise RuntimeError(f"{label}: max abs {err:.3e} > {TOL:.0e}")
            ms = time_ms(call)
            readings["blocks"][label] = {
                "ms": ms, "max_abs": err,
                "ptxas": report.get((d, bq, bk), [])}
            print(f"[sweep] f32 simt {threads} threads block {bq}x{bk}"
                  f"{', keys split' if split else ''} {CASE}: {ms:.4f} ms, "
                  f"max abs {err:.3e} | {card}", flush=True)
    g = h // hkv
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    readings["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal))
    print(f"[sweep] SDPA f32 {CASE}: {readings['sdpa_ms']:.4f} ms | {card}")
    print(card)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
