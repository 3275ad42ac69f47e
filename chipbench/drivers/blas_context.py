"""Driver: GEMMs through the port's ``BlasxContext`` on one card.

One caller in a closed loop calls ``ctx.gemm`` back to back on one
persistent context.  The traffic mix says where the operands live:

  ``"operands": "host"``      raw pageable host tensors every call (the
                              CBLAS caller): every tile crosses the bus
  ``"operands": "resident"``  handles tiled once (``ctx.tile``) and warmed,
                              so the tile cache serves every operand

Call i multiplies A by B_(i mod b_operands).  A and the Bs are made on
the card from the seed in the configuration's dtype and moved to host
memory.  A sample of the outputs, drawn from the seed, with the last
call's in it, is compared with the reference once the window has closed
and the context is freed.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from reference import gemm as reference  # noqa: E402
from yardstick import env, peaks  # noqa: E402
from yardstick.trace import Tracer  # noqa: E402
from yardstick.window import Reservoir, closed_loop  # noqa: E402


class Port:
    """The program: one ``BlasxContext`` kept for the whole run."""

    def __init__(self, config: dict, traffic: dict):
        from repro_torch.api import BlasxContext
        from repro_torch.core.runtime import RuntimeConfig
        self.ctx = BlasxContext(RuntimeConfig(**config["runtime"]),
                                tile=config["tile"])
        self.resident = traffic["operands"] == "resident"

    def prepare(self, a, bs) -> None:
        if self.resident:
            self.a = self.ctx.tile(a)
            self.bs = [self.ctx.tile(b) for b in bs]
        else:
            self.a, self.bs = a, list(bs)

    def call(self, i: int):
        out = self.ctx.gemm(self.a, self.bs[i % len(self.bs)])
        return out.tiled.data

    def last_h2d_bytes(self) -> int:
        return self.ctx.last_call.h2d_bytes

    def counters(self) -> dict:
        st = self.ctx.stats()
        return {"h2d_bytes": st["comm_bytes"]["h2d"],
                "d2h_bytes": st["comm_bytes"]["d2h"],
                "kernel_launches": st["launch"]["kernel_launches"]}

    def close(self) -> None:
        self.ctx.close()
        self.a = self.bs = None


class Control:
    """The reference in the program's place, computed in the next
    precision below the configuration's (``reference.lower_precision``);
    its operands are moved to the device once."""

    def __init__(self, config: dict, traffic: dict):
        import torch
        self.device = config["runtime"]["device"]
        self.dtype = getattr(torch, config["dtype"])
        self.kind = config["control"]

    def prepare(self, a, bs) -> None:
        self.a = a.to(self.device)
        self.bs = [b.to(self.device) for b in bs]

    def call(self, i: int):
        return reference.lower_precision(
            self.a, self.bs[i % len(self.bs)], self.dtype, self.kind).cpu()

    def last_h2d_bytes(self):
        return None

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.a = self.bs = None


PROGRAMS = {"port": Port, "control": Control}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def run(job) -> dict:
    import torch

    cfg, tr = job.config, job.traffic
    device = cfg["runtime"]["device"]
    cuda = device.split(":")[0] == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dtype = getattr(torch, cfg["dtype"])
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    n_b = int(tr["b_operands"])

    gen = torch.Generator(device=device).manual_seed(job.seed)
    a_dev = torch.randn((m, k), generator=gen, device=device, dtype=dtype)
    bs_dev = torch.randn((n_b, k, n), generator=gen, device=device,
                         dtype=dtype)
    a = a_dev.cpu()
    bs = [b.cpu() for b in bs_dev.unbind(0)]
    del a_dev, bs_dev

    notes = []
    if cuda and job.program == "port":
        # the program builds its GEMM library at first use; loading it
        # here times that apart (the time stays in setup_s)
        from repro_torch.kernels import build
        built = build.library_path("blasx_gemm").is_file()
        t = time.perf_counter()
        build.load("blasx_gemm")
        notes.append(("the GEMM library was already built; loaded" if built
                      else "the GEMM library was built and loaded")
                     + f" in {time.perf_counter() - t:.3f} s")
    program = PROGRAMS[job.program](cfg, tr)
    program.prepare(a, bs)

    def call(i):
        out = program.call(i)
        sync()
        return out

    for i in range(int(tr["warmup_calls"])):
        call(i)
    expect = tr.get("h2d_bytes_per_call")
    got = program.last_h2d_bytes()
    if expect == "operands" and got is not None:
        want = (m * k + k * n) * dtype.itemsize
        if got != want:
            raise RuntimeError(f"set-up: the last warm-up call moved {got} "
                               f"bytes to the card, not A and B's {want}")

    sample = Reservoir(int(tr["sample"]), job.seed)
    tracer = Tracer(device) if job.trace else None
    if tracer is not None:
        tracer.warm()
    before = program.counters()
    if tracer is None:
        opened = time.perf_counter()
        win = closed_loop(call, job.seconds,
                          keep=lambda i, out: sample.offer(i % n_b, i, out))
        summaries = None
    else:
        with tracer:
            opened = time.perf_counter()

            def traced(i):
                with tracer.span():
                    return call(i)
            win = closed_loop(traced, float("inf"),
                              keep=lambda i, out: sample.offer(
                                  i % n_b, i, out),
                              max_calls=int(tr["trace_calls"]))
        summaries = [tracer.summary()]
    counters = _delta(program.counters(), before)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    modules = env.forbidden_modules()

    held = dict(sample.items())
    held[win.calls - 1] = win.last
    win.last = None
    program.close()
    del program
    if cuda:
        torch.cuda.empty_cache()

    compared = []
    for j in range(n_b):
        idx = sorted(i for i in held if i % n_b == j)
        if not idx:
            continue
        rows = reference.compare(a, bs[j], [held[i] for i in idx], device)
        for i, row in zip(idx, rows):
            compared.append(dict(row, call=i))
    notes.append("compared calls " + ", ".join(
        str(r["call"]) for r in compared))

    itemsize = dtype.itemsize
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "chips": 1,
        "dtype": cfg["dtype"],
        "m": m, "n": n, "k": k,
        "flops_per_call": peaks.gemm_flops(m, n, k),
        "bytes_per_call": peaks.gemm_bytes(m, n, k, itemsize),
        "local_flops_per_call": peaks.gemm_flops(m, n, k),
        "local_bytes_per_call": peaks.gemm_bytes(m, n, k, itemsize),
        "calls": win.calls,
        "window_s": win.window_s,
        "latencies_s": win.latencies_s,
        "setup_s": opened - job.t0,
        "peak_bytes": peak,
        "counters": counters,
        "trace": summaries,
        "compared": compared,
        "modules": modules,
        "notes": notes,
    }
