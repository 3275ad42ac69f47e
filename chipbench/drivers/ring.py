"""Driver: the port's ring GEMM over the cards of one host.

``run`` starts one process a card (``torch.distributed``: NCCL on the
cards, gloo on the CPU; the rendezvous is a ``file://`` store in a
fresh directory under ``TMPDIR``), waits for them and returns rank 0's
observation.  Each rank makes the full A and B from the seed, the same
on every rank, joins a (data, model) mesh and calls
``repro_torch.core.distributed.distributed_gemm`` back to back; every
call returns the full C on every rank and ends in a synchronise.  After
each call a rank posts over a gloo group, without waiting, whether its
window is over, and reads the ranks' posts of the call before, so all
make the same number of calls and no call waits on the host of another.
The outputs compared on each rank, once the window has closed, are the
last call's and a sample of calls drawn from the seed before the window
opens; a sampled output is copied to pinned host memory at once, so the
harness holds no output on the card beyond the program's own.

CPU rehearsal through gloo at a tiny size (host-clock counts and the
comparison only; no number from it is a device metric):

  python3 chipbench/drivers/ring.py --rehearse --ranks 4 --n 128
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from reference import gemm as reference  # noqa: E402
from yardstick import env, peaks  # noqa: E402
from yardstick.cell import Job  # noqa: E402
from yardstick.trace import Tracer  # noqa: E402
from yardstick.window import closed_loop, drawn_calls  # noqa: E402

# a run ends within 360 s; the ranks get this long from their start
RANKS_TIMEOUT_S = 320


class Port:
    """The program: ``distributed_gemm`` on the mesh."""

    def __init__(self, config: dict, mesh):
        from repro_torch.core import distributed
        self.dist = distributed
        self.mesh = mesh
        self.mode = config["mode"]

    def call(self, a, b):
        return self.dist.distributed_gemm(a, b, self.mesh, mode=self.mode)

    def counters(self) -> dict:
        return dict(self.dist.COLLECTIVES)

    def reset(self) -> None:
        self.dist.reset_collectives()


class Control:
    """The reference in the program's place, in the next precision
    below the configuration's (``reference.lower_precision``)."""

    def __init__(self, config: dict, mesh):
        import torch
        self.dtype = getattr(torch, config["dtype"])
        self.kind = config["control"]

    def call(self, a, b):
        return reference.lower_precision(a, b, self.dtype, self.kind)

    def counters(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


PROGRAMS = {"port": Port, "control": Control}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def rank_run(job: Job, rank: int, store: str):
    """One rank's part of a run; rank 0 returns the observation."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import (init_process_group,
                                         make_mesh_for_devices)

    cfg, tr = job.config, job.traffic
    device = cfg["device"]
    cuda = device == "cuda"
    world = int(job.cell["chips"])
    if cuda:
        # the configuration states float32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
    init_process_group(device, init_method=store, rank=rank,
                       world_size=world)
    try:
        gloo = dist.new_group(backend="gloo")
        mesh = make_mesh_for_devices(world, cfg["mesh"]["model"],
                                     device=device)
        dtype = getattr(torch, cfg["dtype"])
        m, n, k = cfg["m"], cfg["n"], cfg["k"]
        gen = torch.Generator(device=device).manual_seed(job.seed)
        a = torch.randn((m, k), generator=gen, device=device, dtype=dtype)
        b = torch.randn((k, n), generator=gen, device=device, dtype=dtype)
        program = PROGRAMS[job.program](cfg, mesh)
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def call(i):
            c = program.call(a, b)
            sync()
            return c

        for i in range(int(tr["warmup_calls"])):
            t = time.perf_counter()
            call(i)
            last_s = time.perf_counter() - t
        # the sample is drawn before the window, from the calls that fit
        # into it at twice the slowest rank's last warm-up call
        slow = torch.tensor([last_s], dtype=torch.float64)
        dist.all_reduce(slow, op=dist.ReduceOp.MAX, group=gloo)
        trace_calls = int(tr["trace_calls"])
        fits = (trace_calls - 1 if job.trace
                else int(job.seconds / (2 * float(slow[0]))))
        drawn = set(drawn_calls(job.seed, int(tr["sample"]), fits))
        # traced runs hold a sample on the card, so that no copy of the
        # harness's lies in the trace; others copy it to the host
        host = {i: torch.empty((m, n), dtype=dtype, pin_memory=cuda)
                for i in drawn} if not job.trace else {}
        held = {}

        def keep(i, c):
            if i in drawn:
                held[i] = host[i].copy_(c) if host else c

        def agree(wish: bool):
            flag = torch.tensor([int(wish)], dtype=torch.int32)
            work = dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=gloo,
                                   async_op=True)

            def decided() -> bool:
                work.wait()
                return bool(flag[0])
            return decided

        tracer = Tracer(device) if job.trace else None
        if tracer is not None:
            tracer.warm()
        program.reset()
        before = program.counters()
        dist.barrier(group=gloo)
        if tracer is None:
            opened = time.perf_counter()
            win = closed_loop(call, job.seconds, agree=agree, keep=keep)
            summary = None
        else:
            # every rank stops after trace_calls: no agreement needed
            with tracer:
                opened = time.perf_counter()

                def traced(i):
                    with tracer.span():
                        return call(i)
                win = closed_loop(traced, float("inf"), keep=keep,
                                  max_calls=trace_calls)
            summary = tracer.summary()
        counters = _delta(program.counters(), before)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        modules = env.forbidden_modules()

        held[win.calls - 1] = win.last
        win.last = None
        del program
        if cuda:
            torch.cuda.empty_cache()
        idx = sorted(held)
        rows = reference.compare(a, b, [held[i] for i in idx], device)
        del held, host
        mine = {"rank": rank, "peak_bytes": peak, "modules": modules,
                "drawn": sorted(drawn),
                "compared": [dict(r, call=i, rank=rank)
                             for i, r in zip(idx, rows)],
                "summary": summary, "calls": win.calls,
                "window_s": win.window_s, "latencies_s": win.latencies_s,
                "counters": counters, "opened": opened}
        every = [None] * world
        dist.all_gather_object(every, mine, group=gloo)
        if rank != 0:
            return None
        kind = torch.cuda.get_device_name() if cuda else "cpu"
    finally:
        dist.destroy_process_group()

    r0 = every[0]
    itemsize = dtype.itemsize
    notes = [f"rank {r['rank']}: {r['calls']} calls in {r['window_s']:.6f} s,"
             f" peak {r['peak_bytes']} bytes, collectives {r['counters']},"
             f" sample drawn {r['drawn']}" for r in every]
    notes.append("compared calls " + ", ".join(
        f"{r['call']}@{r['rank']}" for e in every for r in e["compared"]))
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": kind,
        "chips": world,
        "dtype": cfg["dtype"],
        "m": m, "n": n, "k": k,
        "flops_per_call": peaks.gemm_flops(m, n, k),
        "bytes_per_call": peaks.gemm_bytes(m, n, k, itemsize),
        # one rank's products: its K-block of every row block
        "local_flops_per_call": peaks.gemm_flops(m, n, k) // world,
        "local_bytes_per_call": (m * k // world + k // world * n
                                 + m * n) * itemsize,
        "calls": r0["calls"],
        "window_s": r0["window_s"],
        "latencies_s": r0["latencies_s"],
        "setup_s": r0["opened"] - job.t0,
        "peak_bytes": max(r["peak_bytes"] for r in every),
        "counters": r0["counters"],
        "trace": [r["summary"] for r in every] if job.trace else None,
        "compared": [row for r in every for row in r["compared"]],
        "modules": sorted({x for r in every for x in r["modules"]}),
        "notes": notes,
    }


def _tail(path: Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run(job: Job) -> dict:
    """Start the ranks, wait for every one, return rank 0's observation;
    a rank that fails stops the others."""
    world = int(job.cell["chips"])
    tmp = Path(tempfile.mkdtemp(prefix="chipbench-ring-"))
    procs = []
    try:
        (tmp / "job.json").write_text(job.to_json())
        script = job.rank_script or str(Path(__file__).resolve())
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, script, "--job", str(tmp / "job.json"),
                 "--rank", str(r), "--store", f"file://{tmp}/store",
                 "--out", str(tmp / "obs.json"), *job.rank_args],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, LOCAL_RANK=str(r))), log))
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while (any(p.poll() is None for p, _ in procs)
               and not any(p.poll() for p, _ in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        for p, log in procs:
            p.wait()
            log.close()
        rcs = [p.returncode for p, _ in procs]
        if any(rcs):
            for r in range(world):
                env.say(f"rank {r} exit {rcs[r]}:\n"
                        + _tail(tmp / f"rank{r}.log"))
            raise RuntimeError(f"ranks failed: exit codes {rcs}")
        return json.loads((tmp / "obs.json").read_text())
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args, _ = ap.parse_known_args(argv)
    job = Job.from_json(Path(args.job).read_text())
    env.prepare(BENCH_DIR.parent)
    obs = rank_run(job, args.rank, args.store)
    if obs is not None:
        tmp = Path(args.out + ".tmp")
        tmp.write_text(json.dumps(obs))
        os.replace(tmp, args.out)
    return 0


def rehearse(argv=None) -> int:
    """The ring cell's run on the CPU through gloo at a tiny size."""
    from yardstick import cell, registry
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--workload", default="ring-sgemm16k-x4")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    job = cell.plan(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        time.perf_counter(),
        overrides={"config": {"device": "cpu", "m": args.n, "n": args.n,
                              "k": args.n}})
    job.cell = dict(job.cell, chips=args.ranks)
    env.prepare(BENCH_DIR.parent)
    obs = run(job)
    limits, failed = cell.judge(obs["compared"], job.config["limits"])
    print(json.dumps({"rehearsal": "cpu, gloo; host-clock counts only",
                      "ranks": args.ranks, "n": args.n,
                      "calls": obs["calls"], "collectives": obs["counters"],
                      "compared": len(obs["compared"]), "failed": failed,
                      "limits": limits}))
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    if "--rehearse" in sys.argv[1:]:
        sys.exit(rehearse(sys.argv[1:]))
    sys.exit(rank_main(sys.argv[1:]))
