"""Gloo ranks in subprocesses, for the port's multi-rank twins.

``run_ranks(tmp_path, world, body)`` writes ``body`` after a prelude
that joins a gloo process group of ``world`` ranks through a
``file://`` store in ``tmp_path`` (so xdist workers never share a TCP
port), starts one ``python`` a rank, and returns each rank's stdout.
Each rank has ``RANK``, ``WORLD`` and ``OUT`` (``tmp_path``) defined,
and the group is destroyed after ``body``.  Any rank's failure, or a
rank still running after ``timeout`` seconds, fails the caller.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PRELUDE = """
import os, sys, json
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import init_process_group
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
OUT = os.environ["RANKS_OUT"]
torch.set_num_threads(1)
init_process_group("cpu", init_method=os.environ["RANKS_STORE"])
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(tmp_path: Path, world: int, body: str, timeout: int = 300,
              name: str = "ranks") -> list:
    script = tmp_path / f"{name}.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(WORLD_SIZE=str(world), RANKS_OUT=str(tmp_path),
               RANKS_STORE=f"file://{tmp_path / (name + '.store')}",
               OMP_NUM_THREADS="1")
    logs = [(tmp_path / f"{name}.{r}.out", tmp_path / f"{name}.{r}.err")
            for r in range(world)]
    procs = []
    try:
        for r, (out, err) in enumerate(logs):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script)], env=dict(env, RANK=str(r)),
                    stdout=fo, stderr=fe))
        deadline = time.monotonic() + timeout
        # a rank that fails leaves the others waiting in a collective:
        # stop at the first failure, not at the deadline
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [out.read_text() for out, _ in logs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} of {world} exited {p.returncode}\nstdout:\n"
            f"{outs[r]}\nstderr:\n{logs[r][1].read_text()[-4000:]}")
    return outs
