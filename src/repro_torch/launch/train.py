"""End-to-end training driver with fault tolerance.

The counterpart of the reference's ``launch/train.py``:
  * checkpoint every K steps (atomic, retained, optionally async)
  * auto-resume from the latest checkpoint (restart-exact data stream)
  * preemption handling: SIGTERM/SIGINT trigger save-then-exit
  * crash retry: a failing step rolls back to the last checkpoint
  * elastic restore: the rank count may differ from save time
  * per-step metrics + straggler watchdog (flags slow steps)

With ``use_mesh`` every rank of the process group runs this loop (one
process a rank, e.g. under ``torchrun``); each data rank takes its
slice of the global batch that ``batch_at_step`` draws from the seed and
the step, and the train step averages the gradients over the data ranks.
Under the mesh every rank holds its blocks of the parameters, gradients
and AdamW moments at the reference's placements (FSDP on "data",
tensor-parallel on "model"); a checkpoint holds the whole arrays, so a
run resumes on any mesh.  Parameters and state live on ``device``: the
card unless the caller asks for the CPU.  As the reference's ``run``
donates its tree to the jitted step, the loop's step updates the
parameters and moments in the tensors that hold them
(``make_train_step(..., donate=True)``): a step holds no second copy of
them, and a checkpoint copies what it saves before the next step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --smoke --steps 30 --seq-len 32 --global-batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --smoke --steps 50 --ckpt-dir ckpt               # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..checkpoint.checkpointer import placing
from ..configs import get_config
from ..data import DataConfig, batch_at_step
from ..models.sharding import NO_MESH, rules_for_mesh
from ..optim import adamw
from .mesh import make_mesh_for_devices
from .steps import data_parallel, make_train_step


@dataclasses.dataclass
class TrainConfig:
    arch: str = "qwen3_0_6b"
    smoke: bool = True              # use the reduced config
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    ckpt_async: bool = False        # one rank only: a mesh saves blocking
    seed: int = 0
    lr: float = 3e-4
    use_mesh: bool = False          # data-parallel over the process group
    model_parallel: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0   # step slower than 3x median -> flag
    device: str = "cuda"


def _batch_rows(rules, global_batch: int) -> slice:
    """This rank's rows of the global batch: its slice along the batch
    axes when they split it, else all of it."""
    if not data_parallel(rules, global_batch):
        return slice(None)
    index = 0
    for ax in rules.batch_axes:
        index = index * rules.axis_size(ax) + rules.coordinate(ax)
    rows = global_batch // rules.axis_size(rules.batch_axes)
    return slice(index * rows, (index + 1) * rows)


def _any_rank(flag: bool, device) -> bool:
    """``flag`` of any rank of the default group, alike on every rank."""
    t = torch.tensor([int(flag)], device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def run(tc: TrainConfig) -> dict:
    if tc.use_mesh and tc.ckpt_async:
        raise ValueError("ckpt_async does not apply under a mesh: every "
                         "rank gathers a placed save, which is blocking")
    cfg = get_config(tc.arch)
    if tc.smoke:
        cfg = cfg.reduced()
    mesh = make_mesh_for_devices(model_parallel=tc.model_parallel,
                                 device=tc.device) if tc.use_mesh else None
    rules = rules_for_mesh(mesh) if mesh is not None else NO_MESH

    opt_cfg = adamw.AdamWConfig(lr=tc.lr, total_steps=tc.steps,
                                warmup_steps=max(1, tc.steps // 10))
    step_fn, model = make_train_step(cfg, rules, opt_cfg, donate=True)

    params = model.init(tc.seed, device=tc.device)
    opt_state = adamw.init_state(params)
    # where each leaf of the checkpointed tree is held (None: whole)
    places = (None if mesh is None else
              {"params": model.placements(),
               "opt": adamw.state_placements(model.placements())})
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                    global_batch=tc.global_batch, seed=tc.seed)
    rows = _batch_rows(rules, tc.global_batch)

    start_step = 0
    ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None

    def restore_latest():
        like = {"params": params, "opt": opt_state}
        return ckpt.restore_latest(like, sharding_fn=None if places is None
                                   else placing(like, places))

    if ckpt is not None:
        latest = restore_latest()
        if latest is not None:
            start_step, tree, extra = latest
            params, opt_state = tree["params"], tree["opt"]
            print(f"[train] resumed from step {start_step}")

    # ---- preemption: save on SIGTERM/SIGINT then exit cleanly
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
    old_term = signal.signal(signal.SIGTERM, _on_signal)
    old_int = signal.signal(signal.SIGINT, _on_signal)

    losses, step_times = [], []
    last_good = start_step
    step = start_step
    try:
        while step < tc.steps:
            t0 = time.perf_counter()
            batch_np = batch_at_step(dc, step,
                                     frontend_dim=cfg.d_model
                                     if cfg.frontend else None)
            batch = {k: torch.from_numpy(v[rows]).to(tc.device)
                     for k, v in batch_np.items()
                     if k in ("tokens", "labels", "embeds")}
            if cfg.family == "encdec":
                enc = np.random.default_rng(step).standard_normal(
                    (tc.global_batch, tc.seq_len, cfg.d_model)
                ).astype(np.float32)
                batch["enc_embeds"] = torch.from_numpy(enc[rows]).to(
                    tc.device)
            try:
                params, opt_state, metrics = step_fn(
                    params, opt_state, batch, global_batch=tc.global_batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except (FloatingPointError, RuntimeError) as e:
                # crash retry: roll back to the last checkpoint (the
                # donated tree may hold the failed step's update; the
                # restore reads only its leaves' shapes, dtypes, devices)
                if ckpt is None or ckpt.latest_step() is None:
                    raise
                print(f"[train] step {step} failed ({e}); rolling back")
                s, tree, _ = restore_latest()
                params, opt_state = tree["params"], tree["opt"]
                step = s
                continue

            dt = time.perf_counter() - t0
            losses.append(loss)
            step_times.append(dt)
            if len(step_times) > 8:
                med = float(np.median(step_times[-50:]))
                if dt > tc.straggler_factor * med:
                    print(f"[train] WARNING straggler step {step}: "
                          f"{dt:.2f}s vs median {med:.2f}s")
            step += 1
            if tc.log_every and step % tc.log_every == 0:
                print(f"[train] step {step:5d} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"{dt*1e3:.0f}ms")
            # under the mesh every rank gathers and the first one writes
            if ckpt is not None and step % tc.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          extra={"loss": loss}, blocking=not tc.ckpt_async,
                          placements=places)
                last_good = step
            # under the mesh a signal to any rank stops every rank at
            # this step, for the save's gathers are collectives
            stop = preempted["flag"]
            if mesh is not None:
                stop = _any_rank(stop, tc.device)
            if stop:
                print(f"[train] preemption signal: saving at step {step}")
                if ckpt is not None:
                    ckpt.save(step, {"params": params, "opt": opt_state},
                              extra={"preempted": True}, placements=places)
                break
    finally:
        if ckpt is not None:
            ckpt.wait()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)

    return {"final_step": step, "losses": losses,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "last_ckpt": last_good, "step_times": step_times}


def main(argv=None):
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default)
                            if f.default is not None else str,
                            default=f.default)
    args = ap.parse_args(argv)
    tc = TrainConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(TrainConfig)})
    out = run(tc)
    print(f"[train] done: loss {out['first_loss']:.4f} -> "
          f"{out['last_loss']:.4f} over {out['final_step']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
