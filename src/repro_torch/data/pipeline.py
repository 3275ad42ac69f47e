"""Deterministic synthetic token pipeline.

A copy of the reference's ``data/pipeline.py`` (numpy only), so that the
port imports nothing of the reference; its batches are bitwise the
reference's.

Restart-exact by construction: batch(step) is a pure function of
(seed, step), so resuming from a checkpoint at step k replays the exact
remaining stream — the data-side half of fault tolerance.  Shardable:
``global_batch`` is laid out along the ("pod","data") mesh axes: each
data rank takes its rows of the same pure function's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: orderly n-gram-ish stream so the LM loss
    # actually decreases (pure uniform noise has no learnable signal)
    ngram: int = 3


def batch_at_step(cfg: DataConfig, step: int,
                  frontend_dim: Optional[int] = None) -> dict:
    """Pure function (seed, step) -> batch dict of numpy arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # structured stream: x_{t} = (a * x_{t-1} + b) mod V with per-sample
    # (a, b) — learnable first-order structure
    a = rng.integers(1, 8, (B, 1))
    b = rng.integers(0, V, (B, 1))
    x0 = rng.integers(0, V, (B, 1))
    toks = np.empty((B, S + 1), np.int32)
    toks[:, :1] = x0
    for t in range(1, S + 1):
        toks[:, t] = (a[:, 0] * toks[:, t - 1] + b[:, 0]) % V
    noise = rng.random((B, S + 1)) < 0.05
    toks = np.where(noise, rng.integers(0, V, (B, S + 1)), toks)
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if frontend_dim is not None:
        out["embeds"] = rng.standard_normal(
            (B, S, frontend_dim)).astype(np.float32)
    return out


class DataIterator:
    """Stateful wrapper with explicit step save/restore (checkpointable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 frontend_dim: Optional[int] = None):
        self.cfg = cfg
        self.step = start_step
        self.frontend_dim = frontend_dim

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = batch_at_step(self.cfg, self.step, self.frontend_dim)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
