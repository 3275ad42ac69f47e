"""Pipeline parallelism: 1F1B microbatch schedule over model stages.

The counterpart of the reference's ``launch/pipeline.py``.  Depth can be
split over the ``pod`` axis: stage s holds layers [s*L/S, (s+1)*L/S).
This module provides the schedule itself (which microbatch runs fwd/bwd
on which stage at each tick; a copy of the reference's pure-Python
schedule) plus a host-orchestrated executor that runs real stage
functions in that order, each stage's backward by autograd.

1F1B (one-forward-one-back) keeps at most ``n_stages`` microbatch
activations live per stage (vs GPipe's n_micro), with bubble fraction
(S-1)/(M+S-1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Tick:
    stage: int
    kind: str          # 'fwd' | 'bwd'
    micro: int


def schedule_1f1b(n_stages: int, n_micro: int) -> List[List[Optional[Tick]]]:
    """Per-timestep list of per-stage work items (None = bubble)."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError("need n_stages >= 1 and n_micro >= 1")
    # per-stage state machines
    next_fwd = [0] * n_stages
    next_bwd = [0] * n_stages
    fwd_ready: List[set] = [set(range(n_micro))] + \
        [set() for _ in range(n_stages - 1)]
    bwd_ready: List[set] = [set() for _ in range(n_stages - 1)] + [set()]
    in_flight = [0] * n_stages   # fwd-done-not-yet-bwd per stage
    done_bwd = 0
    ticks: List[List[Optional[Tick]]] = []
    guard = 0
    while done_bwd < n_stages * n_micro:
        guard += 1
        if guard > 10 * n_stages * (n_micro + n_stages):
            raise RuntimeError("1F1B schedule did not converge")
        row: List[Optional[Tick]] = [None] * n_stages
        fwd_emitted: List[Tuple[int, int]] = []
        bwd_emitted: List[Tuple[int, int]] = []
        for s in range(n_stages):
            warm = in_flight[s] < (n_stages - s)  # warmup depth
            m = next_bwd[s]
            can_bwd = (m < n_micro and m in (bwd_ready[s] if s < n_stages - 1
                                             else fwd_done_set(s, next_fwd)))
            # steady-state 1F1B: prefer bwd unless still warming up
            if can_bwd and not warm:
                row[s] = Tick(s, "bwd", m)
                bwd_emitted.append((s, m))
            elif next_fwd[s] < n_micro and next_fwd[s] in fwd_ready[s]:
                row[s] = Tick(s, "fwd", next_fwd[s])
                fwd_emitted.append((s, next_fwd[s]))
            elif can_bwd:
                row[s] = Tick(s, "bwd", m)
                bwd_emitted.append((s, m))
        if all(t is None for t in row):
            raise RuntimeError("pipeline deadlock")
        for s, m in fwd_emitted:
            fwd_ready[s].discard(m)
            next_fwd[s] += 1
            in_flight[s] += 1
            if s + 1 < n_stages:
                fwd_ready[s + 1].add(m)
            else:
                bwd_ready_last_add(bwd_ready, s, m)
        for s, m in bwd_emitted:
            next_bwd[s] += 1
            in_flight[s] -= 1
            done_bwd += 1
            if s - 1 >= 0:
                bwd_ready[s - 1].add(m)
        ticks.append(row)
    return ticks


def fwd_done_set(stage: int, next_fwd: List[int]) -> set:
    # last stage can run bwd for any microbatch whose fwd it finished
    return set(range(next_fwd[stage]))


def bwd_ready_last_add(bwd_ready, s, m):
    bwd_ready[s] = bwd_ready[s] | {m} if isinstance(bwd_ready[s], set) \
        else bwd_ready[s]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


# --------------------------------------------------------------- executor
class PipelineExecutor:
    """Runs real stage functions under the 1F1B schedule.

    stage_fwd[s](params_s, x) -> (y, residuals)
    stage_bwd[s](params_s, residuals, dy) -> (dx, grads_s)
    """

    def __init__(self, stage_fwd: Sequence[Callable],
                 stage_bwd: Sequence[Callable], params: Sequence[Any]):
        assert len(stage_fwd) == len(stage_bwd) == len(params)
        self.n_stages = len(stage_fwd)
        self.stage_fwd = stage_fwd
        self.stage_bwd = stage_bwd
        self.params = params

    def run(self, micro_inputs: Sequence[Any], dy_fn: Callable
            ) -> Tuple[List[Any], List[Any], Dict]:
        """Returns (outputs per microbatch, grads per stage, stats).
        ``dy_fn(micro_idx, y)`` provides the loss cotangent at the last
        stage (e.g. from a per-microbatch loss)."""
        S, M = self.n_stages, len(micro_inputs)
        ticks = schedule_1f1b(S, M)
        acts: Dict[Tuple[int, int], Any] = {}      # (stage, micro) -> input
        resid: Dict[Tuple[int, int], Any] = {}
        cotan: Dict[Tuple[int, int], Any] = {}     # (stage, micro) -> dy
        outputs: List[Any] = [None] * M
        grads: List[Any] = [None] * S
        peak_live = 0
        for m in range(M):
            acts[(0, m)] = micro_inputs[m]
        for row in ticks:
            for t in row:
                if t is None:
                    continue
                if t.kind == "fwd":
                    x = acts.pop((t.stage, t.micro))
                    y, r = self.stage_fwd[t.stage](self.params[t.stage], x)
                    resid[(t.stage, t.micro)] = r
                    if t.stage + 1 < S:
                        acts[(t.stage + 1, t.micro)] = y
                    else:
                        outputs[t.micro] = y
                        cotan[(t.stage, t.micro)] = dy_fn(t.micro, y)
                else:
                    r = resid.pop((t.stage, t.micro))
                    dy = cotan.pop((t.stage, t.micro))
                    dx, g = self.stage_bwd[t.stage](self.params[t.stage],
                                                    r, dy)
                    grads[t.stage] = g if grads[t.stage] is None else \
                        tree_map(torch.add, grads[t.stage], g)
                    if t.stage - 1 >= 0:
                        cotan[(t.stage - 1, t.micro)] = dx
            peak_live = max(peak_live, len(resid))
        stats = {"ticks": len(ticks), "peak_residuals": peak_live,
                 "bubble_frac": bubble_fraction(S, M)}
        return outputs, grads, stats


def make_stages_from_model(fwd_fn: Callable, n_stages: int):
    """Build stage fwd/bwd callables from a per-stage forward
    ``fwd_fn(params, x)`` (params a tensor or a tree of them): the
    forward runs under autograd on detached inputs that require grad,
    and the backward takes ``torch.autograd.grad(outputs, inputs +
    params, grad_outputs=dy)`` (the reference's ``jax.vjp``)."""
    def stage_fwd(params, x):
        paths, leaves = tree_flatten(params)
        p_in = [p.detach().requires_grad_(True) for p in leaves]
        x_in = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = fwd_fn(tree_unflatten(paths, p_in), x_in)
        return y.detach(), (y, x_in, paths, p_in)

    def stage_bwd(params, resid, dy):
        y, x_in, paths, p_in = resid
        dx, *dparams = torch.autograd.grad(y, [x_in] + p_in,
                                           grad_outputs=dy)
        return dx, tree_unflatten(paths, dparams)

    return ([stage_fwd] * n_stages, [stage_bwd] * n_stages)
