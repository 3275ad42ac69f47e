"""Mixture-of-Experts with capacity-based scatter dispatch.

The counterpart of the reference's ``models/moe.py``.  Dispatch is
exact top-k with a fixed per-expert capacity
C = ceil(tokens * top_k * capacity_factor / E): tokens beyond capacity
are dropped (GShard semantics), the same (token, slot)s as the
reference drops, since both rank a slot within its expert by a stable
sort.  The expert FFNs are batched matmuls over the (E, C, d) buffers,
as the reference's einsums are (no Pallas kernel runs there).

Under a model axis that divides E, dispatch is expert-parallel
(``_moe_block_sharded``): each model rank holds its E/n experts' weights
(its model block, never gathered), scatters the tokens it holds into
their buffers, and one all-reduce over the model group combines the
partial outputs.  A shared expert is a tensor-parallel MLP
(``layers.mlp``).

Within :func:`count_drops` each layer call also counts the slots it
dropped, exactly (the aux's ``moe_drop_frac`` is the reference's
capacity estimate under expert-parallel dispatch).

Where the config names the experts held here (``cfg.held_experts()``:
a ``DeepSeekV3Config``'s) the layer is :func:`held_moe_block` instead:
DeepSeek-V3's published router over all the experts, and the part of
the output that the experts held here give, with no capacity and no
drop, plus the shared expert; its experts run as the grouped kernels
of ``kernels/moe_experts.py`` on the card.  Within
:func:`count_held_slots` each such layer call counts the slots routed to
each held expert, and within :func:`record_routes` it keeps its choice
of experts.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch

from ..core.spans import span
from ..kernels.moe_experts import moe_experts
from .layers import ACT, Maker, mlp, wide
from .sharding import MeshRules


# the open :func:`count_drops` list, else None
_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops():
    """Yields a list to which each MoE layer call in the block appends
    the (token, slot)s this rank dropped, a 0-dim tensor (no sync).  On a
    mesh each dropped slot of this rank's tokens is counted once: by the
    model rank that holds its expert in the expert-parallel dispatch, by
    model rank 0 in the dense one.  So the sum over the calls, summed
    over the ranks that split the batch, is the batch's dropped slots
    (where every data rank holds the batch whole, each counts it)."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


# the open :func:`count_held_slots` list, else None: each held-expert
# layer call's offsets (an exclusive scan of its held experts' slot
# counts), a tensor on the layer's device, until the block closes
MOE_HELD_SLOTS: Optional[List[torch.Tensor]] = None
# the open :func:`record_routes` list, else None
_ROUTES: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_held_slots():
    """Yields a list that, once the block closes, holds one list of ints
    for each :func:`held_moe_block` call in the block: the (token, slot)s
    routed to each of its held experts.  Inside the block the calls
    append their offsets, tensors on their device (no sync); the close
    reads them all to the host in one read, so a block around a decode
    step reads nothing before the step's own token read."""
    global MOE_HELD_SLOTS
    outer, MOE_HELD_SLOTS = MOE_HELD_SLOTS, []
    calls = MOE_HELD_SLOTS
    try:
        yield calls
    finally:
        MOE_HELD_SLOTS = outer
    calls[:] = _slot_counts(calls)


def _slot_counts(offsets: List[torch.Tensor]) -> List[List[int]]:
    """Each offsets tensor's differences, as ints, in one host read."""
    if not offsets:
        return []
    flat = torch.cat([o.reshape(-1) for o in offsets]).tolist()
    counts, at = [], 0
    for o in offsets:
        run = flat[at:at + o.numel()]
        counts.append([b - a for a, b in zip(run, run[1:])])
        at += o.numel()
    return counts


@contextlib.contextmanager
def record_routes():
    """Yields a list to which each :func:`held_moe_block` call in the
    block appends its (tokens, top_k) experts chosen (no sync)."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def _count(dropped: torch.Tensor, rules: Optional[MeshRules] = None
           ) -> None:
    """Append ``dropped``'s count while :func:`count_drops` is open;
    with ``rules``, on model rank 0 alone (a dispatch every model rank
    computes alike)."""
    if _DROPS is None or (rules is not None and rules.axis_size(
            rules.model_axis) > 1 and rules.coordinate(rules.model_axis)):
        return
    _DROPS.append(dropped.sum())


def make_moe_params(mk: Maker, cfg) -> dict:
    """The router over all ``n_experts``, the experts' weights and the
    shared experts'; where the config names the experts held here, the
    router's selection bias too, and the held experts' weights alone."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": mk.param((d, E), ("embed", None), dtype=torch.float32)}
    held = cfg.held_experts()
    if held is not None:
        p["bias"] = mk.param((E,), (None,), scale=cfg.selection_bias_std,
                             dtype=torch.float32)
        E = len(held)
    p.update({
        "w_gate": mk.param((E, d, ff), ("expert", "embed", None)),
        "w_up": mk.param((E, d, ff), ("expert", "embed", None)),
        "w_down": mk.param((E, ff, d), ("expert", None, "embed")),
    })
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "wg": mk.param((d, sff), ("embed", "model")),
            "wi": mk.param((d, sff), ("embed", "model")),
            "wo": mk.param((sff, d), ("model", "embed")),
        }
    return p


def _positions_in_expert(flat_e: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """Rank of each (token, slot) within its expert via a stable argsort:
    the slot index into the expert's capacity buffer."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # index within each expert segment
    idx = torch.arange(n, device=flat_e.device)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=flat_e.dtype,
                               device=flat_e.device))
    pos = torch.empty_like(idx)
    pos[order] = idx - seg_start[sorted_e]
    return pos


def moe_block(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux) with load-balance metrics in aux.  Under
    a model axis wider than 1 that divides E, expert-local dispatch:
    tokens stay where they are and one activation-sized all-reduce a
    layer combines the experts' outputs."""
    if cfg.held_experts() is not None:
        return held_moe_block(cfg, p, x, rules)
    model_n = rules.axis_size(rules.model_axis)
    if rules.mesh is not None and model_n > 1 and \
            cfg.n_experts % model_n == 0:
        return _moe_block_sharded(cfg, p, x, rules)
    return _moe_block_dense(cfg, p, x, rules)


def _router(cfg, p, xt):
    logits = wide(xt) @ wide(p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / (torch.sum(gate_w, dim=-1, keepdim=True) + 1e-9)
    return probs, gate_w, gate_idx


def _batch_total(t: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """``t`` summed over the ranks that split the batch (``t`` itself
    when none do); differentiable, each rank's loss using the total."""
    from ..core.distributed import shared_sum
    for ax in rules.split_batch_axes():
        t = shared_sum(t, rules.group(ax))
    return t


def _earlier_slots(flat_e: torch.Tensor, n_experts: int, rules: MeshRules):
    """For each (token, slot), how many slots of its expert come before
    this rank's tokens in the global token order (ranks ordered along
    the batch axes, outermost first, as the train loop hands out batch
    rows); 0 when no rank splits the batch.  Added to a slot's position
    among this rank's tokens, it gives its position in the global batch,
    which is what the reference's trace over the global batch ranks."""
    axes = rules.split_batch_axes()
    if not axes:
        return 0
    from ..core.distributed import all_gather
    counts = torch.zeros(n_experts, dtype=torch.long, device=flat_e.device
                         ).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    every = counts[None]
    for ax in reversed(axes):   # innermost first: rows end outermost-major
        every = all_gather(every, rules.group(ax))
    index = 0
    for ax in axes:
        index = index * rules.axis_size(ax) + rules.coordinate(ax)
    return every[:index].sum(0)[flat_e]


def _aux(cfg, probs, gate_idx, keep, rules: MeshRules):
    """The load-balance loss and the drop fraction over the global
    batch: under a split batch the router statistics (mean probability
    and slot fraction a expert) and the kept slots are summed over the
    batch axes, in one all-reduce, before their product."""
    E, K = cfg.n_experts, cfg.top_k
    n = probs.shape[0] * rules.axis_size(rules.split_batch_axes())
    counts = torch.nn.functional.one_hot(gate_idx, E).float().sum((0, 1))
    total = _batch_total(torch.cat([probs.sum(0), counts,
                                    keep.float().sum()[None]]), rules)
    me, ce = total[:E] / n, total[E:2 * E] / n
    return {"moe_aux_loss": E * torch.sum(me * ce) / K,
            "moe_drop_frac": 1.0 - total[2 * E] / (n * K)}


def _shared_expert(cfg, p, x, rules: MeshRules):
    """The shared experts' MLP on x (B, S, d), as (B*S, d)."""
    sff = cfg.moe_d_ff * cfg.n_shared_experts
    return mlp(cfg, p["shared"], x, rules, ff=sff).reshape(-1, x.shape[-1])


def _moe_block_sharded(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
                       ) -> Tuple[torch.Tensor, dict]:
    """Expert-parallel dispatch with no token movement: every model rank
    holds the full token block of its data rank (x) and the weights of
    ITS E/model_n experts (their model block), scatters the tokens into
    those experts' capacity buffers, computes, and contributes a
    partial (N, d) output; one all-reduce over the model group combines
    them.  C comes from the tokens this rank holds, as the reference's
    from its data-local block.  The aux loss is taken over the global
    batch, its drop fraction from the capacity estimate ``pos < C *
    model_n`` at each slot's global position, as in the reference."""
    from ..core.distributed import psum, replicated

    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xt = x.reshape(N, d)
    probs, gate_w, gate_idx = _router(cfg, p, xt)

    model_ax = rules.model_axis
    model_n = rules.axis_size(model_ax)
    group = rules.group(model_ax)
    C = max(1, int(math.ceil(N * K * cfg.capacity_factor / E)))
    e_local = E // model_n
    lo = rules.coordinate(model_ax) * e_local
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    xl = replicated(xt, group)
    gw = replicated(gate_w, group)

    flat_e = gate_idx.reshape(-1)
    pos = _positions_in_expert(flat_e, E)
    mine = (flat_e >= lo) & (flat_e < lo + e_local)
    keep = (pos < C) & mine
    _count(mine & ~keep)
    local_e = torch.where(mine, flat_e - lo, 0)
    dest = torch.where(keep, local_e * C + pos, e_local * C)
    x_rep = torch.repeat_interleave(xl, K, dim=0)
    buf = xl.new_zeros((e_local * C + 1, d)).index_add(0, dest, x_rep)
    buf = buf[:e_local * C].reshape(e_local, C, d)
    act = ACT[cfg.act]
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_buf = torch.bmm(h, w_down).reshape(e_local * C, d)
    gathered = torch.where(keep[:, None],
                           out_buf[dest.clamp(max=e_local * C - 1)],
                           out_buf.new_zeros(()))
    y = torch.sum((gathered * gw.reshape(-1)[:, None]).reshape(N, K, d),
                  dim=1)
    y = psum(y.to(x.dtype), group)
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, p, x, rules)
    pos_global = pos + _earlier_slots(flat_e, E, rules)
    aux = _aux(cfg, probs, gate_idx, pos_global < C * model_n, rules)
    return y.reshape(B, S, d).to(x.dtype), aux


def _moe_block_dense(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
                     ) -> Tuple[torch.Tensor, dict]:
    """The global scatter.  Under a split batch, C and each slot's
    position come from the global batch, so the same slots drop as on
    one rank holding it all; this rank's buffer holds its own kept
    slots, at most min(C, N) an expert."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xt = x.reshape(N, d)
    probs, gate_w, gate_idx = _router(cfg, p, xt)            # (N, K)

    n_global = N * rules.axis_size(rules.split_batch_axes())
    C = int(math.ceil(n_global * K * cfg.capacity_factor / E))
    C = max(1, min(C, n_global))

    flat_e = gate_idx.reshape(-1)                            # (N*K,)
    pos = _positions_in_expert(flat_e, E)                    # (N*K,)
    keep = pos + _earlier_slots(flat_e, E, rules) < C
    _count(~keep, rules)
    Cb = min(C, N)
    # a dropped slot lands on an overflow row past the E*Cb buffer rows
    dest = torch.where(keep, flat_e * Cb + pos, E * Cb)

    x_rep = torch.repeat_interleave(xt, K, dim=0)            # (N*K, d)
    buf = x.new_zeros((E * Cb + 1, d)).index_add_(0, dest, x_rep)
    buf = rules.constrain(buf[:E * Cb].reshape(E, Cb, d),
                          "expert", None, None)

    act = ACT[cfg.act]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = rules.constrain(torch.bmm(h, p["w_down"]), "expert", None,
                              None)

    flat_out = out_buf.reshape(E * Cb, d)
    gathered = torch.where(keep[:, None],
                           flat_out[dest.clamp(max=E * Cb - 1)],
                           flat_out.new_zeros(()))
    y = torch.sum((gathered * gate_w.reshape(-1)[:, None]).reshape(N, K, d),
                  dim=1)
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, p, x, rules)
    return (y.reshape(B, S, d).to(x.dtype),
            _aux(cfg, probs, gate_idx, keep, rules))


def published_router(cfg, p, xt: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router (noaux_tc) over all ``cfg.n_experts``:
    sigmoid scores; the selection bias added for choosing only; a
    group's score the sum of its two best biased scores; the best
    ``topk_group`` groups; the best ``top_k`` experts within them.
    Returns the weights, the unbiased scores of the chosen experts
    normalised over them (``norm_topk_prob``) times
    ``routed_scaling_factor``, and the experts, each (N, top_k)."""
    N, E, G = xt.shape[0], cfg.n_experts, cfg.n_group
    scores = torch.sigmoid(wide(xt) @ wide(p["router"]))
    biased = (scores + wide(p["bias"])).view(N, G, E // G)
    best = biased.topk(2, dim=-1).values.sum(-1)
    kept = best.topk(cfg.topk_group, dim=-1).indices
    shut = torch.ones((N, G), dtype=torch.bool, device=xt.device
                      ).scatter_(1, kept, False)
    biased = biased.masked_fill(shut[..., None], float("-inf"))
    experts = biased.view(N, E).topk(cfg.top_k, dim=-1).indices
    weights = scores.gather(1, experts)
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights * cfg.routed_scaling_factor, experts


def held_moe_block(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
                   ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, {}): one card's part of DeepSeek-V3's MoE
    under expert parallelism.  Routes every token over all the experts
    (:func:`published_router`), then computes each held expert's
    (``cfg.held_experts()``) SwiGLU on exactly the (token, slot)s routed
    to it (no capacity, no drop) and sums them with their weights and the
    shared expert's output in f32 (``kernels/moe_experts.py``: on the
    card two grouped kernels over a slot layout built on the device; on
    the CPU the plain loop over the held experts).  The experts held
    elsewhere add nothing here: on one card there is no exchange.  Reads
    nothing to the host."""
    if rules.mesh is not None:
        raise ValueError("the held-expert layer runs on one card (no mesh)")
    if cfg.act != "silu":
        raise ValueError(f"the held experts are SwiGLU, got act {cfg.act}")
    B, S, d = x.shape
    N = B * S
    here = cfg.held_experts()
    xt = x.reshape(N, d)
    with span("blasx.moe.route"):
        weights, experts = published_router(cfg, p, xt)
    if _ROUTES is not None:
        _ROUTES.append(experts)
    with span("blasx.moe.experts"):
        y, offsets = moe_experts(xt, experts, weights, p["w_gate"],
                                 p["w_up"], p["w_down"], here.start,
                                 cfg.n_experts)
    if MOE_HELD_SLOTS is not None:
        MOE_HELD_SLOTS.append(offsets)
    if cfg.n_shared_experts:
        with span("blasx.moe.shared"):
            y = y + _shared_expert(cfg, p, x, rules)
    return y.reshape(B, S, d).to(x.dtype), {}
