"""Mixture-of-Experts with capacity-based scatter dispatch.

The counterpart of the reference's ``models/moe.py``.  Dispatch is
exact top-k with a fixed per-expert capacity
C = ceil(tokens * top_k * capacity_factor / E): tokens beyond capacity
are dropped (GShard semantics), the same (token, slot)s as the
reference drops, since both rank a slot within its expert by a stable
sort.  The expert FFNs are batched matmuls over the (E, C, d) buffers,
as the reference's einsums are (no Pallas kernel runs there).

Under a model axis that divides E, dispatch is expert-parallel
(``_moe_block_sharded``): each model rank scatters the tokens it holds
into its E/n experts' buffers, and one all-reduce over the model group
combines the partial outputs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .layers import ACT, Maker
from .sharding import MeshRules


def make_moe_params(mk: Maker, cfg) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": mk.param((d, E), ("embed", None), dtype=torch.float32),
        "w_gate": mk.param((E, d, ff), ("expert", "embed", None)),
        "w_up": mk.param((E, d, ff), ("expert", "embed", None)),
        "w_down": mk.param((E, ff, d), ("expert", None, "embed")),
    }
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
    model_n = rules.axis_size(rules.model_axis)
    if rules.mesh is not None and model_n > 1 and \
            cfg.n_experts % model_n == 0:
        return _moe_block_sharded(cfg, p, x, rules)
    return _moe_block_dense(cfg, p, x, rules)


def _router(cfg, p, xt):
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / (torch.sum(gate_w, dim=-1, keepdim=True) + 1e-9)
    return probs, gate_w, gate_idx


def _aux(cfg, probs, gate_idx, keep):
    E, K = cfg.n_experts, cfg.top_k
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(gate_idx, E).float().sum(1),
                    dim=0)
    return {"moe_aux_loss": E * torch.sum(me * ce) / K,
            "moe_drop_frac": 1.0 - torch.mean(keep.float())}


def _shared_expert(cfg, p, xt):
    act = ACT[cfg.act]
    sp = p["shared"]
    return (act(xt @ sp["wg"]) * (xt @ sp["wi"])) @ sp["wo"]


def _moe_block_sharded(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
                       ) -> Tuple[torch.Tensor, dict]:
    """Expert-parallel dispatch with no token movement: every model rank
    holds the full token block of its data rank (x), scatters it into
    ITS E/model_n experts' capacity buffers, computes, and contributes a
    partial (N, d) output; one all-reduce over the model group combines
    them.  C comes from the tokens this rank holds, as the reference's
    from its data-local block.  The aux loss is taken over this rank's
    tokens (the reference's over the global batch: the two differ under
    a data axis > 1), its drop fraction from the capacity estimate
    ``pos < C * model_n``, as in the reference."""
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
    w_gate, w_up, w_down = (replicated(p[k], group)[lo:lo + e_local]
                            for k in ("w_gate", "w_up", "w_down"))
    xl = replicated(xt, group)
    gw = replicated(gate_w, group)

    flat_e = gate_idx.reshape(-1)
    pos = _positions_in_expert(flat_e, E)
    mine = (flat_e >= lo) & (flat_e < lo + e_local)
    keep = (pos < C) & mine
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
        y = y + _shared_expert(cfg, p, xt)
    aux = _aux(cfg, probs, gate_idx, pos < C * model_n)
    return y.reshape(B, S, d).to(x.dtype), aux


def _moe_block_dense(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
                     ) -> Tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xt = x.reshape(N, d)
    probs, gate_w, gate_idx = _router(cfg, p, xt)            # (N, K)

    C = int(math.ceil(N * K * cfg.capacity_factor / E))
    C = max(1, min(C, N))

    flat_e = gate_idx.reshape(-1)                            # (N*K,)
    pos = _positions_in_expert(flat_e, E)                    # (N*K,)
    keep = pos < C
    # a dropped slot lands on an overflow row past the E*C buffer rows
    dest = torch.where(keep, flat_e * C + pos, E * C)

    x_rep = torch.repeat_interleave(xt, K, dim=0)            # (N*K, d)
    buf = x.new_zeros((E * C + 1, d)).index_add_(0, dest, x_rep)
    buf = rules.constrain(buf[:E * C].reshape(E, C, d),
                          "expert", None, None)

    act = ACT[cfg.act]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = rules.constrain(torch.bmm(h, p["w_down"]), "expert", None,
                              None)

    flat_out = out_buf.reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           flat_out[dest.clamp(max=E * C - 1)],
                           flat_out.new_zeros(()))
    y = torch.sum((gathered * gate_w.reshape(-1)[:, None]).reshape(N, K, d),
                  dim=1)
    if cfg.n_shared_experts:
        y = y + _shared_expert(cfg, p, xt)
    return y.reshape(B, S, d).to(x.dtype), _aux(cfg, probs, gate_idx, keep)
