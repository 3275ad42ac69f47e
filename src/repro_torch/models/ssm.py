"""Mamba2 (SSD, state-space duality) blocks, chunked, plus O(1) decode.

The counterpart of the reference's ``models/ssm.py``.  The SSD
recurrence per head (state N = ssm_state, head dim P):
    h_t = a_t * h_{t-1} + (dt_t * x_t) outer B_t        a_t = exp(-exp(A_log) dt_t)
    y_t = C_t . h_t + D * x_t

Chunked algorithm (the duality): within a chunk the output is an
attention-like quadratic form with a decay mask; across chunks only the
(H, P, N) boundary states are carried, here by a Python loop over the
chunks in place of the reference's ``lax.scan``.  The state is float32
in every config dtype.

Under a model axis of n ranks that divides the heads, a rank computes
its H/n heads, as the reference's GSPMD does under its placements
(``in_proj`` on "model" by columns, ``conv_w``/``conv_b``/``norm`` on
"model", ``out_proj`` by rows).  ``in_proj``, ``conv_w`` and ``conv_b``
are still gathered whole over the model axis
(``transformer.whole_on_model``): their columns concatenate z, x, B, C
and dt (x, B and C for the conv), so their stored contiguous blocks mix
the parts.  The rank takes from them its heads' z, x and dt columns and
all of B and C, which every rank computes alike (their gradient, like
the whole leaves', is summed over the model group).  ``norm`` and
``out_proj`` are its heads' blocks as they are held; the gated norm
sums its squares over the model group, and ``out_proj``'s rows finish
the output in ``layers.row_parallel_matmul``.  The decode state holds
the ssm state by heads (the rank's own) and the conv state whole over
the conv channels here: the rank reads its parts of it and all-gathers
its new x channels back.  Where n does not divide the heads, every
model rank computes the whole mixer from leaves gathered whole.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import (Maker, model_replicated, rms_norm, row_parallel_matmul,
                     wide)
from .sharding import MeshRules


def make_mamba_params(mk: Maker, cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    ds = cfg.ssm_state
    H = cfg.ssm_heads
    conv_dim = di + 2 * ds
    f32 = torch.float32
    return {
        # order: [z (di), x (di), B (ds), C (ds), dt (H)]
        "in_proj": mk.param((d, 2 * di + 2 * ds + H), ("embed", "model")),
        "conv_w": mk.param((cfg.ssm_conv, conv_dim), (None, "model"),
                           scale=0.5),
        "conv_b": mk.param((conv_dim,), ("model",), zeros=True),
        "A_log": mk.ones((H,), (None,), dtype=f32),
        "D": mk.ones((H,), (None,), dtype=f32),
        "dt_bias": mk.param((H,), (None,), zeros=True, dtype=f32),
        "norm": mk.ones((di,), ("model",)),
        "out_proj": mk.param((di, d), ("model", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).
    state: (B, K-1, C) carry for decode.  Returns (y, new_state)."""
    B, S, Cdim = x.shape
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((B, K - 1, Cdim))
    xx = torch.cat([state, x], dim=1)                  # (B, K-1+S, C)
    y = xx[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xx[:, i:i + S, :] * w[i][None, None, :]
    y = y + b[None, None, :]
    new_state = xx[:, -(K - 1):, :] if K > 1 else state
    return F.silu(y), new_state


def _ssd_chunked(xh, dt, a_log, Bmat, Cmat, chunk: int):
    """Chunked SSD scan.
    xh: (B, S, H, P); dt: (B, S, H); Bmat/Cmat: (B, S, N).
    Returns y: (B, S, H, P) and final state (B, H, P, N), float32
    (float64 in a float64 model)."""
    Bsz, S, H, P = xh.shape
    N = Bmat.shape[-1]
    nc = S // chunk
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")

    f32 = wide(xh).dtype
    lg_a = -torch.exp(a_log.to(f32))[None, None, :] * dt.to(f32)  # log decay
    xdt = xh.to(f32) * dt.to(f32)[..., None]           # (B, S, H, P)

    lg = lg_a.reshape(Bsz, nc, chunk, H)
    xc = xdt.reshape(Bsz, nc, chunk, H, P)
    Bc = Bmat.to(f32).reshape(Bsz, nc, chunk, N)
    Cc = Cmat.to(f32).reshape(Bsz, nc, chunk, N)

    csum = torch.cumsum(lg, dim=2)                     # (B, nc, L, H)
    # ----- intra-chunk (quadratic "attention" with decay mask), scores
    # times decay first: the 6-D (B, nc, L, S, H, P) product never forms
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)   # (B, nc, L, L)
    li = csum[:, :, :, None, :] - csum[:, :, None, :, :]   # (B,nc,L,S,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    # masked before the exp, not after (the reference's order): above
    # the diagonal li is a sum of decays that grows with the chunk and
    # overflows exp at a full chunk of 256, and a masked inf turns the
    # gradient into 0 * inf = NaN; exp(-inf) is the same 0 with a zero
    # gradient
    decay = torch.exp(li.masked_fill(~mask[None, None, :, :, None],
                                     float("-inf")))
    y_intra = torch.einsum("bclsh,bcshp->bclhp",
                           scores[..., None] * decay, xc)

    # ----- chunk boundary states
    tail = csum[:, :, -1:, :] - csum                   # exp(l_end - l_s)
    st = torch.einsum("bcshp,bcsn->bchpn",
                      torch.exp(tail)[..., None] * xc, Bc)  # (B,nc,H,P,N)
    a_chunk = torch.exp(csum[:, :, -1, :])             # (B, nc, H)

    # ----- inter-chunk recurrence (nc steps); the state BEFORE each chunk
    h = xh.new_zeros((Bsz, H, P, N), dtype=f32)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * a_chunk[:, c, :, None, None] + st[:, c]
    h_before = torch.stack(before, dim=1)              # (B, nc, H, P, N)

    y_inter = torch.einsum("bcsn,bchpn->bcshp", Cc, h_before) * \
        torch.exp(csum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), h


def _head_parts(cfg, rules: MeshRules, n: int):
    """The column indices, within ``in_proj`` and within the conv
    channels, of what this rank's H/n heads read: their z, x and dt
    columns and all of B and C; and the slice of its heads."""
    di, ds, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    c = rules.coordinate(rules.model_axis)
    dl, hl = di // n, H // n
    own = slice(c * dl, (c + 1) * dl)
    heads = slice(c * hl, (c + 1) * hl)
    in_cols = (own, slice(di + own.start, di + own.stop),
               slice(2 * di, 2 * di + 2 * ds),
               slice(2 * di + 2 * ds + heads.start,
                     2 * di + 2 * ds + heads.stop))
    conv_cols = (own, slice(di, di + 2 * ds))
    return in_cols, conv_cols, heads


def _cols(t: torch.Tensor, cols) -> torch.Tensor:
    """The columns ``cols`` (slices of the last dim) of ``t``, joined."""
    return torch.cat([t[..., sl] for sl in cols], dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps,
                rules: MeshRules, n: int, features: int) -> torch.Tensor:
    """``rms_norm(y * silu(z), w)`` over all ``features`` of the last
    dim, of which y, z and w hold this rank's block where n > 1: the f32
    sum of squares is summed over the model group (forward and
    backward: every rank's loss reads the sum)."""
    g = y * F.silu(z)
    if n == 1:
        return rms_norm(g, w, eps)
    from ..core.distributed import shared_sum
    gf = wide(g)
    ss = shared_sum(torch.sum(gf * gf, dim=-1, keepdim=True),
                    rules.group(rules.model_axis))
    return (gf * torch.rsqrt(ss / features + eps) * wide(w)).to(g.dtype)


def mamba_block(cfg, p: dict, x: torch.Tensor, rules: MeshRules, *,
                state: Optional[dict] = None, make_state: bool = False,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full Mamba2 mixer.  x: (B, S, d).
    state (decode, S == 1): {"conv": (B, K-1, conv_dim), "ssm":
    (B, H, P, N) float32}, updated IN PLACE and returned (as the
    attention caches are).  Where the model axis splits the heads n
    ways, "ssm" is this rank's (B, H/n, P, N) block and "conv" is whole
    (see the module's docstring), and so is a prefill's new state."""
    B, S, d = x.shape
    di, ds, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    n = rules.model_ways(H)
    dl, hl = di // n, H // n
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    a_log, d_skip, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    conv_state = state["conv"] if state is not None else None
    if n > 1:
        # this rank's H/n heads: its parts of the whole in_proj and conv
        # (one matmul on the gathered columns), B and C alike on every
        # rank, and every input it uses by its heads entering with an
        # all-reduced gradient
        in_cols, conv_cols, heads = _head_parts(cfg, rules, n)
        x = model_replicated(x, rules)
        a_log, d_skip, dt_bias = (model_replicated(t, rules)[heads]
                                  for t in (a_log, d_skip, dt_bias))
        w_in = _cols(w_in, in_cols)
        conv_w, conv_b = _cols(conv_w, conv_cols), _cols(conv_b, conv_cols)
        if conv_state is not None:
            conv_state = _cols(conv_state, conv_cols)

    zxbcdt = x @ w_in
    z = zxbcdt[..., :dl]
    xbc = zxbcdt[..., dl:dl + dl + 2 * ds]
    dt_raw = zxbcdt[..., -hl:]
    dt = F.softplus(wide(dt_raw) + dt_bias[None, None, :])

    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    xs = xbc[..., :dl].reshape(B, S, hl, P)
    Bmat = xbc[..., dl:dl + ds]
    Cmat = xbc[..., dl + ds:]
    if n > 1 and (state is not None or make_state):
        # the whole conv state: every rank's x channels, then B and C
        from ..core.distributed import all_gather
        new_conv = torch.cat([
            all_gather(new_conv[..., :dl], rules.group(rules.model_axis),
                       dim=-1), new_conv[..., dl:]], dim=-1)

    if state is not None:
        # -------- decode: O(1) recurrent update (S == 1)
        h = state["ssm"]                               # (B, H, P, N) f32
        a = torch.exp(-torch.exp(wide(a_log)) * dt[:, 0, :])  # (B, H)
        xdt = wide(xs[:, 0]) * dt[:, 0, :, None]
        upd = torch.einsum("bhp,bn->bhpn", xdt, wide(Bmat[:, 0]))
        h = h * a[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", wide(Cmat[:, 0]), h)
        y = y + wide(d_skip)[None, :, None] * wide(xs[:, 0])
        y = y.reshape(B, 1, dl).to(x.dtype)
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(h)
        new_state = state
    else:
        chunk = min(cfg.ssm_chunk, S)
        pad = (-S) % chunk
        if pad:
            # zero-pad to a chunk multiple; padded steps use dt=0 so they
            # neither decay nor update the state (a=1, dB=0)
            xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            B_p = F.pad(Bmat, (0, 0, 0, pad))
            C_p = F.pad(Cmat, (0, 0, 0, pad))
        else:
            xs_p, dt_p, B_p, C_p = xs, dt, Bmat, Cmat
        y, h_last = _ssd_chunked(xs_p, dt_p, a_log, B_p, C_p, chunk)
        y = y[:, :S]
        y = y + wide(d_skip)[None, None, :, None] * wide(xs)
        y = y.reshape(B, S, dl).to(x.dtype)
        new_state = ({"conv": new_conv, "ssm": h_last}
                     if make_state else None)

    y = _gated_norm(y, z, p["norm"], cfg.norm_eps, rules, n, di)
    return _out_proj(y, p["out_proj"], rules, n, di), new_state


def _out_proj(y: torch.Tensor, w: torch.Tensor, rules: MeshRules, n: int,
              features: int) -> torch.Tensor:
    """The mixer's output projection ``y @ w``: one product where this
    rank holds every head (n == 1), else its rows' partial, all-reduced
    (``layers.row_parallel_matmul``)."""
    if n == 1:
        return y @ w
    return row_parallel_matmul(y, w, rules, features)
