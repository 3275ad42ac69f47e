"""DeepSeek-V3's forward pass in plain float32 torch, from the published
equations: the yardstick of the port's ``DeepSeekV3Config`` model.

Sources: the DeepSeek-V3 technical report (arXiv:2412.19437, §2.1), the
model's ``config.json`` and the inference code of its repository
(``inference/model.py``).  Computed here: RMSNorm; multi-head latent
attention with K and V expanded from the latent, causal, over every
position; YaRN RoPE and its softmax scale; the dense SwiGLU MLP of the
leading layers; the sigmoid ``noaux_tc`` router; the MoE output of the
experts held here plus the shared expert; the logits over the vocabulary
the weights hold.  No cache and no batching: one sequence.  Attention
runs a block of query rows at a time, so that a long sequence fits.
Imports torch alone.

Departures from the published model, which the port shares:

* the rope dims rotate in halves (dim i with dim i + rope/2), where
  DeepSeek's code rotates interleaved pairs (2i, 2i + 1): the same
  function under a fixed permutation of ``wq_b``'s and ``wkv_a``'s rope
  columns;
* the MoE output holds the share of the experts held here (one card's
  part under expert parallelism): the experts held elsewhere add
  nothing;
* multi-token prediction is left out (serving without speculative
  decoding never runs it);
* the weights are whatever the caller gives: random, in tests and in
  the benchmark.

``hf`` is the configuration: a DeepSeek-V3 ``config.json``'s keys, with
``n_routed_experts`` the count of experts held, from
``first_held_expert``, of the ``experts_routed_over`` the router chooses
among.  ``weights`` is a tree of tensors, products written ``x @ W``
(W: (in, out)): ``embed`` (V, d), ``final_norm`` (d,), ``lm_head`` (d,
V), and ``dense_blocks`` and ``moe_blocks``, whose leaves hold their
layers on a leading dim, each layer ``{"ln1", "ln2", "attn": {"wq_a",
"q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b", "wo"}}`` with
``"mlp": {"wg", "wi", "wo"}`` (dense) or ``"moe": {"router", "bias",
"w_gate", "w_up", "w_down", "shared": {"wg", "wi", "wo"}}``.  ``wq_b``'s
columns are head-major, nope then rope dims a head; ``wkv_b``'s k-nope
then v dims a head; ``wkv_a``'s the latent then the rope key.  Each
weight is widened to float32 where it is used, one layer at a time.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the inputs rounded to float8_e4m3fn, each under one
    scale that maps its largest magnitude to the format's largest."""
    def rounded(t):
        s = t.abs().max().clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return torch.matmul(rounded(a), rounded(b))


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_inv_freq(hf: dict, device=None) -> torch.Tensor:
    """``precompute_freqs_cis``'s frequencies: theta**(-2i/dim), divided
    by the factor below the correction range, blended linearly across
    it."""
    rs, dim, base = hf["rope_scaling"], hf["qk_rope_head_dim"], \
        hf["rope_theta"]
    orig = rs["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=F32,
                                         device=device) / dim))
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    smooth = 1 - ramp
    return freqs / rs["factor"] * (1 - smooth) + freqs * smooth


def softmax_scale(hf: dict) -> float:
    rs = hf["rope_scaling"]
    mscale = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    return (hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]) ** -0.5 \
        * mscale * mscale


def rope(x, cos, sin):
    """Rotate the halves of the last dim: (x1, x2) -> (x1 cos - x2 sin,
    x2 cos + x1 sin); cos and sin (S, rope/2) broadcast over heads."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    if x.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(hf, w, x, cos, sin, mm, rows):
    S = x.shape[0]
    H = hf["num_attention_heads"]
    nope, rd, vd = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                    hf["v_head_dim"])
    r, eps = hf["kv_lora_rank"], hf["rms_norm_eps"]
    q = mm(rms_norm(mm(x, w["wq_a"].float()), w["q_a_norm"].float(), eps),
           w["wq_b"].float()).view(S, H, nope + rd)
    kv_a = mm(x, w["wkv_a"].float())
    c = rms_norm(kv_a[:, :r], w["kv_a_norm"].float(), eps)
    kv = mm(c, w["wkv_b"].float()).view(S, H, nope + vd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k_pe = rope(kv_a[:, r:], cos, sin)
    k = torch.cat([kv[..., :nope], k_pe[:, None].expand(S, H, rd)], dim=-1)
    v = kv[..., nope:]
    scale = softmax_scale(hf)
    out = torch.empty((S, H, vd), dtype=F32, device=x.device)
    pos = torch.arange(S, device=x.device)
    for lo in range(0, S, rows):
        hi = min(lo + rows, S)
        s = mm(q[lo:hi].transpose(0, 1), k[:hi].permute(1, 2, 0)) * scale
        later = pos[None, :hi] > pos[lo:hi, None]
        p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1)
        out[lo:hi] = mm(p, v[:hi].transpose(0, 1)).transpose(0, 1)
    return mm(out.reshape(S, H * vd), w["wo"].float())


def swiglu(mm, x, wg, wi, wo):
    return mm(torch.nn.functional.silu(mm(x, wg.float())) * mm(x, wi.float()),
              wo.float())


def route(hf, w, x, mm) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights, experts), each (S, top_k): sigmoid scores; the bias
    added for the choice only; groups scored by their two best biased
    scores; experts chosen within the best ``topk_group`` groups;
    weights the unbiased scores of the chosen, normalised, scaled."""
    S = x.shape[0]
    E, G = hf["experts_routed_over"], hf["n_group"]
    scores = torch.sigmoid(mm(x, w["router"].float()))
    biased = (scores + w["bias"].float()).view(S, G, E // G)
    group = biased.topk(2, dim=-1).values.sum(-1)
    best = group.topk(hf["topk_group"], dim=-1).indices
    outside = torch.ones((S, G), dtype=torch.bool, device=x.device)
    outside[torch.arange(S, device=x.device)[:, None], best] = False
    biased = biased.masked_fill(outside[..., None], float("-inf"))
    experts = biased.view(S, E).topk(hf["num_experts_per_tok"],
                                     dim=-1).indices
    weights = scores.gather(1, experts)
    if hf["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights * hf["routed_scaling_factor"], experts


def moe(hf, w, x, mm, router):
    weights, experts = router(hf, w, x, mm)
    y = torch.zeros_like(x)
    lo = hf["first_held_expert"]
    for e in range(hf["n_routed_experts"]):
        tok, slot = (experts == lo + e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, swiglu(mm, x[tok], w["w_gate"][e],
                                        w["w_up"][e], w["w_down"][e])
                         * weights[tok, slot, None])
    sh = w["shared"]
    return y + swiglu(mm, x, sh["wg"], sh["wi"], sh["wo"]), experts


def _layers(weights) -> List[dict]:
    out = []
    for group in ("dense_blocks", "moe_blocks"):
        tree = weights.get(group)
        if not tree:
            continue

        def at(node, i):
            return ({k: at(v, i) for k, v in node.items()}
                    if isinstance(node, dict) else node[i])
        n = tree["ln1"].shape[0]
        out += [at(tree, i) for i in range(n)]
    return out


def forward(weights: dict, tokens: torch.Tensor, hf: dict, *,
            at: Optional[Sequence[int]] = None,
            mm: Callable = torch.matmul, router: Callable = route,
            rows: int = 256) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The logits at positions ``at`` (every position by default), (len,
    V) float32, and each MoE layer's chosen experts (S, top_k), of one
    sequence ``tokens`` (S,), on ``tokens``' device.  ``mm`` computes
    every product (``fp8_matmul``: the control one precision down);
    ``router`` chooses the experts (a test may break it)."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = tokens.device
        eps = hf["rms_norm_eps"]
        S = tokens.shape[0]
        ang = torch.arange(S, dtype=F32, device=dev)[:, None] \
            * yarn_inv_freq(hf, dev)
        cos, sin = torch.cos(ang), torch.sin(ang)
        h = weights["embed"][tokens].float()
        routes = []
        for w in _layers(weights):
            h = h + mla(hf, w["attn"], rms_norm(h, w["ln1"].float(), eps),
                        cos, sin, mm, rows)
            x = rms_norm(h, w["ln2"].float(), eps)
            if "mlp" in w:
                h = h + swiglu(mm, x, w["mlp"]["wg"], w["mlp"]["wi"],
                               w["mlp"]["wo"])
            else:
                m, experts = moe(hf, w["moe"], x, mm, router)
                h = h + m
                routes.append(experts)
        if at is not None:
            h = h[torch.as_tensor(list(at), device=dev)]
        h = rms_norm(h, weights["final_norm"].float(), eps)
        return mm(h, weights["lm_head"].float()), routes
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
