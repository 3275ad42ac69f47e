"""Train / prefill / decode steps.

The counterpart of the reference's ``launch/steps.py``.  A train step
runs the forward pass and autograd's backward pass eagerly, averages the
gradients over the mesh's batch axes (each data rank holds its slice of
the global batch), and applies AdamW.  Under a mesh the parameters,
gradients and moments are held at their placements
(``models/sharding.py``): a gradient comes out of its layer's gather
already summed over the batch axes it is sharded on (a reduce-scatter),
is all-reduced over the others, and AdamW updates each rank's blocks.
The cross-entropy runs on this rank's vocab block of the logits where
the model axis splits the vocab (``core.distributed.vocab_parallel_ce``).
``input_specs`` and ``abstract_*`` give the shape-only inputs and states
the dry-run (``launch/dryrun.py``) traces the steps on: fake tensors of
each rank's blocks with the reference's placements, built inside an
active ``FakeTensorMode``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.distributed import all_reduce, replicated
from ..models import Model
from ..models.layers import wide
from ..models.sharding import MeshRules, abstract_leaf, sharded_axes
from ..optim import adamw
from ..tree import tree_flatten, tree_map, tree_unflatten

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3

# the CE loss runs over sequence chunks: the (B, S, V) f32 logits are the
# largest buffer of a train step, and each chunk's are recomputed in the
# backward pass instead of kept (the reference's CHUNKED_CE path; its
# unchunked alternative, a toggle it never turns off, is not ported)
CE_CHUNKS = 16


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
                labels: torch.Tensor, rules: MeshRules, mask=None,
                n_chunks: int = CE_CHUNKS,
                vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE without a full logits tensor.  ``mask``
    (B, S) of {0,1} optionally excludes positions.  Each chunk's logits
    are the stored values' products summed in f32, as the reference's
    ``preferred_element_type=f32`` dot.  Where the model axis splits
    ``vocab`` (the global vocab; default ``head``'s width), ``head`` is
    this rank's column block and the loss is the vocab-parallel one."""
    B, S, d = hidden.shape
    while S % n_chunks != 0 and n_chunks > 1:
        n_chunks //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    w32 = wide(head.to(hidden.dtype))
    cs = S // n_chunks
    ways = rules.model_ways(vocab or head.shape[1])
    if ways > 1:
        from ..core.distributed import vocab_parallel_ce
        group = rules.group(rules.model_axis)
        start = rules.coordinate(rules.model_axis) * head.shape[1]

        def token_ce(h, lab, w):
            logits = torch.matmul(wide(replicated(h, group)), w)
            return vocab_parallel_ce(logits, lab, group, start)
    else:
        def token_ce(h, lab, w):
            logits = rules.constrain(torch.matmul(wide(h), w),
                                     "batch", "seq", "model")
            lg = torch.log_softmax(logits, dim=-1)
            return -torch.gather(lg, -1, lab[..., None].long())[..., 0]

    def body(h, lab, m, w):
        return (token_ce(h, lab, w) * m).sum()

    total = hidden.new_zeros((), dtype=w32.dtype)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        args = (hidden[:, sl], labels[:, sl], mask[:, sl], w32)
        ce = (torch.utils.checkpoint.checkpoint(body, *args,
                                                use_reentrant=False)
              if torch.is_grad_enabled() else body(*args))
        total = total + ce
    return total / torch.clamp(mask.sum(), min=1.0)


def data_parallel(rules: MeshRules, global_batch: int) -> bool:
    """Whether the batch is split over the batch axes (more than one
    rank along them, and they divide it); otherwise it is replicated
    and nothing is averaged."""
    n = rules.axis_size(rules.batch_axes) if rules.mesh is not None else 1
    return n > 1 and rules.batch_size_divides(global_batch)


def _mean_over_batch_axes(t: torch.Tensor, rules: MeshRules,
                          summed: tuple = ()) -> torch.Tensor:
    """The mean over the batch axes of each rank's ``t``, which is
    summed over the axes in ``summed`` already."""
    for ax in rules.batch_axes:
        if rules.axis_size(ax) > 1 and ax not in summed:
            t = all_reduce(t, rules.group(ax))
    return t / rules.axis_size(rules.batch_axes)


# ---------------------------------------------------------------- specs
def input_specs(cfg: ModelConfig, shape, rules: MeshRules, device="cuda"
                ) -> dict:
    """Shape-only inputs of the (arch, shape) cell: fake tensors on
    ``device`` of this rank's blocks of the global shapes, each with its
    placement (the batch on the batch axes where they divide it, else
    replicated)."""
    B, S = shape.global_batch, shape.seq_len
    # single-sequence long decode: batch axis unshardable -> replicate
    b_ax = "batch" if rules.batch_size_divides(B) else None

    def leaf(shp, dtype, *logical):
        return abstract_leaf(shp, dtype, device,
                             rules.fitted_sharding(shp, *logical))

    if shape.kind == "train":
        out = {"tokens": leaf((B, S), torch.int32, b_ax, "seq"),
               "labels": leaf((B, S), torch.int32, b_ax, "seq")}
        if cfg.family == "encdec":
            out["enc_embeds"] = leaf((B, S, cfg.d_model), torch.bfloat16,
                                     b_ax, "seq", None)
        elif cfg.frontend:
            # modality frontend stub: precomputed patch/frame embeddings
            out["embeds"] = leaf((B, S, cfg.d_model), torch.bfloat16,
                                 b_ax, "seq", None)
            del out["tokens"]
        return out
    if shape.kind == "prefill":
        out = {"tokens": leaf((B, S), torch.int32, b_ax, "seq")}
        if cfg.family == "encdec":
            out["enc_embeds"] = leaf((B, S, cfg.d_model), torch.bfloat16,
                                     b_ax, "seq", None)
        elif cfg.frontend:
            out = {"embeds": leaf((B, S, cfg.d_model), torch.bfloat16,
                                  b_ax, "seq", None)}
        return out
    if shape.kind == "decode":
        return {"token": leaf((B,), torch.int32, b_ax),
                "pos": leaf((B,), torch.int32, b_ax)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------- train
def make_grad_step(cfg: ModelConfig, rules: MeshRules):
    """(grad_step, model).  ``grad_step(params, batch, global_batch=None)``
    takes this rank's batch (tensors on the parameters' device) and
    returns (grads, loss, aux): each gradient held as its parameter is
    (this rank's block under a mesh).  ``global_batch`` (default: the
    local batch's size) says whether the data ranks split it
    (:func:`data_parallel`), in which case the model runs with
    ``rules.batch_split`` (its MoE statistics are over the global batch
    already, and a gather's gradient is summed over the batch axes it
    gathers on) and the gradients and the loss are averaged over the
    batch axes."""
    model = Model(cfg, rules)
    split = Model(cfg, dataclasses.replace(rules, batch_split=True))

    def loss_fn(model, params, batch):
        kw = {}
        if "embeds" in batch:
            kw["embeds"] = batch["embeds"]
        else:
            kw["tokens"] = batch["tokens"]
        if "enc_embeds" in batch:
            kw["enc_embeds"] = batch["enc_embeds"]
        labels = batch["labels"]
        hidden, aux = model.train_logits(params, return_hidden=True, **kw)
        head = model.head_matrix(params)
        ce = _chunked_ce(hidden, head, labels, model.rules,
                         vocab=cfg.vocab_size)
        loss = ce
        if "moe_aux_loss" in aux:
            loss = loss + MOE_AUX_WEIGHT * aux["moe_aux_loss"]
        if "mtp_hidden" in aux:
            # predict t+2: shift labels, mask the final position
            l2 = torch.cat([labels[:, 1:], torch.zeros_like(labels[:, :1])],
                           dim=1)
            m2 = torch.cat([torch.ones_like(labels[:, 1:],
                                            dtype=torch.float32),
                            torch.zeros_like(labels[:, :1],
                                             dtype=torch.float32)], dim=1)
            mtp_ce = _chunked_ce(aux["mtp_hidden"], head, l2, model.rules,
                                 mask=m2, vocab=cfg.vocab_size)
            loss = loss + MTP_WEIGHT * mtp_ce
        return loss, {"ce": ce}

    def grad_step(params, batch, global_batch=None):
        paths, leaves = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        n_local = next(iter(batch.values())).shape[0]
        dp = data_parallel(rules, global_batch or n_local)
        with torch.enable_grad():
            loss, aux = loss_fn(split if dp else model,
                                tree_unflatten(paths, live), batch)
            # a parameter the loss never reads (the embedding under a
            # frontend's embeds, OLMo's non-parametric norms) gets zeros,
            # as jax.grad gives it
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        if dp:
            # each rank's loss holds the global MoE aux term and its own
            # CE, so the mean over ranks is the global loss
            places = tree_flatten(model.placements())[1]
            grads = [_mean_over_batch_axes(g, rules, sharded_axes(pl))
                     for g, pl in zip(grads, places)]
            loss = _mean_over_batch_axes(loss, rules)
            aux = tree_map(lambda v: _mean_over_batch_axes(v, rules), aux)
        return tree_unflatten(paths, grads), loss, aux

    return grad_step, model


def make_train_step(cfg: ModelConfig, rules: MeshRules,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    donate: bool = False):
    """(train_step, model).  ``train_step(params, opt_state, batch,
    global_batch=None)`` takes this rank's batch and returns (params,
    opt_state, metrics): :func:`make_grad_step`'s gradients, then AdamW
    on each rank's blocks, clipped by the global gradient's norm.  With
    ``donate`` (the train loop's, as the reference's ``run`` jits the
    step with ``donate_argnums=(0, 1)``) the update writes the new
    parameters and moments into the tensors of ``params`` and
    ``opt_state`` and returns them; the caller must not read the
    pre-step values from them.  Otherwise it is functional, as the
    reference's ``step_fn`` is."""
    grad_step, model = make_grad_step(cfg, rules)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch, global_batch=None):
        grads, loss, aux = grad_step(params, batch, global_batch)
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state,
            placements=model.placements(), donate=donate)
        metrics = {"loss": loss, **aux, **opt_metrics}
        return params, opt_state, metrics

    return train_step, model


# serve with model-only-sharded params when they fit: inference has no
# optimizer state, so FSDP's per-layer weight all-gathers are pure
# overhead there
SERVING_FIT_GB = 8.0


def serving_rules(cfg: ModelConfig, rules: MeshRules) -> MeshRules:
    if rules.mesh is None:
        return rules
    model_n = max(1, rules.axis_size(rules.model_axis))
    params_gb = cfg.param_count() * 2 / 2 ** 30  # bf16
    if params_gb / model_n <= SERVING_FIT_GB:
        return dataclasses.replace(rules, fsdp_axis=None)
    return rules


# ----------------------------------------------------------------- serve
def make_prefill_step(cfg: ModelConfig, rules: MeshRules):
    """prefill_step(params, batch): (logits, cache), both this rank's
    blocks under a mesh (``Model.prefill``)."""
    model = Model(cfg, rules)

    def prefill_step(params, batch):
        kw = {k: v for k, v in batch.items()
              if k in ("tokens", "embeds", "enc_embeds")}
        return model.prefill(params, **kw)

    return prefill_step, model


def make_decode_step(cfg: ModelConfig, rules: MeshRules):
    """serve_step: ONE new token against a kv/state cache."""
    model = Model(cfg, rules)

    def decode_step(params, cache, token, pos):
        return model.decode(params, cache, token, pos)

    return decode_step, model


# -------------------------------------------------------------- abstract
def abstract_train_state(cfg: ModelConfig, rules: MeshRules,
                         device="cuda") -> Tuple[Any, Any]:
    """(params, opt_state) as fake tensors with placements."""
    params = Model(cfg, rules).abstract(device)
    return params, adamw.abstract_state(params)


def abstract_serve_state(cfg: ModelConfig, rules: MeshRules, shape,
                         device="cuda") -> Tuple[Any, Any]:
    """(params, cache) as fake tensors with placements: the cache holds
    the shape's whole sequence (encoder states up to 4096)."""
    model = Model(cfg, rules)
    cache = model.abstract_cache(shape.global_batch, shape.seq_len,
                                 enc_len=min(shape.seq_len, 4096),
                                 device=device)
    return model.abstract(device), cache
