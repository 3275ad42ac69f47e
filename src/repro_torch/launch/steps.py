"""Train / prefill / decode steps.

The counterpart of the reference's ``launch/steps.py``.  A train step
runs the forward pass and autograd's backward pass eagerly, averages the
gradients over the mesh's batch axes (each data rank holds its slice of
the global batch), and applies AdamW.  The shape-only inputs and states
the dry-run lowers against (``input_specs``, ``abstract_*``) come with
the dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.distributed import all_reduce
from ..models import Model
from ..models.sharding import MeshRules
from ..optim import adamw
from ..tree import tree_flatten, tree_map, tree_unflatten

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3

# the CE loss runs over sequence chunks: the (B, S, V) f32 logits are the
# largest buffer of a train step, and each chunk's are recomputed in the
# backward pass instead of kept (the reference's CHUNKED_CE path; its
# unchunked alternative, a toggle it never turns off, is not ported)
CE_CHUNKS = 16

# what the shape-only inputs and states need
DRY_RUN = ("shape-only inputs and states come with the dry-run slice "
           "(launch/dryrun.py, abstract mode)")


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
                labels: torch.Tensor, rules: MeshRules, mask=None,
                n_chunks: int = CE_CHUNKS) -> torch.Tensor:
    """Mean next-token CE without a full logits tensor.  ``mask``
    (B, S) of {0,1} optionally excludes positions.  Each chunk's logits
    are the stored values' products summed in f32, as the reference's
    ``preferred_element_type=f32`` dot."""
    B, S, d = hidden.shape
    while S % n_chunks != 0 and n_chunks > 1:
        n_chunks //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    w32 = head.to(hidden.dtype).float()
    cs = S // n_chunks

    def body(h, lab, m, w):
        logits = rules.constrain(torch.matmul(h.float(), w),
                                 "batch", "seq", "model")
        lg = torch.log_softmax(logits, dim=-1)
        return -(torch.gather(lg, -1, lab[..., None].long())[..., 0]
                 * m).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
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


def _mean_over_batch_axes(t: torch.Tensor, rules: MeshRules
                          ) -> torch.Tensor:
    for ax in rules.batch_axes:
        if rules.axis_size(ax) > 1:
            t = all_reduce(t, rules.group(ax))
    return t / rules.axis_size(rules.batch_axes)


# ---------------------------------------------------------------- specs
def input_specs(cfg: ModelConfig, shape, rules: MeshRules):
    raise NotImplementedError(DRY_RUN)


# ---------------------------------------------------------------- train
def make_train_step(cfg: ModelConfig, rules: MeshRules,
                    opt_cfg: Optional[adamw.AdamWConfig] = None):
    """(train_step, model).  ``train_step(params, opt_state, batch,
    global_batch=None)`` takes this rank's batch (tensors on the
    parameters' device) and returns (params, opt_state, metrics);
    ``global_batch`` (default: the local batch's size) says whether the
    data ranks split it (:func:`data_parallel`), in which case the
    gradients and the logged loss are averaged over the batch axes."""
    model = Model(cfg, rules)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss_fn(params, batch):
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
        ce = _chunked_ce(hidden, head, labels, rules)
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
            mtp_ce = _chunked_ce(aux["mtp_hidden"], head, l2, rules,
                                 mask=m2)
            loss = loss + MTP_WEIGHT * mtp_ce
        return loss, {"ce": ce}

    def train_step(params, opt_state, batch, global_batch=None):
        paths, leaves = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, aux = loss_fn(tree_unflatten(paths, live), batch)
            grads = torch.autograd.grad(loss, live)
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        n_local = next(iter(batch.values())).shape[0]
        if data_parallel(rules, global_batch or n_local):
            grads = [_mean_over_batch_axes(g, rules) for g in grads]
            loss = _mean_over_batch_axes(loss, rules)
            aux = tree_map(lambda v: _mean_over_batch_axes(v, rules), aux)
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, tree_unflatten(paths, grads), opt_state)
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
def abstract_train_state(cfg: ModelConfig, rules: MeshRules) -> Any:
    raise NotImplementedError(DRY_RUN)


def abstract_serve_state(cfg: ModelConfig, rules: MeshRules, shape) -> Any:
    raise NotImplementedError(DRY_RUN)
