"""Twins of ``tests/test_arch_smoke.py`` for the port, plus the MoE
token-drop and SSM checks against the reference.

Each architecture runs at its reduced same-family config (2-4 layers,
d_model 64, float32) on the CPU: forward shapes and finite values, one
autograd step that changes the loss (train-mode attention takes the
plain chunked path, since the inputs require grad), and prefill/decode
against the full-sequence logits (1e-4, the reference's tolerance).
Parameters come from the port's own seeded ``Model.init``, inputs from
numpy with a seed.  The reference checks carry the reference's
parameters over with ``params_from_reference`` and hold the port to the
reference's own 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.sharding import NO_MESH as REF_NO_MESH
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.models import NO_MESH, Model
from repro_torch.models import moe, ssm
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

ARCHS = [a for a in ARCH_IDS if a != "blasx_gemm"]
TOL = 2e-4


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    kw = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    return kw


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        m = Model(cfg)
        out[arch] = (cfg, m, m.init(0, device="cpu"))
    return out


# ------------------------------------------------- test_arch_smoke.py twins
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(models, arch):
    cfg, m, params = models[arch]
    B, S = 2, 12
    logits, aux = m.train_logits(params, **_inputs(cfg, B, S))
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    if cfg.family == "moe":
        assert "moe_aux_loss" in aux and np.isfinite(float(aux["moe_aux_loss"]))
    if cfg.mtp:
        assert tuple(aux["mtp_logits"].shape) == (B, S, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_reduces_loss_direction(models, arch):
    """One SGD step on the CE loss must produce finite grads that change
    the loss (sanity of the whole differentiable path)."""
    cfg, m, params = models[arch]
    kw = _inputs(cfg)
    tokens = kw["tokens"]

    def trainable(tree):
        if isinstance(tree, dict):
            return {k: trainable(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(True)

    def loss_fn(p):
        logits, aux = m.train_logits(p, **kw)
        lg = logits[:, :-1].float()
        ce = torch.nn.functional.cross_entropy(
            lg.reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1))
        if "moe_aux_loss" in aux:
            ce = ce + 0.01 * aux["moe_aux_loss"]
        return ce

    p = trainable(params)
    loss = loss_fn(p)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    grads = [x.grad if x.grad is not None else torch.zeros_like(x)
             for x in _leaves(p)]
    gnorm = sum(float(torch.sum(g.float() ** 2)) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0
    with torch.no_grad():
        stepped = iter([x - 0.3 * g for x, g in zip(_leaves(p), grads)])

        def rebuild(tree):
            return {k: rebuild(v) if isinstance(v, dict) else next(stepped)
                    for k, v in tree.items()}
        p2 = rebuild(p)
        loss2 = loss_fn(p2)
    assert float(loss2) != float(loss.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_train_logits(models, arch):
    cfg, m, params = models[arch]
    B, S = 2, 12
    kw = _inputs(cfg, B, S)
    tokens = kw["tokens"]
    full, _ = m.train_logits(params, **kw)
    kw_p = dict(kw)
    kw_p["tokens"] = tokens[:, :S - 2]
    lg, cache = m.prefill(params, **kw_p)
    _close(lg[:, 0], full[:, S - 3], 1e-4)
    cache = m.pad_cache(cache, S)
    for t in range(S - 2, S):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg2, cache = m.decode(params, cache, tokens[:, t], pos)
        _close(lg2, full[:, t], 1e-4)


def test_full_config_param_counts():
    """Full (non-reduced) configs must hit the published sizes."""
    expect = {
        "deepseek_v3_671b": (671e9, 0.01),
        "olmoe_1b_7b": (6.9e9, 0.02),
        "qwen3_0_6b": (0.6e9, 0.05),
        "glm4_9b": (9.4e9, 0.05),
        "phi3_medium_14b": (14e9, 0.06),
        "olmo_1b": (1.2e9, 0.1),
    }
    for arch, (want, tol) in expect.items():
        got = get_config(arch).param_count()
        assert abs(got - want) / want < tol + 0.05, (arch, got, want)


def test_moe_active_params():
    c = get_config("deepseek_v3_671b")
    assert 30e9 < c.active_param_count() < 45e9  # paper: 37B activated


def test_long_context_support_flags():
    for arch in ARCHS:
        cfg = get_config(arch)
        ok, why = cell_supported(cfg, SHAPES["long_500k"])
        if arch in ("zamba2_2_7b", "mamba2_780m"):
            assert ok
        else:
            assert not ok and "sub-quadratic" in why


def test_ssm_chunked_equals_sequential():
    """SSD chunked scan == naive recurrence (the duality itself)."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 24, 3, 4, 5
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, (B, S, H)).astype(np.float32)
    a_log = rng.uniform(-1, 0.5, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    y, hlast = ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a_log, Bm,
                                                        Cm)), chunk=8)
    h = np.zeros((B, H, P, N), np.float32)
    ys = []
    for t in range(S):
        a = np.exp(-np.exp(a_log) * dt[:, t])
        upd = np.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t][..., None],
                        Bm[:, t])
        h = h * a[..., None, None] + upd
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    _close(y, np.stack(ys, axis=1))
    _close(hlast, h)
    assert hlast.dtype == torch.float32


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v3_671b",
                                  "zamba2_2_7b", "seamless_m4t_medium"])
def test_flash_backend_matches_sdpa_backend(models, arch):
    """Every family with GQA self-attention reaches the flash wrapper at
    prefill (its plain version on the CPU); MLA never does.  Logits
    under the two backends agree."""
    import repro_torch.kernels.flash_attention as kfa
    from repro_torch.models import attention as attn
    cfg, m, params = models[arch]
    kw = _inputs(cfg, 2, 16, seed=3)
    shapes = {}
    try:
        attn.ATTENTION_BACKEND = "sdpa"
        sdpa, _ = m.train_logits(params, **kw)
        attn.ATTENTION_BACKEND = "flash"
        real = kfa.flash_attention

        def seen(q, k, v, *, causal=True, scale=None):
            key = kfa.shape_key(q.shape[-1], causal)
            shapes[key] = shapes.get(key, 0) + 1
            return real(q, k, v, causal=causal, scale=scale)
        kfa.flash_attention = seen
        flash, _ = m.train_logits(params, **kw)
    finally:
        attn.ATTENTION_BACKEND = "flash"
        kfa.flash_attention = real
    _close(flash, sdpa)
    # one call a self-attention layer: none for MLA, one a shared-block
    # application for the hybrid, the encoder's non-causal
    causal, full = f"d{cfg.resolved_head_dim},causal", \
        f"d{cfg.resolved_head_dim},full"
    if cfg.use_mla:
        want = {}
    elif cfg.family == "hybrid":
        want = {causal: cfg.n_layers // cfg.attn_every}
    elif cfg.family == "encdec":
        want = {full: cfg.n_encoder_layers, causal: cfg.n_layers}
    else:
        want = {causal: cfg.n_layers}
    assert shapes == want


# ------------------------------------------------- MoE drops, the SSM
def _ref_pair(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return (cfg, ref_model, ref_params, Model(cfg),
            params_from_reference(_np_tree(ref_params), torch.float32, "cpu"))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v3_671b"])
def test_moe_with_token_drops_matches_the_reference(arch):
    """capacity_factor 0.5 drops (token, slot)s: the port drops the same
    ones (equal moe_drop_frac, summed over the MoE layers as the
    reference sums it) and its logits, aux loss and decode steps match
    within 2e-4."""
    cfg, ref_model, ref_params, model, params = _ref_pair(
        arch, capacity_factor=0.5)
    rng = np.random.default_rng(4)
    B, S = 2, 12
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, raux = ref_model.train_logits(ref_params, tokens=jnp.asarray(tok))
    got, aux = model.train_logits(params, tokens=torch.from_numpy(tok))
    assert float(raux["moe_drop_frac"]) > 0.1  # tokens were dropped
    assert float(aux["moe_drop_frac"]) == pytest.approx(
        float(raux["moe_drop_frac"]), abs=1e-6)
    _close(got, want)
    _close(aux["moe_aux_loss"], raux["moe_aux_loss"])
    rl, rc = ref_model.prefill(ref_params, tokens=jnp.asarray(tok[:, :10]))
    lg, c = model.prefill(params, tokens=torch.from_numpy(tok[:, :10]))
    _close(lg, rl)
    rc, c = ref_model.pad_cache(rc, S), model.pad_cache(c, S)
    for t in (10, 11):
        pos = np.full((B,), t, np.int32)
        rl, rc = ref_model.decode(ref_params, rc, jnp.asarray(tok[:, t]),
                                  jnp.asarray(pos))
        lg, c = model.decode(params, c, torch.from_numpy(tok[:, t]),
                             torch.from_numpy(pos))
        _close(lg, rl)


def test_moe_block_drops_the_reference_slots():
    """At the block level: the same positions in expert, the same kept
    slots, outputs and aux within 2e-4, with capacity below demand."""
    cfg, _, ref_params, _, params = _ref_pair("olmoe_1b_7b",
                                              capacity_factor=0.5)
    p = {k: v[0] if not isinstance(v, dict) else v
         for k, v in params["moe_blocks"]["moe"].items()}
    rp = {k: v[0] for k, v in ref_params["moe_blocks"]["moe"].items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    flat = np.random.default_rng(6).integers(0, cfg.n_experts, 40)
    assert np.array_equal(
        moe._positions_in_expert(torch.from_numpy(flat), cfg.n_experts),
        np.asarray(ref_moe._positions_in_expert(jnp.asarray(flat),
                                                cfg.n_experts)))
    y, aux = moe.moe_block(cfg, p, torch.from_numpy(x), NO_MESH)
    ry, raux = ref_moe.moe_block(cfg, rp, jnp.asarray(x), REF_NO_MESH)
    _close(y, ry)
    assert float(aux["moe_drop_frac"]) == pytest.approx(
        float(raux["moe_drop_frac"]), abs=1e-6)
    assert float(aux["moe_drop_frac"]) > 0
    _close(aux["moe_aux_loss"], raux["moe_aux_loss"])


def test_ssd_chunked_matches_the_reference():
    rng = np.random.default_rng(7)
    B, S, H, P, N = 2, 32, 3, 4, 5
    args = (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.1, 0.9, (B, S, H)).astype(np.float32),
            rng.uniform(-1, 0.5, (H,)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    ry, rh = ref_ssm._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    _close(y, ry)
    _close(h, rh)


def test_ssd_chunked_gradient_is_finite_at_a_full_chunk():
    """At a full chunk of 256 steps with the published decays the sum of
    decays above the diagonal overflows exp (in f32 past ~88).  The
    forward is the reference's; the gradient is finite, where a mask
    applied after the exp (the reference's order) gives 0 * inf = NaN."""
    rng = np.random.default_rng(3)
    B, S, H, P, N, chunk = 1, 256, 2, 4, 8, 256
    args = (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.5, 1.0, (B, S, H)).astype(np.float32),
            np.ones((H,), np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))
    csum = np.cumsum(-np.e * args[1], axis=1)
    assert (csum[:, :1] - csum[:, -1:]).max() > 88   # exp overflows
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = ssm._ssd_chunked(*ins, chunk=chunk)
    ry, rh = ref_ssm._ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    _close(y.detach(), ry)
    _close(h.detach(), rh)
    (y.sum() + h.sum()).backward()
    for t in ins:
        assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_2_7b"])
def test_mamba_block_and_decode_state_match_the_reference(arch):
    """mamba_block at a prompt length that is not a chunk multiple (13,
    chunk 8: the zero-dt padding), then two O(1) decode steps: outputs
    and the conv and f32 ssm states equal the reference's within 2e-4."""
    cfg, _, ref_params, _, params = _ref_pair(arch)
    p = {k: v[0] for k, v in params["blocks"]["mixer"].items()}
    rp = {k: v[0] for k, v in ref_params["blocks"]["mixer"].items()}
    rng = np.random.default_rng(8)
    B, S = 2, 13
    assert S % cfg.ssm_chunk
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y, st = ssm.mamba_block(cfg, p, torch.from_numpy(x), NO_MESH,
                            make_state=True)
    ry, rst = ref_ssm.mamba_block(cfg, rp, jnp.asarray(x), REF_NO_MESH,
                                  make_state=True)
    _close(y, ry)
    assert st["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        _close(st[key], rst[key])
    for _ in range(2):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        y, st2 = ssm.mamba_block(cfg, p, torch.from_numpy(x1), NO_MESH,
                                 state=st)
        ry, rst = ref_ssm.mamba_block(cfg, rp, jnp.asarray(x1),
                                      REF_NO_MESH, state=rst)
        assert st2 is st  # updated in place
        _close(y, ry)
        assert st["ssm"].dtype == torch.float32
        for key in ("conv", "ssm"):
            _close(st[key], rst[key])
