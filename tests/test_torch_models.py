"""The port's dense model stack against the reference's, on the CPU.

Reduced Qwen3 (``get_config("qwen3_0_6b").reduced()``: 2 layers,
d_model 64, 4 query / 2 KV heads of 8, qk-norm, float32).  The
reference builds its parameters with ``jax.random``; they are widened
to float32 numpy arrays and carried over with
``models.convert.params_from_reference``, so both models hold the same
weights.  Inputs are numpy arrays from a seed.  The reference runs as
its own tests run it: XLA attention by default, the Pallas flash kernel
in interpret mode when its ``ATTENTION_BACKEND`` is set to "pallas"
(restored in a ``finally``).  Tolerances are the reference's own
(2e-4 for logits, 1e-4 for the prefill/decode consistency).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.sharding import NO_MESH as REF_NO_MESH
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, NO_MESH, build_params, rules_for_mesh
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.convert import params_from_reference

torch.set_num_threads(1)

TOL = 2e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.fixture(scope="module")
def pair():
    """(cfg, reference model, reference params, port model, port params)
    at the reduced Qwen3 config, with the same weights."""
    ref_cfg = ref_get_config("qwen3_0_6b").reduced()
    cfg = get_config("qwen3_0_6b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = RefModel(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = params_from_reference(_np_tree(ref_params), torch.float32,
                                   "cpu")
    return cfg, ref_model, ref_params, Model(cfg), params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ----------------------------------------------------------------- configs
def test_registry_matches_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config(arch))
        if arch != "blasx_gemm":
            assert dataclasses.asdict(get_config(arch).reduced()) == \
                dataclasses.asdict(ref_get_config(arch).reduced())


def test_param_count_of_the_full_config_equals_the_reference():
    """Computed from the config alone: nothing is allocated."""
    for arch in ARCH_IDS:
        assert get_config(arch).param_count() == \
            ref_get_config(arch).param_count()
    assert get_config("qwen3_0_6b").param_count() == 595984384


def test_init_shapes_equal_the_reference_tree(pair):
    cfg, _, ref_params, model, _ = pair
    mine = model.init(seed=0, device="cpu")
    flat_ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(ref_params)}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict)
                       else {key: tuple(v.shape)})
        return out

    assert flat(mine) == flat_ref
    assert mine["embed"].dtype == torch.float32  # the reduced config's


def test_unported_families_and_meshes_raise():
    for arch in ("olmoe_1b_7b", "mamba2_780m", "zamba2_2_7b",
                 "seamless_m4t_medium", "deepseek_v3_671b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            build_params(get_config(arch).reduced(), "init", NO_MESH,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        rules_for_mesh(object())
    assert rules_for_mesh(None) is NO_MESH


# ------------------------------------------------------------------ layers
def test_norms_rope_and_mlp_match_the_reference(pair):
    cfg, _, ref_params, _, params = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32) * 3
    w = rng.standard_normal(cfg.d_model).astype(np.float32)
    bias = rng.standard_normal(cfg.d_model).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, bias))
    _close(layers.rms_norm(tx, tw, 1e-5),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-5)
    _close(layers.layer_norm(tx, tw, tb),
           ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias)), 1e-5)
    _close(layers.layer_norm(tx, None, None),
           ref_layers.layer_norm(jnp.asarray(x), None, None), 1e-5)
    # rope at (S,) and (B, S) positions
    hx = rng.standard_normal((2, 7, 4, 8)).astype(np.float32)
    for pos in (np.arange(7), np.array([[3], [9]]) + np.arange(7)):
        cos, sin = layers.rope_angles(torch.from_numpy(pos), 8, 1e4)
        rcos, rsin = ref_layers.rope_angles(jnp.asarray(pos), 8, 1e4)
        _close(cos, rcos, 1e-6)
        _close(layers.apply_rope(torch.from_numpy(hx), cos, sin),
               ref_layers.apply_rope(jnp.asarray(hx), rcos, rsin), 1e-5)
    # the MLP of layer 0, silu and gelu (tanh form)
    for act in ("silu", "gelu"):
        c = dataclasses.replace(cfg, act=act)
        _close(layers.mlp(c, _layer0(params["blocks"])["mlp"], tx, NO_MESH),
               ref_layers.mlp(c, _layer0(ref_params["blocks"])["mlp"],
                              jnp.asarray(x), REF_NO_MESH), 1e-5)


# --------------------------------------------------------------- attention
def test_gqa_attention_modes_match_the_reference(pair):
    """train, prefill (make_cache), decode (cache + kv_valid, written in
    place) and cross-attention (with and without a cache)."""
    cfg, _, ref_params, _, params = pair
    p, rp = _layer0(params["blocks"])["attn"], _layer0(ref_params["blocks"])["attn"]
    rng = np.random.default_rng(2)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)

    # train
    y, c = attn.gqa_attention(cfg, p, tx, tpos, NO_MESH)
    ry, rc = ref_attn.gqa_attention(cfg, rp, jnp.asarray(x), jnp.asarray(pos),
                                    REF_NO_MESH)
    assert c is None and rc is None
    _close(y, ry)
    # prefill
    y, c = attn.gqa_attention(cfg, p, tx, tpos, NO_MESH, make_cache=True)
    ry, rc = ref_attn.gqa_attention(cfg, rp, jnp.asarray(x), jnp.asarray(pos),
                                    REF_NO_MESH, make_cache=True)
    _close(y, ry)
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])
    # decode: one token per row at its own position, into a 16-long cache
    smax, hd = 16, cfg.resolved_head_dim
    kc = rng.standard_normal((B, smax, cfg.n_kv_heads, hd)).astype(np.float32)
    vc = rng.standard_normal((B, smax, cfg.n_kv_heads, hd)).astype(np.float32)
    idx = np.array([4, 11], np.int32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    y, c = attn.gqa_attention(cfg, p, torch.from_numpy(x1),
                              torch.from_numpy(idx[:, None]), NO_MESH,
                              cache=cache, cache_index=torch.from_numpy(idx))
    ry, rc = ref_attn.gqa_attention(
        cfg, rp, jnp.asarray(x1), jnp.asarray(idx[:, None]), REF_NO_MESH,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_index=jnp.asarray(idx))
    _close(y, ry)
    assert c is cache  # written in place
    _close(c["k"], rc["k"])
    _close(c["v"], rc["v"])
    # cross-attention: kv from encoder states, no RoPE, not causal
    enc = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    y, c = attn.gqa_attention(cfg, p, tx, tpos, NO_MESH, make_cache=True,
                              causal=False, kv_input=torch.from_numpy(enc))
    ry, rc = ref_attn.gqa_attention(cfg, rp, jnp.asarray(x), jnp.asarray(pos),
                                    REF_NO_MESH, make_cache=True,
                                    causal=False, kv_input=jnp.asarray(enc))
    _close(y, ry)
    # cross decode: K/V come from the cache
    y, _ = attn.gqa_attention(cfg, p, torch.from_numpy(x1), tpos[:1], NO_MESH,
                              cache=c, causal=False,
                              kv_input=torch.from_numpy(x1))
    ry, _ = ref_attn.gqa_attention(cfg, rp, jnp.asarray(x1),
                                   jnp.asarray(pos[:1]), REF_NO_MESH,
                                   cache=rc, causal=False,
                                   kv_input=jnp.asarray(x1))
    _close(y, ry)


# ------------------------------------------------------------------- model
def test_train_prefill_decode_logits_match_the_reference(pair):
    cfg, ref_model, ref_params, model, params = pair
    B, S = 2, 12
    tok = _tokens(cfg, B, S)
    want, _ = ref_model.train_logits(ref_params, tokens=jnp.asarray(tok))
    got, aux = model.train_logits(params, tokens=torch.from_numpy(tok))
    assert got.dtype == torch.float32 and aux == {}
    _close(got, want)
    lg, cache = model.prefill(params, tokens=torch.from_numpy(tok[:, :10]))
    rlg, rcache = ref_model.prefill(ref_params, tokens=jnp.asarray(tok[:, :10]))
    _close(lg, rlg)
    assert tuple(cache["blocks"]["k"].shape) == rcache["blocks"]["k"].shape
    _close(cache["blocks"]["k"], rcache["blocks"]["k"])
    cache = model.pad_cache(cache, S)
    rcache = ref_model.pad_cache(rcache, S)
    assert tuple(cache["blocks"]["v"].shape) == rcache["blocks"]["v"].shape
    pos = np.full((B,), 10, np.int32)
    lg2, _ = model.decode(params, cache, torch.from_numpy(tok[:, 10]),
                          torch.from_numpy(pos))
    rlg2, _ = ref_model.decode(ref_params, rcache, jnp.asarray(tok[:, 10]),
                               jnp.asarray(pos))
    assert tuple(lg2.shape) == (B, cfg.vocab_size)
    _close(lg2, rlg2)


def test_flash_backend_matches_sdpa_backend(pair):
    """Twin of test_flash_backend_matches_xla_backend: the port's two
    backends agree, and each agrees with the reference's two."""
    cfg, ref_model, ref_params, model, params = pair
    tok = _tokens(cfg, 2, 16, seed=3)
    try:
        ref_attn.ATTENTION_BACKEND = "xla"
        ref_xla, _ = ref_model.train_logits(ref_params, tokens=jnp.asarray(tok))
        ref_attn.ATTENTION_BACKEND = "pallas"
        ref_pallas, _ = ref_model.train_logits(ref_params,
                                               tokens=jnp.asarray(tok))
    finally:
        ref_attn.ATTENTION_BACKEND = "xla"
    assert attn.ATTENTION_BACKEND == "flash"  # the port's default
    try:
        attn.ATTENTION_BACKEND = "sdpa"
        sdpa, _ = model.train_logits(params, tokens=torch.from_numpy(tok))
        attn.ATTENTION_BACKEND = "flash"
        flash, _ = model.train_logits(params, tokens=torch.from_numpy(tok))
    finally:
        attn.ATTENTION_BACKEND = "flash"
    _close(flash, sdpa)
    _close(flash, ref_pallas)
    _close(sdpa, ref_xla)


def test_prefill_decode_matches_train_logits(pair):
    """Twin of test_arch_smoke.py::test_prefill_decode_matches_train_logits
    (dense): the prompt's last logits and two decode steps equal the
    full-sequence logits at those positions (1e-4)."""
    cfg, _, _, model, params = pair
    B, S = 2, 12
    tokens = torch.from_numpy(_tokens(cfg, B, S))
    full, _ = model.train_logits(params, tokens=tokens)
    lg, cache = model.prefill(params, tokens=tokens[:, :S - 2])
    _close(lg[:, 0], full[:, S - 3], 1e-4)
    cache = model.pad_cache(cache, S)
    for t in range(S - 2, S):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg2, cache = model.decode(params, cache, tokens[:, t], pos)
        _close(lg2, full[:, t], 1e-4)


def test_params_from_reference_keeps_keys_shapes_and_dtype(pair):
    cfg, _, ref_params, _, _ = pair
    tree = _np_tree(ref_params)
    out = params_from_reference(tree, torch.bfloat16, "cpu")
    assert out["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert tuple(out["blocks"]["mlp"]["wo"].shape) == \
        tree["blocks"]["mlp"]["wo"].shape
    with pytest.raises(TypeError, match="float32"):
        params_from_reference({"w": np.zeros(3, np.float64)}, torch.float32,
                              "cpu")
