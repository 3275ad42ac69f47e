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


@pytest.mark.parametrize("case", ["olmoe_1b_7b", "mamba2_780m",
                                  "zamba2_2_7b", "seamless_m4t_medium",
                                  "deepseek_v3_671b", "mesh", "moe_sharded"])
def test_unported_families_and_meshes_raise(case):
    """The five families build.  Meshes no longer raise:
    ``rules_for_mesh`` maps a mesh's axes as the reference does, and
    the MoE block keeps the dense dispatch unless
    the model axis is wider than 1 and divides the experts, as the
    reference's does (the sharded branch itself is held in gloo ranks,
    ``test_torch_distributed.py``).  What still raises: shape-only
    parameters outside an active ``FakeTensorMode`` (the dry-run's
    abstract mode never allocates)."""
    from types import SimpleNamespace

    from repro_torch.models import moe
    from repro_torch.models.layers import Maker
    from repro_torch.models.sharding import MeshRules
    if case == "mesh":
        assert rules_for_mesh(None) is NO_MESH
        mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=(2, 4))
        rules = rules_for_mesh(mesh)
        assert (rules.batch_axes, rules.fsdp_axis, rules.model_axis) == (
            ("data",), "data", "model")
        assert rules.axis_size("model") == 4 and rules.batch_size_divides(6)
        with pytest.raises(RuntimeError, match="FakeTensorMode"):
            Maker("abstract", rules, torch.float32)
        return
    if case == "moe_sharded":
        cfg = get_config("olmoe_1b_7b").reduced()
        p = _layer0(build_params(cfg, "init", NO_MESH, device="cpu")
                    ["moe_blocks"])["moe"]
        x = torch.randn((1, 3, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
        y0, aux0 = moe.moe_block(cfg, p, x, NO_MESH)
        assert tuple(y0.shape) == (1, 3, cfg.d_model)
        for model_n in (1, 3):      # 1, or one that does not divide E = 8
            mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                                   shape=(2, model_n))
            y, aux = moe.moe_block(cfg, p, x, MeshRules(mesh=mesh))
            assert torch.equal(y, y0)
            assert torch.equal(aux["moe_aux_loss"], aux0["moe_aux_loss"])
        return
    cfg = get_config(case).reduced()
    params = build_params(cfg, "init", NO_MESH, device="cpu")
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)


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


def test_train_mode_forward_keeps_grad_fn_off_the_flash_kernel(
        pair, monkeypatch):
    """The flash kernel has no backward (nor has the reference's), so a
    forward whose inputs require grad takes the plain chunked path under
    the default "flash" backend: its logits keep a ``grad_fn``, every
    weight gets a gradient, and the kernel's wrapper is never reached.
    Under ``torch.no_grad()`` the same call goes to the wrapper."""
    import repro_torch.kernels.flash_attention as kfa
    cfg, _, _, model, params = pair
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=5))
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    real = kfa.flash_attention
    monkeypatch.setattr(kfa, "flash_attention", counted)
    assert attn.ATTENTION_BACKEND == "flash"

    def trainable(tree):
        if isinstance(tree, dict):
            return {k: trainable(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(True)

    train = trainable(params)
    logits, _ = model.train_logits(train, tokens=tok)
    assert logits.grad_fn is not None and calls == []
    logits.square().mean().backward()
    wq = train["blocks"]["attn"]["wq"]
    assert wq.grad is not None and bool(wq.grad.abs().sum() > 0)
    with torch.no_grad():
        want, _ = model.train_logits(train, tokens=tok)
    assert calls  # no grad: the kernel's wrapper (its plain version here)
    _close(logits.detach(), want)


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


# ------------------------------------------------- every family, held
FAMILY_ARCHS = [a for a in ARCH_IDS if a != "blasx_gemm"]


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flat_shapes(v, key) if isinstance(v, dict)
                   else {key: tuple(v.shape)})
    return out


@pytest.fixture(scope="module")
def family_pairs():
    """arch -> (cfg, reference model, reference params, port model, port
    params) at the reduced config, built on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg = ref_get_config(arch).reduced()
            cfg = get_config(arch).reduced()
            ref_model = RefModel(ref_cfg)
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            cache[arch] = (cfg, ref_model, ref_params, Model(cfg),
                           params_from_reference(_np_tree(ref_params),
                                                 torch.float32, "cpu"))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_init_shapes_equal_the_reference_tree(family_pairs, arch):
    """The port's seeded init builds the reference's tree: same keys,
    same stacked shapes (the MoE router and the SSM's A_log, D and
    dt_bias in float32 whatever the config dtype)."""
    cfg, _, ref_params, model, _ = family_pairs(arch)
    flat_ref = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(ref_params)}
    assert _flat_shapes(model.init(seed=0, device="cpu")) == flat_ref
    bf16 = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    p = build_params(bf16, "init", NO_MESH, device="cpu")
    assert p["embed"].dtype == torch.bfloat16
    if bf16.family == "moe":
        assert p["moe_blocks"]["moe"]["router"].dtype == torch.float32
    if bf16.family in ("ssm", "hybrid"):
        for key in ("A_log", "D", "dt_bias"):
            assert p["blocks"]["mixer"][key].dtype == torch.float32


def _family_inputs(cfg):
    """The family twins' tokens (2 x 12, the last two decoded) and, for
    encdec, encoder states, from a seed."""
    rng = np.random.default_rng(11)
    B, S = 2, 12
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = {"tokens": tok}
    if cfg.family == "encdec":
        kw["enc_embeds"] = rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    return B, S, tok, kw


def _family_logits(model, params, cache_len, kw, tok, to, run):
    """Train logits, prefill logits (10 tokens) and two decodes' logits
    of one package's ``model``, as float32 numpy: ``to`` makes that
    package's arrays from numpy, ``run`` readies its outputs for numpy
    (the two packages' calls differ only in their arrays)."""
    logits, _ = model.train_logits(params, **{k: to(v) for k, v in
                                             kw.items()})
    lg, cache = model.prefill(params, **{k: to(v) for k, v in
                                         dict(kw, tokens=tok[:, :10]).items()})
    out = [logits, lg]
    cache = model.pad_cache(cache, cache_len)
    for t in (10, 11):
        lg, cache = model.decode(params, cache, to(tok[:, t]),
                                 to(np.full((tok.shape[0],), t, np.int32)))
        out.append(lg)
    return [np.asarray(run(x), np.float32) for x in out]


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16_logits_twin(arch, family_pairs):
    """The port's bf16 logits against the reference's bf16 logits from
    the same tree (the reference's float32 init cast to each leaf's
    bf16-config dtype), normwise, within twice the reference's own
    bf16-against-f32 normwise drift on that input plus 1e-3."""
    cfg, ref_model, ref_params, _, _ = family_pairs(arch)
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="bfloat16")
    ref16 = RefModel(ref_cfg)
    dtypes = jax.eval_shape(ref16.init, jax.random.PRNGKey(0))
    tree16 = jax.tree.map(lambda a, s: a.astype(s.dtype), ref_params, dtypes)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    port16 = params_from_reference(_np_tree(tree16), torch.float32, "cpu")
    port16 = jax.tree.map(
        lambda t, s: t.to(torch.bfloat16 if s.dtype == jnp.bfloat16
                          else torch.float32), port16, dtypes)
    _, S, tok, kw = _family_inputs(cfg)
    jx = lambda a: jnp.asarray(a)
    th = lambda a: torch.from_numpy(a)
    ref32 = _family_logits(ref_model, ref_params, S, kw, tok, jx,
                           lambda x: x)
    ref16_lg = _family_logits(ref16, tree16, S, kw, tok, jx, lambda x: x)
    got = _family_logits(Model(cfg16), port16, S, kw, tok, th,
                         lambda x: x.float())
    for i, (g, r16, r32) in enumerate(zip(got, ref16_lg, ref32)):
        assert g.shape == r16.shape
        drift = _normwise(r16, r32)
        assert _normwise(g, r16) <= 2 * drift + 1e-3, (i, _normwise(g, r16),
                                                       drift)


@pytest.mark.parametrize("arch,dtype", [
    pytest.param(a, d, id=a if d == "float32" else f"{a}-bf16")
    for d in ("float32", "bfloat16") for a in FAMILY_ARCHS])
def test_family_logits_match_the_reference(family_pairs, arch, dtype):
    """Train logits (with the MoE aux and DeepSeek's MTP logits),
    prefill logits and two decode steps, port against reference, within
    the reference's 2e-4; the padded caches have the reference's
    shapes.  In bf16 (``-bf16`` ids) the same logits against the
    reference's bf16 logits from the same tree, normwise, within twice
    the reference's own bf16-against-f32 drift on that input + 1e-3."""
    if dtype == "bfloat16":
        _bf16_logits_twin(arch, family_pairs)
        return
    cfg, ref_model, ref_params, model, params = family_pairs(arch)
    B, S, tok, kw = _family_inputs(cfg)
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    th = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    want, raux = ref_model.train_logits(ref_params, **jx(kw))
    got, aux = model.train_logits(params, **th(kw))
    _close(got, want)
    assert sorted(aux) == sorted(raux)
    for key in raux:
        _close(aux[key], raux[key])
    kp = dict(kw, tokens=tok[:, :10])
    rl, rc = ref_model.prefill(ref_params, **jx(kp))
    lg, c = model.prefill(params, **th(kp))
    _close(lg, rl)
    rc, c = ref_model.pad_cache(rc, S), model.pad_cache(c, S)
    assert _flat_shapes(c) == {jax.tree_util.keystr(k): tuple(v.shape)
                               for k, v in
                               jax.tree_util.tree_leaves_with_path(rc)}
    for t in (10, 11):
        pos = np.full((B,), t, np.int32)
        rl, rc = ref_model.decode(ref_params, rc, jnp.asarray(tok[:, t]),
                                  jnp.asarray(pos))
        lg, c = model.decode(params, c, torch.from_numpy(tok[:, t]),
                             torch.from_numpy(pos))
        assert tuple(lg.shape) == (B, cfg.vocab_size)
        _close(lg, rl)


def test_mla_attention_modes_match_the_reference(family_pairs):
    """MLA at the block level: train, prefill (the compressed ckv/k_rope
    cache) and the absorbed decode, each row at its own position in a
    16-long cache, written in place."""
    from repro.models import attention as ref_attention
    cfg, _, ref_params, _, params = family_pairs("deepseek_v3_671b")
    p = _layer0(params["dense_blocks"])["attn"]
    rp = _layer0(ref_params["dense_blocks"])["attn"]
    rng = np.random.default_rng(12)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    y, c = attn.mla_attention(cfg, p, torch.from_numpy(x),
                              torch.from_numpy(pos), NO_MESH,
                              make_cache=True)
    ry, rc = ref_attention.mla_attention(cfg, rp, jnp.asarray(x),
                                         jnp.asarray(pos), REF_NO_MESH,
                                         make_cache=True)
    _close(y, ry)
    for key in ("ckv", "k_rope"):
        _close(c[key], rc[key])
    smax = 16
    ckv = rng.standard_normal((B, smax, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, smax, cfg.qk_rope_head_dim)).astype(
        np.float32)
    idx = np.array([3, 12], np.int32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = {"ckv": torch.from_numpy(ckv.copy()),
             "k_rope": torch.from_numpy(kr.copy())}
    y, c = attn.mla_attention(cfg, p, torch.from_numpy(x1),
                              torch.from_numpy(idx[:, None]), NO_MESH,
                              cache=cache, cache_index=torch.from_numpy(idx))
    ry, rc = ref_attention.mla_attention(
        cfg, rp, jnp.asarray(x1), jnp.asarray(idx[:, None]), REF_NO_MESH,
        cache={"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
        cache_index=jnp.asarray(idx))
    assert c is cache
    _close(y, ry)
    for key in ("ckv", "k_rope"):
        _close(c[key], rc[key])


@pytest.mark.parametrize("S,causal", [(10, True), (12, True), (11, False)])
def test_chunked_attention_takes_a_ragged_last_chunk(S, causal):
    """Query chunks of 4 over a length 4 does or does not divide equal
    one unchunked call: a ragged last chunk, and causal chunks that read
    the keys up to their last row alone, change no row."""
    g = torch.Generator().manual_seed(S)
    B, H, Hkv, D = 2, 4, 2, 8
    q, k, v = (torch.randn((B, S, h, D), generator=g)
               for h in (H, Hkv, Hkv))
    pos = torch.arange(S, dtype=torch.int32)
    whole = attn._sdpa(q, k, v, qpos=pos, kpos=pos, causal=causal,
                       scale=0.3)
    chunked = attn._sdpa_chunked(q, k, v, qpos=pos, kpos=pos,
                                 causal=causal, scale=0.3, chunk=4)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
