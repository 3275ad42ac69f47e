"""Tensor parallelism on the "model" axis for the SSM mixer (Mamba2,
Zamba2) and MLA (DeepSeek-V3): under a mesh whose model axis divides the
heads, a rank computes its H/n SSM heads and its H/n MLA heads, as the
reference's GSPMD does under its placements.  Gloo ranks, reduced
configs (8 SSM heads, 4 MLA heads; ``in_proj`` 296 columns, so its
contiguous blocks on 2 and 4 ranks cut across z, x, B, C and dt),
float32, through the harness of ``tests/test_torch_tensor_parallel.py``
(``torch_tp_harness``):

* each rank's local shapes on (1, 2), (2, 2), (2, 4) and (1, 3): the
  scan's x and dt of H/n heads with B and C whole, the gated norm's
  d_inner/n, ``out_proj``'s rows d_inner/n; MLA's q, k and v of H/n
  heads into ``wo``'s rows.  On (1, 3) the model axis divides neither
  the heads nor ``in_proj``, so the fitted rule keeps the mixer whole;
* the model-axis all-gathers of a prefill, to the byte: the mixer's
  ``in_proj``, ``conv_w`` and ``conv_b`` blocks (used by parts) and the
  conv state's x channels, never ``wq_b``, ``wkv_b``, ``out_proj`` or
  ``norm``;
* ``FlopCounterMode``'s matmul FLOPs a rank, exactly: one rank's over n
  but for what every rank computes whole (B and C's ``in_proj`` columns
  and their ``Cc.Bc`` scores; MLA's ``wq_a``/``wkv_a``; the router);
* one gradient step's gradients, leaf by leaf, and training from the
  seed, equal to one rank's (parameters within PARAM_ATOL but for the
  few elements whose gradient sits near AdamW's eps, see
  ``torch_tp_harness.NEAR_EPS``), also where the fitted rule holds
  the part leaves whole on "model" (a Mamba2 on (1, 4) whose 4 does not
  divide 2·ssm_state);
* the dry-run's abstract step on a fake (2, 2) group counting a real
  (2, 2) rank's FLOPs;
* a sharded prefill and 4 decodes on (2, 2) equal to one rank's and to
  the reference's jitted prefill/decode on a (2, 2) XLA CPU mesh from
  one tree, each cache block at the reference's shard shape;
* DeepSeek-V3 served on (2, 2) at a capacity factor where every step
  drops slots: the expert-parallel dispatch takes its capacity from
  each data rank's tokens, as the reference's does, so the logits equal
  the reference's jitted (2, 2) prefill and decodes (not one rank's,
  which takes it from the whole batch).
"""
import json

import numpy as np
import pytest

from repro_torch.configs import get_config

from torch_tp_harness import (BATCH, DECODE_STEPS, PROMPT,
                              assert_training_equals_one_rank, close,
                              local_batch, one_rank_serving,
                              one_rank_training, run_served, run_shapes)
from torch_ranks import run_ranks

ARCHS = ("mamba2_780m", "zamba2_2_7b", "deepseek_v3_671b")
# DeepSeek-V3 on (2, 2) at a capacity factor of 0.5: a data rank's 2
# decode tokens give each of the 4 experts one slot, so a step drops
# wherever two of its 4 slots pick one expert
DROPS = (("deepseek_v3_671b", (2, 2), 0.5),)
MESHES = ((1, 2), (2, 2), (2, 4), (1, 3))
MESH_IDS = ("1x2", "2x2", "2x4", "1x3")
F32 = 4
# one gradient step against one rank's, normwise a leaf: float32 sums in
# another order (measured at most 1.03e-5, Zamba2's A_log on (2, 4), a
# sum of terms that nearly cancel; a term left out reads 1e-2 or more)
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_shapes(tmp_path_factory, ARCHS, MESHES)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run_served(tmp_path_factory, ARCHS, DROPS)


def _ways(dim, shape):
    """The fitted rule's model ways for a dim of size ``dim``."""
    m = shape[1]
    return m if m > 1 and dim % m == 0 else 1


def _in_cols(cfg):
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads


def test_the_reduced_blocks_cut_across_the_parts():
    """The reduced mixer's ``in_proj`` (296 columns) and conv channels
    (160) split on 2 and 4 ranks into blocks that cut across z, x, B, C
    and dt, and on 3 not at all, as the heads do not."""
    cfg = get_config("mamba2_780m").reduced()
    assert (_in_cols(cfg), cfg.ssm_heads) == (296, 8)
    for m in (2, 4):
        block = _in_cols(cfg) // m
        assert block * m == _in_cols(cfg)
        assert block % cfg.d_inner and cfg.d_inner % block
    assert _in_cols(cfg) % 3 and cfg.ssm_heads % 3
    assert get_config("deepseek_v3_671b").reduced().n_heads == 4


# ---------------------------------------------------------- local shapes
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_each_rank_computes_its_ssm_heads(ranks, arch, shape):
    """The scan runs on H/n heads (x, dt, A_log) against the whole B and
    C; the gated norm on d_inner/n with ``norm``'s block; ``out_proj``
    takes d_inner/n rows into the row-parallel sum.  On (1, 3) the
    mixer is whole and ``out_proj`` a plain matmul."""
    cfg = get_config(arch).reduced()
    n = _ways(cfg.ssm_heads, shape)
    b, H, P, N = local_batch(shape), cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    di = cfg.d_inner
    for rec in ranks[shape]:
        seen = rec[arch]["seen"]
        ssd = [s[1:] for s in seen if s[0] == "ssd"]
        assert ssd == [[[b, PROMPT, H // n, P], [b, PROMPT, H // n],
                        [H // n], [b, PROMPT, N], [b, PROMPT, N]]] \
            * cfg.n_layers
        gate = [s[1:] for s in seen if s[0] == "gate"]
        assert gate == [[[b, PROMPT, di // n]] * 2 + [[di // n]]] \
            * cfg.n_layers
        rows = [s[1:] for s in seen if s[0] == "ssm_row"]
        assert rows == ([[[b, PROMPT, di // n], [di // n, cfg.d_model],
                          di]] * cfg.n_layers if n > 1 else [])


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_each_rank_computes_its_mla_heads(ranks, shape):
    """MLA's q and k (nope + rope) and v of H/n heads on every layer,
    their output H/n heads wide into ``wo``'s rows (on (1, 3) every
    head, into ``wo``'s whole rows)."""
    cfg = get_config("deepseek_v3_671b").reduced()
    n = _ways(cfg.n_heads, shape)
    b, Hl = local_batch(shape), cfg.n_heads // n
    qh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    vfeat = cfg.n_heads * cfg.v_head_dim
    for rec in ranks[shape]:
        seen = rec["deepseek_v3_671b"]["seen"]
        attn = [s[1:] for s in seen if s[0] == "attn"]
        assert attn == [[[b, PROMPT, Hl, qh]] * 2] * cfg.n_layers
        vs = [s[1] for s in seen if s[0] == "attn_v"]
        assert vs == [[b, PROMPT, Hl, cfg.v_head_dim]] * cfg.n_layers
        wo = [s[1:] for s in seen if s[0] == "mla_wo"]
        rows = vfeat // _ways(vfeat, shape)
        assert wo == [[[b, PROMPT, vfeat // n], [rows, cfg.d_model]]] \
            * cfg.n_layers


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_holds_the_references_cache_block(ranks, arch,
                                                        shape):
    """The SSM state held by heads on "model" (the rank's own), the conv
    state by channels where the model axis divides them, MLA's ``ckv``
    by ``kv_lora_rank``, the batch on "data"."""
    cfg = get_config(arch).reduced()
    b, L = local_batch(shape), cfg.n_layers
    want = {}
    if cfg.family in ("ssm", "hybrid"):
        group = "blocks" if cfg.family == "ssm" else "mamba"
        conv = cfg.d_inner + 2 * cfg.ssm_state
        want[f"['{group}']['conv']"] = [L, b, cfg.ssm_conv - 1,
                                        conv // _ways(conv, shape)]
        want[f"['{group}']['ssm']"] = [
            L, b, cfg.ssm_heads // _ways(cfg.ssm_heads, shape),
            cfg.ssm_head_dim, cfg.ssm_state]
    if cfg.family == "hybrid":
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        heads = ([Hkv // shape[1], hd] if Hkv % shape[1] == 0
                 else [Hkv, hd // _ways(hd, shape)])
        for k in ("k", "v"):
            want[f"['attn']['{k}']"] = [L // cfg.attn_every, b, PROMPT] \
                + heads
    if cfg.use_mla:
        r = cfg.kv_lora_rank
        for group, layers in (("dense_blocks", cfg.n_dense_layers),
                              ("moe_blocks", L - cfg.n_dense_layers)):
            want[f"['{group}']['ckv']"] = [layers, b, PROMPT,
                                           r // _ways(r, shape)]
            want[f"['{group}']['k_rope']"] = [layers, b, PROMPT,
                                              cfg.qk_rope_head_dim]
    for rec in ranks[shape]:
        assert rec[arch]["cache"] == want


def _model_gather_bytes(cfg, shape):
    """The model-axis all-gather bytes a rank sends in a prefill of its
    rows: the mixer's part leaves' blocks and the conv state's x
    channels where the model axis splits the SSM heads; Zamba2's whole
    ``wk``/``wv`` (each shared-block application) where it does not
    split the kv heads; every mixer leaf and MLA's ``wq_b``/``wkv_b``
    placed on "model" where it does not split their heads."""
    m, d = shape[1], cfg.d_model
    total = 0
    if cfg.family in ("ssm", "hybrid"):
        n = _ways(cfg.ssm_heads, shape)
        conv, K, di = cfg.d_inner + 2 * cfg.ssm_state, cfg.ssm_conv, \
            cfg.d_inner
        # (a leaf's size, its dim on "model"): in_proj, conv_w, conv_b,
        # then out_proj and norm
        leaves = [(d * _in_cols(cfg), _in_cols(cfg)), (K * conv, conv),
                  (conv, conv), (di * d, di), (di, di)]
        if n > 1:   # the part leaves, and the conv state's x channels
            leaves = leaves[:3]
            total += local_batch(shape) * (K - 1) * di // n * cfg.n_layers
        total += sum(size // m for size, dim in leaves
                     if _ways(dim, shape) > 1) * cfg.n_layers
    if cfg.family == "hybrid" and cfg.n_kv_heads % m:
        kv = cfg.n_kv_heads * cfg.resolved_head_dim
        total += 2 * d * kv // m * (cfg.n_layers // cfg.attn_every) \
            * (_ways(kv, shape) > 1)
    if cfg.use_mla and _ways(cfg.n_heads, shape) == 1:
        qh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        kvh = cfg.qk_nope_head_dim + cfg.v_head_dim
        for rank, cols in ((cfg.q_lora_rank, cfg.n_heads * qh),
                           (cfg.kv_lora_rank, cfg.n_heads * kvh)):
            if _ways(cols, shape) > 1:
                total += rank * cols // m * cfg.n_layers
    return total * F32


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_gathers_over_model_only_the_part_leaves(ranks, arch,
                                                         shape):
    """A prefill's model-axis all-gathers are, to the byte, the mixer's
    ``in_proj``/``conv_w``/``conv_b`` blocks and the conv state's x
    channels (and Zamba2's whole kv projections on (2, 4), and on (1, 3)
    whatever the fitted rule places on "model" of a whole mixer or MLA):
    ``wq_b``, ``wkv_b``, ``out_proj`` and ``norm`` are consumed as they
    are held wherever the heads split."""
    cfg = get_config(arch).reduced()
    want = _model_gather_bytes(cfg, shape)
    if shape == (2, 2):
        assert want > 0 or cfg.use_mla
    for rec in ranks[shape]:
        got = rec[arch]["collective_bytes"].get("model", {})
        assert got.get("all-gather", 0) == want, got
        assert "other" not in rec[arch]["collectives"]


def _whole_mm(cfg, tokens):
    """The matmul FLOPs of a prefill of ``tokens`` rows that every model
    rank computes whole: B and C's ``in_proj`` columns; MLA's ``wq_a`` and
    ``wkv_a``; the MoE router; Zamba2's kv projections where the model
    axis does not split the kv heads (added by the caller)."""
    d = cfg.d_model
    total = 0
    if cfg.family in ("ssm", "hybrid"):
        total += 2 * tokens * d * 2 * cfg.ssm_state * cfg.n_layers
    if cfg.use_mla:
        total += 2 * tokens * d * (cfg.q_lora_rank + cfg.kv_lora_rank
                                   + cfg.qk_rope_head_dim) * cfg.n_layers
    if cfg.family == "moe":
        total += 2 * tokens * d * cfg.n_experts * (cfg.n_layers
                                                   - cfg.n_dense_layers)
    return total


def _whole_bmm(cfg, batch):
    """The batched-matmul FLOPs every rank computes whole: the SSD
    scan's head-free ``Cc.Bc`` scores, (B, chunks, L, L) over N."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    chunk = min(cfg.ssm_chunk, PROMPT)
    return 2 * batch * (PROMPT // chunk) * chunk * chunk * cfg.ssm_state \
        * cfg.n_layers


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_projections_do_one_nth_of_the_flops(ranks, arch, shape):
    """Exact integers: each kind of matmul counts one rank's FLOPs on the
    same rows over n, apart from what every rank computes whole, which
    counts whole.  So ``in_proj`` does 2·B·S·d·(2·d_inner/n + 2·N + H/n)
    a layer; on (1, 3) every count is one rank's."""
    cfg = get_config(arch).reduced()
    b = local_batch(shape)
    n = _ways(cfg.ssm_heads if cfg.family in ("ssm", "hybrid")
              else cfg.n_heads, shape)
    mm = _whole_mm(cfg, b * PROMPT)
    if cfg.family == "hybrid" and cfg.n_kv_heads % shape[1] and n > 1:
        mm += 2 * 2 * b * PROMPT * cfg.d_model * cfg.n_kv_heads \
            * cfg.resolved_head_dim * (cfg.n_layers // cfg.attn_every)
    whole = {"aten.mm": mm, "aten.bmm": _whole_bmm(cfg, b)}
    for rec in ranks[shape]:
        got, one = rec[arch]["prefill_flops"], rec[arch]["prefill_flops_one"]
        assert set(got) == set(one)
        if n == 1:
            assert got == one
            continue
        for op, total in one.items():
            fixed = whole.get(op, 0)
            assert (total - fixed) % n == 0
            assert got[op] == (total - fixed) // n + fixed, (op, got, one)
        if cfg.family == "ssm":   # in_proj, out_proj, the logits' block
            T, d, di = b * PROMPT, cfg.d_model, cfg.d_inner
            in_proj = 2 * T * d * (2 * di // n + 2 * cfg.ssm_state
                                   + cfg.ssm_heads // n)
            assert got["aten.mm"] == cfg.n_layers * (
                in_proj + 2 * T * di // n * d) + 2 * b * d \
                * cfg.vocab_size // n


# ------------------------------------------------------------- training
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_gradients_equal_one_rank(ranks, arch, shape):
    """One gradient step from the seed: every leaf's gathered gradient
    is one rank's on the global batch, normwise within GRAD_RTOL.  The
    part leaves' gradients are summed over the model group, the inputs
    and weights used by heads (the mixer's input, B and C, ``dt_bias``,
    ``A_log``, ``D``; MLA's ``cq``, ``ckv`` and RoPE key) all-reduced,
    the gated norm's sum of squares summed both ways: a term left out
    would show as an error of order one in some leaf."""
    for rec in ranks[shape]:
        errs = rec[arch]["grad_err"]
        assert set(errs) == set(one_rank_training(arch)[2])
        worst = max(errs.values())
        assert worst <= GRAD_RTOL, {k: v for k, v in errs.items()
                                    if v > GRAD_RTOL}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_training_equals_one_rank(ranks, arch, shape):
    """Three steps on the mesh from the seed give one rank's losses and
    gradient norms within LOSS_RTOL and its (gathered) parameters within
    PARAM_ATOL, but for the few elements whose clipped gradient sits
    within NEAR_EPS of AdamW's eps (``torch_tp_harness``), which the
    gradient twin above holds through their leaves."""
    assert_training_equals_one_rank(ranks[shape], arch, exempt_near_eps=True)


# a rank of (1, 4) on a Mamba2 whose 4 does not divide 2·ssm_state: the
# heads split, but in_proj (274 columns) and the conv (138 channels) are
# held whole on "model"; each rank's one-step gradients against one
# rank's on the same batch
WHOLE_PARTS = f"""
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models.sharding import NO_MESH, gather, rules_for_mesh
from repro_torch.tree import keystr, tree_flatten

rules = rules_for_mesh(init_device_mesh("cpu", (1, 4),
                                        mesh_dim_names=("data", "model")))
cfg = dataclasses.replace(get_config("mamba2_780m").reduced(), ssm_state=5)
grad_step, model = steps.make_grad_step(cfg, rules)
grad_one, one = steps.make_grad_step(cfg, NO_MESH)
tokens = torch.tensor(np.random.default_rng(5).integers(
    0, cfg.vocab_size, ({BATCH}, {PROMPT})), dtype=torch.int32)
batch = {{"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}}
grads, _, _ = grad_step(model.init(0, device="cpu"), batch)
want, _, _ = grad_one(one.init(0, device="cpu"), batch)
places = model.placements()["blocks"]["mixer"]
out = {{"in_proj_spec": places["in_proj"].spec,
       "conv_w_spec": places["conv_w"].spec,
       "err": {{keystr(p): float((gather(g, pl) - w).norm() / w.norm())
               for p, g, pl, w in zip(*tree_flatten(grads),
                                      tree_flatten(model.placements())[1],
                                      tree_flatten(want)[1])}}}}
with open(os.path.join(OUT, f"whole.{{RANK}}.json"), "w") as f:
    json.dump(out, f)
"""


def test_part_leaves_held_whole_on_model_sum_their_gradient(tmp_path):
    """Where the model axis divides the SSM heads but not ``in_proj``'s
    columns or the conv channels (4 against 2·ssm_state = 10), the
    fitted rule holds those leaves whole on "model"; each rank still uses
    its heads' parts of them, so their gradient is all-reduced over the
    model group, and every gradient equals one rank's."""
    run_ranks(tmp_path, 4, WHOLE_PARTS)
    for r in range(4):
        with open(tmp_path / f"whole.{r}.json") as f:
            rec = json.load(f)
        assert rec["in_proj_spec"] == [None, None, None]
        assert rec["conv_w_spec"] == [None, None, None]
        bad = {k: v for k, v in rec["err"].items() if v > GRAD_RTOL}
        assert not bad, bad


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_traces_a_ranks_flops(ranks, arch):
    """The dry-run's abstract mode, as rank 0 of a fake (2, 2) group on
    fake tensors, counts the matmul FLOPs that ``FlopCounterMode`` counts
    over a real gradient step of a (2, 2) gloo rank on the same shapes
    (the optimizer adds none)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models.sharding import rules_for_mesh
    cfg = get_config(arch).reduced()
    with dryrun.fake_group(4):
        rules = rules_for_mesh(make_mesh_for_devices(4, 2, device="cpu"))
        traced = dryrun.trace_step(
            cfg, ShapeConfig("tp", PROMPT, BATCH, "train"), rules,
            device="cpu")
    real = ranks[(2, 2)][0][arch]["grad_flops"]
    assert traced["flops"] == sum(real.values()) > 0


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_one_rank(served, arch):
    """The prefill's last logits and 4 decodes' on (2, 2), gathered over
    vocab and batch, equal one rank's from the same tree: the decode
    reads the whole conv state's parts and writes its block back, and
    updates its heads' SSM state; MLA's absorbed decode runs on the
    rank's ``wkv_b`` block against the whole ``ckv``."""
    ref, port = served
    tree, prompt, toks, _, _ = ref[arch]
    cfg = get_config(arch).reduced()
    want = one_rank_serving(arch, tree, prompt, toks)
    for rank in port:
        got, _ = rank[arch]
        assert len(got) == DECODE_STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (BATCH, cfg.vocab_size)
            assert close(g, w), (i, np.abs(g - w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_the_references(served, arch):
    """The same logits equal the reference's jitted prefill and decodes
    on a (2, 2) XLA mesh from the same tree, and each rank holds every
    cache block (the conv and SSM states, MLA's ``ckv``/``k_rope``,
    Zamba2's K/V) at the reference's cache shard shape."""
    ref, port = served
    _, _, _, want, shards = ref[arch]
    for rank in port:
        got, held = rank[arch]
        for i, (g, w) in enumerate(zip(got, want)):
            assert close(g, w), (i, np.abs(g - w).max())
        assert held == shards


def test_expert_parallel_serving_keeps_the_references_local_capacity(
        served):
    """DeepSeek-V3 served on (2, 2) at a capacity factor of 0.5: every
    step drops slots (counted exactly, summed over the ranks), each data
    rank's capacity and slot order are its own tokens' as in the
    reference's ``_moe_block_sharded``, and the logits equal the
    reference's jitted (2, 2) prefill and decodes from the same tree."""
    arch = DROPS[0][0]
    ref, port = served
    _, _, _, want = ref[("drops", arch)]
    for rank in port:
        got, drops = rank[("drops", arch)]
        assert len(drops) == DECODE_STEPS + 1
        assert all(n > 0 for n in drops), drops
        for i, (g, w) in enumerate(zip(got, want)):
            assert close(g, w), (i, np.abs(g - w).max())
