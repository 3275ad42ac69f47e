"""Tensor parallelism on the "model" axis: under a mesh a layer gathers
its leaves over the batch/FSDP axes only and computes on its model
blocks (q heads, the MLP's ff width, the vocab, the experts), as the
reference's GSPMD does under its constraints.  Gloo ranks
(``torch_ranks.run_ranks``), reduced configs, float32.

* each rank's local shapes on (1, 2), (2, 2) and (2, 4) for Qwen3 and
  OLMoE (the reduced configs' 2 kv heads do not divide 4: on (2, 4) k/v
  are projected whole and each rank picks the kv heads its q heads
  read, and its cache holds its block of the head dim);
* no all-gather on the model axis in a dense layer's forward where the
  kv heads split (on (2, 4), only ``wk``/``wv``'s, one each a layer);
* ``FlopCounterMode``'s matmul FLOPs a rank, exactly, as integers: one
  rank's on the same local batch divided by n for the split
  projections;
* training on each mesh equal to one rank's (the twins' limits of
  ``tests/test_torch_fsdp.py``);
* a sharded prefill and 4 decode steps on (2, 2) against one rank and
  against the reference's jitted prefill/decode on a (2, 2) XLA CPU mesh
  from the same tree, each rank's cache block at the reference's cache
  shard shape;
* OLMoE served on (4, 1) at a capacity factor where slots drop, in the
  dense dispatch (the model axis of 1 splits no expert): its capacity
  and slot order are the global batch's, so the same slots drop as on
  one rank and the logits equal one rank's and the reference's jitted
  (4, 1) prefill and decodes.
"""
import numpy as np
import pytest

from repro_torch.configs import get_config

from torch_tp_harness import (BATCH, DECODE_STEPS, PROMPT,
                              assert_training_equals_one_rank, close,
                              local_batch, one_rank_serving,
                              one_rank_serving_drops, run_served, run_shapes)

ARCHS = ("qwen3_0_6b", "olmoe_1b_7b")
# OLMoE on (4, 1) at a capacity factor of 0.5: each expert takes half its
# mean share of the slots, so the prefill and every decode drop some
DROPS = (("olmoe_1b_7b", (4, 1), 0.5),)
MESHES = ((1, 2), (2, 2), (2, 4))
MESH_IDS = ("1x2", "2x2", "2x4")


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: [each rank's record]} from the harness's rank body on
    every mesh."""
    return run_shapes(tmp_path_factory, ARCHS, MESHES)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run_served(tmp_path_factory, ARCHS, DROPS)


# ---------------------------------------------------------- local shapes
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_computes_its_model_block(ranks, arch, shape):
    """q heads H/n, the MLP's hidden ff/n (Qwen3) or E/n experts
    (OLMoE), logits V/n, attention's output H/n heads into ``wo``'s
    rows; k/v of Hkv/n heads where n divides Hkv, else the kv heads this
    rank's q heads read (one, on (2, 4))."""
    cfg = get_config(arch).reduced()
    n = shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = local_batch(shape)
    kv = Hkv // n if Hkv % n == 0 else max(1, H // n // (H // Hkv))
    for rec in ranks[shape]:
        rec = rec[arch]
        seen = rec["seen"]
        attn = [s for s in seen if s[0] == "attn"]
        assert len(attn) == cfg.n_layers
        for _, q, k in attn:
            assert q == [b, PROMPT, H // n, hd] and k == [b, PROMPT, kv, hd]
        rows = [s for s in seen if s[0] == "row"]
        assert [1 for r in rows if r[3] == H * hd] == [1] * cfg.n_layers
        for _, x, w, f in rows:
            assert x[-1] == f // n and w == [f // n, cfg.d_model]
        if cfg.family == "moe":
            experts = [s[1] for s in seen if s[0] == "experts"]
            assert experts == [[cfg.n_experts // n, cfg.d_model,
                                cfg.moe_d_ff]] * cfg.n_layers
        else:
            assert sorted(r[3] for r in rows) == sorted(
                [H * hd] * cfg.n_layers + [cfg.d_ff] * cfg.n_layers)
        assert rec["logits"] == [b, 1, cfg.vocab_size // n]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_holds_the_references_cache_block(ranks, arch, shape):
    """The prefill's cache leaves are this rank's blocks at the
    reference's cache placement: kv heads on "model" where n divides
    them, else the head dim; the batch on "data"."""
    cfg = get_config(arch).reduced()
    n = shape[1]
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    heads = [Hkv // n, hd] if Hkv % n == 0 else [Hkv, hd // n]
    want = [cfg.n_layers, local_batch(shape), PROMPT] + heads
    group = "blocks" if cfg.family == "dense" else "moe_blocks"
    for rec in ranks[shape]:
        assert rec[arch]["cache"] == {f"['{group}']['{k}']": want
                                      for k in ("k", "v")}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_makes_no_model_axis_all_gather(ranks, arch, shape):
    """A layer gathers its leaves over "data" only: no all-gather on the
    model axis where n divides the kv heads, and on (2, 4) one each for
    ``wk`` and ``wv`` a layer (the whole kv projections the reference's
    fitted "kv" leaves)."""
    cfg = get_config(arch).reduced()
    whole_kv = cfg.n_kv_heads % shape[1] != 0
    for rec in ranks[shape]:
        coll = rec[arch]["collectives"]
        got = coll.get("model", {}).get("all_gather", 0)
        assert got == (2 * cfg.n_layers if whole_kv else 0), coll
        # the row-parallel sums and the vocab-parallel lookup
        assert coll["model"]["all_reduce"] >= 2 * cfg.n_layers + 1
        assert "other" not in coll


def _unsplit_mm(cfg, shape, tokens):
    """The matmul FLOPs of a prefill that no model rank splits: the
    MoE router (its (d, E) weight has no model dim) and, where n does
    not divide the kv heads, the whole k/v projections."""
    hd = cfg.resolved_head_dim
    fixed = 0
    if cfg.family == "moe":
        fixed += 2 * tokens * cfg.d_model * cfg.n_experts * cfg.n_layers
    if cfg.n_kv_heads % shape[1]:
        fixed += 2 * 2 * tokens * cfg.d_model * cfg.n_kv_heads * hd \
            * cfg.n_layers
    return fixed


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_projections_do_one_nth_of_the_flops(ranks, arch, shape):
    """``FlopCounterMode`` on a prefill of this rank's rows: each kind of
    matmul (``mm``: projections and logits; ``bmm``: attention and the
    experts) counts exactly one rank's FLOPs on the same rows over n,
    apart from the unsplit router and whole kv projections, which count
    whole."""
    cfg = get_config(arch).reduced()
    n = shape[1]
    fixed = _unsplit_mm(cfg, shape, local_batch(shape) * PROMPT)
    for rec in ranks[shape]:
        got, one = rec[arch]["prefill_flops"], rec[arch]["prefill_flops_one"]
        assert set(got) == set(one)
        for op, total in one.items():
            rest = total - (fixed if op == "aten.mm" else 0)
            assert rest % n == 0
            assert got[op] == rest // n + (fixed if op == "aten.mm"
                                           else 0), (op, got, one)


@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_dense_gradient_step_does_one_nth_of_the_flops(ranks, shape):
    """Where n divides every head count, a dense gradient step (its
    forward, the recomputed remat forward and the backward, the
    vocab-parallel loss) does exactly one rank's matmul FLOPs over n."""
    n = shape[1]
    for rec in ranks[shape]:
        got, one = (rec["qwen3_0_6b"][k] for k in ("grad_flops",
                                                    "grad_flops_one"))
        assert sum(got.values()) * n == sum(one.values()), (got, one)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_training_equals_one_rank(ranks, arch, shape):
    """Three steps on the mesh from the seed give one rank's losses,
    gradient norms and (gathered) parameters: the model blocks'
    gradients, the replicated weights used by block (the whole k/v
    projections and qk-norms on (2, 4)) all-reduced, the vocab-parallel
    loss's."""
    assert_training_equals_one_rank(ranks[shape], arch)


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_one_rank(served, arch):
    """The prefill's last logits and 4 decodes' on (2, 2), gathered over
    vocab and batch, equal one rank's from the same tree."""
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
    on a (2, 2) XLA mesh from the same tree, and each rank holds its
    cache block at the reference's cache shard shape."""
    ref, port = served
    _, _, _, want, shards = ref[arch]
    for rank in port:
        got, held = rank[arch]
        for i, (g, w) in enumerate(zip(got, want)):
            assert close(g, w), (i, np.abs(g - w).max())
        assert held == shards


def test_a_batch_the_data_axis_does_not_split_holds_the_sequence_on_data(
        served):
    """One sequence that every rank of (2, 2) holds whole
    (``global_batch=1``): the cache keeps the reference's placement for a
    batch the data axis does not divide, the sequence on "data" and the
    kv heads on "model"; decode gathers the sequence and writes its block
    back, and the logits equal one rank's."""
    ref, port = served
    tree, prompt, toks, _, _ = ref["qwen3_0_6b"]
    cfg = get_config("qwen3_0_6b").reduced()
    want = one_rank_serving("qwen3_0_6b", tree, prompt[:1],
                             [t[:1] for t in toks])
    shape = [cfg.n_layers, 1, (PROMPT + DECODE_STEPS) // 2,
             cfg.n_kv_heads // 2, cfg.resolved_head_dim]
    for rank in port:
        got, held = rank["single"]
        assert held == {"['blocks']['k']": shape, "['blocks']['v']": shape}
        for i, (g, w) in enumerate(zip(got, want)):
            assert close(g, w), (i, np.abs(g - w).max())


@pytest.mark.parametrize("against", ("one_rank", "reference"))
def test_split_serving_batch_drops_the_global_batchs_slots(served, against):
    """OLMoE served on (4, 1), each rank its row of the batch, at a
    capacity factor of 0.5: the dense dispatch takes its capacity and
    slot order from the global batch, so every step drops the slots one
    rank drops (counted exactly, summed over the ranks; some in the
    prefill and in each decode), and the logits equal one rank's and the
    reference's jitted (4, 1) prefill and decodes from the same tree."""
    arch, _, factor = DROPS[0]
    ref, port = served
    tree, prompt, toks, ref_logits = ref[("drops", arch)]
    want, want_drops = one_rank_serving_drops(arch, tree, prompt, toks,
                                              factor)
    assert all(n > 0 for n in want_drops), want_drops
    if against == "reference":
        want = ref_logits
    for rank in port:
        got, drops = rank[("drops", arch)]
        assert drops == want_drops
        assert len(got) == DECODE_STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert close(g, w), (i, np.abs(g - w).max())
