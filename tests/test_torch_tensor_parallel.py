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
  shard shape.
"""
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import Model, NO_MESH
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

from torch_ranks import REPO, run_ranks

ARCHS = ("qwen3_0_6b", "olmoe_1b_7b")
MESHES = ((1, 2), (2, 2), (2, 4))
MESH_IDS = ("1x2", "2x2", "2x4")
# prompt and batch of the forward checks; a global batch that every
# mesh's data axis splits
BATCH, PROMPT = 4, 8
DECODE_STEPS = 4
# sharded against one rank and against the reference: the same f32
# arithmetic but for the order of the row-parallel sums and of the
# vocab-parallel softmax's sums, max abs difference against max abs
# logit (the reference's prefill/decode consistency limit)
LOGIT_RTOL = 1e-4
# training against one rank: tests/test_torch_fsdp.py's limits
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-5
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_BATCH, TRAIN_SEQ = 4, 16

# each rank on @MESH@: local shapes seen by the layers, collectives by
# axis and FLOPs of a prefill (with the same prefill of one rank on this
# rank's rows), FLOPs of one gradient step, the cache's held shapes, and
# STEPS train steps' losses and gathered parameters
PORT_SHAPES = f"""
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models import Model, attention, layers, transformer
from repro_torch.models.sharding import NO_MESH, gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

SEEN = []
_sdpa, _flash = attention._sdpa_chunked, kfa.flash_attention
_row, _moe = layers.row_parallel_matmul, transformer.moe_block

def sdpa(q, k, v, *a, **kw):
    SEEN.append(["attn", list(q.shape), list(k.shape)])
    return _sdpa(q, k, v, *a, **kw)

def flash(q, k, v, **kw):
    SEEN.append(["attn", list(q.shape), list(k.shape)])
    return _flash(q, k, v, **kw)

def row(x, w, rules, features):
    SEEN.append(["row", list(x.shape), list(w.shape), features])
    return _row(x, w, rules, features)

def moe_block(cfg, p, x, rules):
    SEEN.append(["experts", list(p["w_gate"].shape)])
    return _moe(cfg, p, x, rules)

attention._sdpa_chunked, kfa.flash_attention = sdpa, flash
layers.row_parallel_matmul = attention.row_parallel_matmul = row
transformer.moe_block = moe_block

def flops(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    counts = fc.get_flop_counts()["Global"]
    counts = {{str(k): int(v) for k, v in counts.items()}}
    return out, counts

shape = tuple(json.loads("@MESH@"))
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
rules = rules_for_mesh(mesh)
out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    rec = out[arch] = {{}}
    model, one = Model(cfg, rules), Model(cfg, NO_MESH)
    params, whole = model.init(0, device="cpu"), one.init(0, device="cpu")
    rows = _batch_rows(rules, {BATCH})
    tokens = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, ({BATCH}, {PROMPT})), dtype=torch.int32)[rows]
    with torch.no_grad():
        del SEEN[:]
        D.reset_collectives()
        (logits, cache), rec["prefill_flops"] = flops(
            lambda: model.prefill(params, tokens=tokens))
        rec["seen"] = list(SEEN)
        rec["collectives"] = {{a: dict(c) for a, c in
                              D.COLLECTIVES_BY_AXIS.items()}}
        rec["logits"] = list(logits.shape)
        rec["cache"] = {{keystr(p): list(t.shape)
                        for p, t in zip(*tree_flatten(cache))}}
        _, rec["prefill_flops_one"] = flops(
            lambda: one.prefill(whole, tokens=tokens))
    labels = torch.roll(tokens, -1, 1)
    grad_step, _ = steps.make_grad_step(cfg, rules)
    grad_one, _ = steps.make_grad_step(cfg, NO_MESH)
    batch = {{"tokens": tokens, "labels": labels}}
    _, rec["grad_flops"] = flops(
        lambda: grad_step(params, batch, global_batch={BATCH}))
    _, rec["grad_flops_one"] = flops(lambda: grad_one(whole, batch))
    # training from the seed, as tests/test_torch_fsdp.py's twins
    step, _ = steps.make_train_step(cfg, rules, adamw.AdamWConfig(**{OPT!r}))
    state = adamw.init_state(params)
    dc = DataConfig(cfg.vocab_size, {TRAIN_SEQ}, {TRAIN_BATCH}, seed=3)
    trows = _batch_rows(rules, {TRAIN_BATCH})
    losses, norms = [], []
    for i in range({STEPS}):
        b = {{k: torch.from_numpy(v[trows])
             for k, v in batch_at_step(dc, i).items()}}
        params, state, m = step(params, state, b,
                                global_batch={TRAIN_BATCH})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    paths, leaves = tree_flatten(params)
    rec["train"] = (losses, norms, {{keystr(p): gather(t, pl).numpy()
                    for p, t, pl in zip(paths, leaves,
                                        tree_flatten(model.placements())[1])}})
with open(os.path.join(OUT, f"shapes.{{RANK}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

# the reference's jitted prefill and DECODE_STEPS decodes on a (2, 2)
# XLA CPU mesh (its XLA attention), from its init; the tree as float32
# numpy, the prompt, the decode tokens, the logits, and the shard shapes
# of its cache placements (Model.abstract_cache)
REF_SERVE = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import Model
from repro.models.sharding import rules_for_mesh

def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)

mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    model = Model(cfg, rules_for_mesh(mesh))
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, ({BATCH}, {PROMPT}))
    toks = rng.integers(0, cfg.vocab_size, ({DECODE_STEPS}, {BATCH}))
    prefill = jax.jit(lambda p, t: model.prefill(p, tokens=t))
    decode = jax.jit(model.decode)
    logits, cache = prefill(params, jnp.asarray(prompt, jnp.int32))
    cache = model.pad_cache(cache, {PROMPT + DECODE_STEPS})
    got = [np.asarray(logits[:, -1], np.float32)]
    for i in range({DECODE_STEPS}):
        pos = jnp.full(({BATCH},), {PROMPT} + i, jnp.int32)
        lg, cache = decode(params, cache, jnp.asarray(toks[i], jnp.int32),
                           pos)
        got.append(np.asarray(lg, np.float32))
    places = model.abstract_cache({BATCH}, {PROMPT + DECODE_STEPS})
    flat, _ = jax.tree_util.tree_flatten_with_path(places)
    shards = {{jax.tree_util.keystr(p): list(s.sharding.shard_shape(s.shape))
              for p, s in flat}}
    out[arch] = (host(params), prompt, toks, got, shards)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

# the port on (2, 2) from the reference's tree (each rank its blocks):
# prefill on its rows, the cache grown to hold the decodes, DECODE_STEPS
# decodes; logits gathered over vocab and batch
PORT_SERVE = f"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.core.distributed import all_gather
from repro_torch.launch.train import _batch_rows
from repro_torch.models import Model
from repro_torch.models.convert import params_from_reference
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.tree import keystr, tree_flatten

with open(os.path.join(OUT, "ref.pkl"), "rb") as f:
    ref = pickle.load(f)
rules = rules_for_mesh(init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "model")))
rows = _batch_rows(rules, {BATCH})

def whole(logits):
    lg = all_gather(logits, rules.group("model"), dim=-1)
    return all_gather(lg, rules.group("data"), dim=0).numpy()

out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    model = Model(cfg, rules)
    tree, prompt, toks, _, _ = ref[arch]
    params = params_from_reference(tree, torch.float32, "cpu",
                                   placements=model.placements())
    with torch.no_grad():
        logits, cache = model.prefill(
            params, tokens=torch.tensor(prompt[rows], dtype=torch.int32))
        cache = model.pad_cache(cache, {PROMPT + DECODE_STEPS})
        held = {{keystr(p): list(t.shape)
                for p, t in zip(*tree_flatten(cache))}}
        got = [whole(logits[:, -1])]
        for i in range({DECODE_STEPS}):
            pos = torch.full((rows.stop - rows.start,), {PROMPT} + i,
                             dtype=torch.int32)
            lg, cache = model.decode(
                params, cache, torch.tensor(toks[i][rows], dtype=torch.int32),
                pos)
            got.append(whole(lg))
    out[arch] = (got, held)
# one sequence held whole by every rank (global_batch=1, which the data
# axis does not divide): the cache's sequence on "data"
tree, prompt, toks, _, _ = ref["qwen3_0_6b"]
model = Model(get_config("qwen3_0_6b").reduced(), rules)
params = params_from_reference(tree, torch.float32, "cpu",
                               placements=model.placements())
with torch.no_grad():
    logits, cache = model.prefill(
        params, tokens=torch.tensor(prompt[:1], dtype=torch.int32),
        global_batch=1)
    cache = model.pad_cache(cache, {PROMPT + DECODE_STEPS})
    held = {{keystr(p): list(t.shape) for p, t in zip(*tree_flatten(cache))}}
    got = [all_gather(logits[:, -1], rules.group("model"), dim=-1).numpy()]
    for i in range({DECODE_STEPS}):
        lg, cache = model.decode(
            params, cache, torch.tensor(toks[i][:1], dtype=torch.int32),
            torch.full((1,), {PROMPT} + i, dtype=torch.int32))
        got.append(all_gather(lg, rules.group("model"), dim=-1).numpy())
out["single"] = (got, held)
with open(os.path.join(OUT, f"serve.{{RANK}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""
PORT_SERVE = "import pickle\n" + PORT_SERVE


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: [each rank's record]} from PORT_SHAPES on every mesh."""
    out = {}
    for shape in MESHES:
        d = tmp_path_factory.mktemp("tp" + "x".join(map(str, shape)))
        world = shape[0] * shape[1]
        run_ranks(d, world, "import pickle\n" + PORT_SHAPES.replace(
            "@MESH@", json.dumps(list(shape))), timeout=600)
        out[shape] = []
        for r in range(world):
            with open(d / f"shapes.{r}.pkl", "rb") as f:
                out[shape].append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    ref = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SERVE),
                          str(d / "ref.pkl")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    run_ranks(d, 4, PORT_SERVE)
    port = []
    for r in range(4):
        with open(d / f"serve.{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    with open(d / "ref.pkl", "rb") as f:
        return pickle.load(f), port


def _local_batch(shape):
    return BATCH // shape[0]


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
    b = _local_batch(shape)
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
    want = [cfg.n_layers, _local_batch(shape), PROMPT] + heads
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
    fixed = _unsplit_mm(cfg, shape, _local_batch(shape) * PROMPT)
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
@functools.lru_cache(maxsize=None)
def _one_rank(arch):
    from repro_torch.data import DataConfig, batch_at_step
    cfg = get_config(arch).reduced()
    step, model = steps.make_train_step(cfg, NO_MESH,
                                        adamw.AdamWConfig(**OPT))
    params = model.init(0, device="cpu")
    state = adamw.init_state(params)
    dc = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=3)
    losses, norms = [], []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_at_step(dc, i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    paths, leaves = tree_flatten(params)
    return losses, norms, {keystr(p): t.numpy() for p, t in
                           zip(paths, leaves)}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_training_equals_one_rank(ranks, arch, shape):
    """Three steps on the mesh from the seed give one rank's losses,
    gradient norms and (gathered) parameters: the model blocks'
    gradients, the replicated weights used by block (the whole k/v
    projections and qk-norms on (2, 4)) all-reduced, the vocab-parallel
    loss's."""
    want_l, want_n, want_p = _one_rank(arch)
    for rec in ranks[shape]:
        losses, norms, whole = rec[arch]["train"]
        np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, want_n, rtol=LOSS_RTOL)
        assert set(whole) == set(want_p)
        for key, got in whole.items():
            np.testing.assert_allclose(got, want_p[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)


# -------------------------------------------------------------- serving
def _close(got, want):
    return np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def _one_rank_serving(arch, tree, prompt, toks):
    """One rank's prefill logits and DECODE_STEPS decodes' logits."""
    cfg = get_config(arch).reduced()
    one = Model(cfg, NO_MESH)
    params = params_from_reference(tree, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = one.prefill(params, tokens=torch.tensor(
            prompt, dtype=torch.int32))
        cache = one.pad_cache(cache, PROMPT + DECODE_STEPS)
        want = [logits[:, -1].numpy()]
        for i in range(DECODE_STEPS):
            lg, cache = one.decode(
                params, cache, torch.tensor(toks[i], dtype=torch.int32),
                torch.full((len(prompt),), PROMPT + i, dtype=torch.int32))
            want.append(lg.numpy())
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_one_rank(served, arch):
    """The prefill's last logits and 4 decodes' on (2, 2), gathered over
    vocab and batch, equal one rank's from the same tree."""
    ref, port = served
    tree, prompt, toks, _, _ = ref[arch]
    cfg = get_config(arch).reduced()
    want = _one_rank_serving(arch, tree, prompt, toks)
    for rank in port:
        got, _ = rank[arch]
        assert len(got) == DECODE_STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (BATCH, cfg.vocab_size)
            assert _close(g, w), (i, np.abs(g - w).max())


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
            assert _close(g, w), (i, np.abs(g - w).max())
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
    want = _one_rank_serving("qwen3_0_6b", tree, prompt[:1],
                             [t[:1] for t in toks])
    shape = [cfg.n_layers, 1, (PROMPT + DECODE_STEPS) // 2,
             cfg.n_kv_heads // 2, cfg.resolved_head_dim]
    for rank in port:
        got, held = rank["single"]
        assert held == {"['blocks']['k']": shape, "['blocks']['v']": shape}
        for i, (g, w) in enumerate(zip(got, want)):
            assert _close(g, w), (i, np.abs(g - w).max())
