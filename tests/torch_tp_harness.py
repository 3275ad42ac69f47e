"""The harness of the port's tensor-parallel twins on the "model" axis
(``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tensor_parallel_mixers.py``): gloo ranks
(``torch_ranks.run_ranks``), reduced configs, float32.

* :func:`run_shapes` runs :func:`port_shapes` on each mesh: each rank's
  local shapes seen by the layers (attention's q/k/v, the SSM scan's
  x/dt/B/C, the gated norm's y/z/weight, the row-parallel matmuls (the
  mixer's and MLA's ``wo`` apart), the experts), its collectives and
  collective bytes by mesh axis and its matmul FLOPs in a prefill of its rows (beside one rank's on the same
  rows), FLOPs of one gradient step and its gathered gradients' normwise
  errors against one rank's, the prefill cache's held shapes, and STEPS
  train steps' losses, norms and gathered parameters;
* :func:`run_served` runs the reference's jitted prefill and
  DECODE_STEPS decodes on a (2, 2) XLA CPU mesh (:func:`ref_serve`)
  and the port on a (2, 2) gloo mesh from the same tree
  (:func:`port_serve`), and each of its ``drops`` runs on its own mesh
  at a capacity factor where slots drop;
* :func:`one_rank_training` and :func:`one_rank_serving` give one
  rank's numbers for the same runs (:func:`one_rank_serving_drops` with
  each step's dropped slots, at a capacity factor of its own).
"""
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import Model, NO_MESH
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

from torch_ranks import REPO, run_ranks

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
# AdamW moves an element by lr * m/(sqrt(v) + eps): where the clipped
# gradient is within a few eps of 0 (but not 0, as an unused token's
# embedding row is on every rank alike), the step follows the gradient's
# value to first order, so the f32 rounding of sums taken in another
# order (a few ulps of its column's scale) moves it by up to ~3e-5 over
# STEPS steps.  The SSM twins exempt such elements from PARAM_ATOL (2
# eps: 21 of Mamba2's 89136, 74 of Zamba2's 176288, 78 of DeepSeek-V3's
# 176448), hold them to the STEPS * lr an update can move them, and
# allow no more than a thousandth of the elements: a dropped gradient
# term moves far more elements, by 1e-3 and more
NEAR_EPS = 2
NEAR_EPS_ATOL = STEPS * OPT["lr"]
NEAR_EPS_SHARE = 1e-3
TRAIN_BATCH, TRAIN_SEQ = 4, 16


def port_shapes(archs) -> str:
    """The rank body recording each arch on the mesh ``@MESH@``."""
    return f"""
import pickle
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models import Model, attention, layers, ssm, transformer
from repro_torch.models.sharding import NO_MESH, gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

SEEN = []
_sdpa, _flash = attention._sdpa_chunked, kfa.flash_attention
_row, _moe = layers.row_parallel_matmul, transformer.moe_block
_ssd, _gate = ssm._ssd_chunked, ssm._gated_norm
_mla_out = attention._mla_out

def sdpa(q, k, v, *a, **kw):
    SEEN.append(["attn", list(q.shape), list(k.shape)])
    SEEN.append(["attn_v", list(v.shape)])
    return _sdpa(q, k, v, *a, **kw)

def flash(q, k, v, **kw):
    SEEN.append(["attn", list(q.shape), list(k.shape)])
    SEEN.append(["attn_v", list(v.shape)])
    return _flash(q, k, v, **kw)

def row(x, w, rules, features):
    SEEN.append(["row", list(x.shape), list(w.shape), features])
    return _row(x, w, rules, features)

def ssm_row(x, w, rules, features):
    SEEN.append(["ssm_row", list(x.shape), list(w.shape), features])
    return _row(x, w, rules, features)

def mla_out(cfg, p, out, rules, n):
    SEEN.append(["mla_wo", list(out.shape), list(p["wo"].shape)])
    return _mla_out(cfg, p, out, rules, n)

def moe_block(cfg, p, x, rules):
    SEEN.append(["experts", list(p["w_gate"].shape)])
    return _moe(cfg, p, x, rules)

def ssd(xh, dt, a_log, Bm, Cm, chunk):
    SEEN.append(["ssd", list(xh.shape), list(dt.shape), list(a_log.shape),
                 list(Bm.shape), list(Cm.shape)])
    return _ssd(xh, dt, a_log, Bm, Cm, chunk)

def gate(y, z, w, *a):
    SEEN.append(["gate", list(y.shape), list(z.shape), list(w.shape)])
    return _gate(y, z, w, *a)

attention._sdpa_chunked, kfa.flash_attention = sdpa, flash
layers.row_parallel_matmul = attention.row_parallel_matmul = row
ssm.row_parallel_matmul = ssm_row
transformer.moe_block = moe_block
ssm._ssd_chunked, ssm._gated_norm = ssd, gate
attention._mla_out = mla_out

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
for arch in {tuple(archs)!r}:
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
        rec["collective_bytes"] = {{a: dict(c) for a, c in
                                   D.COLLECTIVE_BYTES_BY_AXIS.items()}}
        rec["logits"] = list(logits.shape)
        rec["cache"] = {{keystr(p): list(t.shape)
                        for p, t in zip(*tree_flatten(cache))}}
        _, rec["prefill_flops_one"] = flops(
            lambda: one.prefill(whole, tokens=tokens))
    labels = torch.roll(tokens, -1, 1)
    grad_step, _ = steps.make_grad_step(cfg, rules)
    grad_one, _ = steps.make_grad_step(cfg, NO_MESH)
    batch = {{"tokens": tokens, "labels": labels}}
    (grads, _, _), rec["grad_flops"] = flops(
        lambda: grad_step(params, batch, global_batch={BATCH}))
    _, rec["grad_flops_one"] = flops(lambda: grad_one(whole, batch))
    # each gathered gradient against one rank's on the global batch,
    # normwise
    every = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, ({BATCH}, {PROMPT})), dtype=torch.int32)
    want, _, _ = grad_one(whole, {{"tokens": every,
                                   "labels": torch.roll(every, -1, 1)}})
    rec["grad_err"] = {{
        keystr(p): float((gather(g, pl) - w).norm() / w.norm())
        for p, g, pl, w in zip(*tree_flatten(grads),
                               tree_flatten(model.placements())[1],
                               tree_flatten(want)[1])}}
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


def ref_serve(archs, drops=()) -> str:
    """The reference's jitted prefill and DECODE_STEPS decodes on a
    (2, 2) XLA CPU mesh (its XLA attention), from its init; the tree as
    float32 numpy, the prompt, the decode tokens, the logits, and the
    shard shapes of its cache placements (``Model.abstract_cache``).
    Each of ``drops`` (arch, mesh shape, capacity factor) runs again on
    that mesh at that capacity factor, under ``("drops", arch)``."""
    return f"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import Model
from repro.models.sharding import rules_for_mesh

def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)

def serve(cfg, shape):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shape),
                             ("data", "model"))
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
    return model, host(params), prompt, toks, got

out = {{}}
for arch in {tuple(archs)!r}:
    model, *rec = serve(get_config(arch).reduced(), (2, 2))
    places = model.abstract_cache({BATCH}, {PROMPT + DECODE_STEPS})
    flat, _ = jax.tree_util.tree_flatten_with_path(places)
    shards = {{jax.tree_util.keystr(p): list(s.sharding.shard_shape(s.shape))
              for p, s in flat}}
    out[arch] = (*rec, shards)
for arch, shape, factor in {tuple(drops)!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=factor)
    out[("drops", arch)] = tuple(serve(cfg, shape)[1:])
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


# one sequence held whole by every rank (global_batch=1, which the data
# axis does not divide): the cache's sequence on "data"
_SINGLE = f"""
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
"""


def port_serve(archs, drops=()) -> str:
    """The port on (2, 2) from the reference's tree (each rank its
    blocks): prefill on its rows, the cache grown to hold the decodes,
    DECODE_STEPS decodes; logits gathered over vocab and batch.  With
    Qwen3 among ``archs``, also one sequence every rank holds whole.
    Each of ``drops`` runs again on its mesh at its capacity factor,
    with each step's dropped slots summed over the ranks
    (``moe.count_drops``)."""
    body = f"""
import dataclasses, pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.core.distributed import all_gather
from repro_torch.launch.train import _batch_rows
from repro_torch.models import Model, moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.tree import keystr, tree_flatten

with open(os.path.join(OUT, "ref.pkl"), "rb") as f:
    ref = pickle.load(f)

def mesh_rules(shape):
    return rules_for_mesh(init_device_mesh("cpu", shape,
                                           mesh_dim_names=("data", "model")))

def serve(cfg, rules, tree, prompt, toks):
    rows = _batch_rows(rules, {BATCH})

    def whole(logits):
        lg = all_gather(logits, rules.group("model"), dim=-1)
        return all_gather(lg, rules.group("data"), dim=0).numpy()

    def dropped(calls):
        n = sum(calls, torch.zeros((), dtype=torch.long))
        dist.all_reduce(n)
        return int(n)

    model = Model(cfg, rules)
    params = params_from_reference(tree, torch.float32, "cpu",
                                   placements=model.placements())
    with torch.no_grad():
        with moe.count_drops() as calls:
            logits, cache = model.prefill(
                params, tokens=torch.tensor(prompt[rows], dtype=torch.int32))
        drops = [dropped(calls)]
        cache = model.pad_cache(cache, {PROMPT + DECODE_STEPS})
        held = {{keystr(p): list(t.shape)
                for p, t in zip(*tree_flatten(cache))}}
        got = [whole(logits[:, -1])]
        for i in range({DECODE_STEPS}):
            pos = torch.full((rows.stop - rows.start,), {PROMPT} + i,
                             dtype=torch.int32)
            with moe.count_drops() as calls:
                lg, cache = model.decode(
                    params, cache,
                    torch.tensor(toks[i][rows], dtype=torch.int32), pos)
            drops.append(dropped(calls))
            got.append(whole(lg))
    return got, held, drops

rules = mesh_rules((2, 2))
out = {{}}
for arch in {tuple(archs)!r}:
    tree, prompt, toks, _, _ = ref[arch]
    out[arch] = serve(get_config(arch).reduced(), rules, tree, prompt,
                      toks)[:2]
for arch, shape, factor in {tuple(drops)!r}:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=factor)
    tree, prompt, toks, _ = ref[("drops", arch)]
    got, _, drops = serve(cfg, mesh_rules(shape), tree, prompt, toks)
    out[("drops", arch)] = (got, drops)
"""
    if "qwen3_0_6b" in archs:
        body += _SINGLE
    return body + """
with open(os.path.join(OUT, f"serve.{RANK}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def run_shapes(tmp_path_factory, archs, meshes) -> dict:
    """{mesh: [each rank's record]} from :func:`port_shapes` on every
    mesh in ``meshes``."""
    out = {}
    for shape in meshes:
        d = tmp_path_factory.mktemp("tp" + "x".join(map(str, shape)))
        world = shape[0] * shape[1]
        run_ranks(d, world, port_shapes(archs).replace(
            "@MESH@", json.dumps(list(shape))), timeout=600)
        out[shape] = []
        for r in range(world):
            with open(d / f"shapes.{r}.pkl", "rb") as f:
                out[shape].append(pickle.load(f))
    return out


def run_served(tmp_path_factory, archs, drops=()):
    """(the reference's record by arch, [each port rank's record]);
    ``drops``: (arch, mesh shape, capacity factor) runs of both, under
    ``("drops", arch)``."""
    d = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    ref = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(ref_serve(archs, drops)),
                          str(d / "ref.pkl")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    run_ranks(d, 4, port_serve(archs, drops))
    port = []
    for r in range(4):
        with open(d / f"serve.{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    with open(d / "ref.pkl", "rb") as f:
        return pickle.load(f), port


def local_batch(shape):
    return BATCH // shape[0]


@functools.lru_cache(maxsize=None)
def one_rank_training(arch):
    """One rank's STEPS losses, norms and parameters from the seed, and
    for each leaf the mask of its elements near AdamW's eps
    (:func:`assert_training_equals_one_rank`)."""
    from repro_torch.data import DataConfig, batch_at_step
    cfg = get_config(arch).reduced()
    opt = adamw.AdamWConfig(**OPT)
    step, model = steps.make_train_step(cfg, NO_MESH, opt)
    grad_step, _ = steps.make_grad_step(cfg, NO_MESH)
    params = model.init(0, device="cpu")
    state = adamw.init_state(params)
    dc = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=3)
    losses, norms, near = [], [], None
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_at_step(dc, i).items()}
        grads, _, _ = grad_step(params, batch)
        clipped = tree_flatten(adamw.clip_by_global_norm(
            grads, opt.grad_clip)[0])[1]
        hit = [(g != 0) & (g.abs() <= NEAR_EPS * opt.eps) for g in clipped]
        near = hit if near is None else [a | b for a, b in zip(near, hit)]
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    paths, leaves = tree_flatten(params)
    return losses, norms, {keystr(p): t.numpy() for p, t in
                           zip(paths, leaves)}, {
        keystr(p): h.numpy() for p, h in zip(paths, near)}


def assert_training_equals_one_rank(records, arch, exempt_near_eps=False):
    """Each rank's STEPS losses, norms and gathered parameters equal
    one rank's within LOSS_RTOL / PARAM_ATOL.  With ``exempt_near_eps``
    the elements whose clipped one-rank gradient was, at some step,
    nonzero and within NEAR_EPS times AdamW's eps are held to
    NEAR_EPS_ATOL instead, and they must be at most NEAR_EPS_SHARE of
    the elements.  Returns the number of elements so exempted."""
    want_l, want_n, want_p, near = one_rank_training(arch)
    exempt = {k: (v if exempt_near_eps else np.zeros_like(v))
              for k, v in near.items()}
    count = sum(int(v.sum()) for v in exempt.values())
    assert count <= NEAR_EPS_SHARE * sum(v.size for v in want_p.values())
    for rec in records:
        losses, norms, whole = rec[arch]["train"]
        np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, want_n, rtol=LOSS_RTOL)
        assert set(whole) == set(want_p)
        for key, got in whole.items():
            off = np.abs(got - want_p[key])
            held = ~exempt[key]
            np.testing.assert_allclose(got[held], want_p[key][held], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            assert (off[exempt[key]] <= NEAR_EPS_ATOL).all(), key
    return count


def close(got, want):
    return np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def one_rank_serving(arch, tree, prompt, toks):
    """One rank's prefill logits and DECODE_STEPS decodes' logits."""
    return one_rank_serving_drops(arch, tree, prompt, toks)[0]


def one_rank_serving_drops(arch, tree, prompt, toks, capacity_factor=None):
    """:func:`one_rank_serving`'s logits, and the slots each step dropped
    (``moe.count_drops``), at the reduced config's capacity factor or
    ``capacity_factor``."""
    from repro_torch.models import moe
    cfg = get_config(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    one = Model(cfg, NO_MESH)
    params = params_from_reference(tree, torch.float32, "cpu")
    with torch.no_grad():
        with moe.count_drops() as calls:
            logits, cache = one.prefill(params, tokens=torch.tensor(
                prompt, dtype=torch.int32))
        drops = [int(sum(calls, torch.zeros((), dtype=torch.long)))]
        cache = one.pad_cache(cache, PROMPT + DECODE_STEPS)
        want = [logits[:, -1].numpy()]
        for i in range(DECODE_STEPS):
            with moe.count_drops() as calls:
                lg, cache = one.decode(
                    params, cache, torch.tensor(toks[i], dtype=torch.int32),
                    torch.full((len(prompt),), PROMPT + i,
                               dtype=torch.int32))
            drops.append(int(sum(calls, torch.zeros((), dtype=torch.long))))
            want.append(lg.numpy())
    return want, drops
