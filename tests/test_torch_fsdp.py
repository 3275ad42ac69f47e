"""Placed storage under a mesh: every rank holds its blocks of the
parameters, gradients and AdamW moments at the reference's placements
(FSDP on "data", tensor-parallel on "model"), held against the
reference on an 8-device XLA CPU mesh, and sharded training on gloo
ranks (``torch_ranks.run_ranks``) held against one rank: losses, the
clip's global norm, the gathered parameters, and checkpoints that
resume on another mesh and stay readable by the reference's
checkpointer.  Reduced configs (f32): dense Qwen3 and OLMoE, whose
experts sit on "model"; the training against the reference's sharded
jitted step also for Mamba2, Zamba2 and DeepSeek-V3, whose SSM mixer
and MLA a rank computes by heads on "model".
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import NO_MESH
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

from torch_ranks import REPO, run_ranks

ARCHS = ("qwen3_0_6b", "olmoe_1b_7b")
# the archs held against the reference's sharded jitted step: also those
# whose SSM mixer (Mamba2, Zamba2) or MLA (DeepSeek-V3) a rank computes
# by heads on "model" (tests/test_torch_tensor_parallel_mixers.py); SEQ
# is shorter than a full SSD chunk, where the reference's scan has a NaN
# gradient
REF_ARCHS = ARCHS + ("mamba2_780m", "zamba2_2_7b", "deepseek_v3_671b")
HELD_MESHES = ((8, 1), (2, 4), (4, 2))
# sharded against one rank: the same arithmetic but for the order of the
# batch-axis sums (a reduce-scatter or an all-reduce of two or four
# partial gradients) and of the norm's squares; the data-parallel twins'
# loss limit (test_torch_substrate.DP_LOSS_RTOL), and for the weights
# after three Adam steps at lr 1e-3 a limit of 2e-5 absolute, 2% of the
# 1e-3 a step can move a weight: Adam moves a weight whose gradient is
# near rounding level by a step whose size that rounding sets (the
# worst weight reads 7.9e-6 on (2, 2))
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-5
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# a clip below every step's norm, so every step is scaled
CLIP = 0.05
GLOBAL_BATCH, SEQ = 4, 16

# the reference's shards: its parameters as Model.init device_puts them,
# and its moments and parameters after one jitted train step
REF_HELD = f"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch import steps
from repro.models.sharding import rules_for_mesh
from repro.optim import adamw

def shards(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {{jax.tree_util.keystr(p): list(x.addressable_shards[0].data.shape)
            for p, x in flat}}

out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    for shape in {HELD_MESHES!r}:
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 ("data", "model"))
        step, model = steps.make_train_step(cfg, rules_for_mesh(mesh))
        params = model.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {{k: jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 16)),
                                jnp.int32) for k in ("tokens", "labels")}}
        p2, s2, _ = jax.jit(step)(params, adamw.init_state(params), batch)
        out[f"{{arch}} {{shape}}"] = {{
            "params": shards(params), "p2": shards(p2),
            "m": shards(s2["m"]), "v": shards(s2["v"])}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

# each rank's held shapes: parameters from Model.init, gradients from the
# grad step on its rows of an 8-sequence batch, moments from init_state
# and after one train step
PORT_HELD = f"""
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models import Model
from repro_torch.models.sharding import NO_MESH, gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

def shapes(tree):
    paths, leaves = tree_flatten(tree)
    return {{keystr(p): list(t.shape) for p, t in zip(paths, leaves)}}

out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    for shape in {HELD_MESHES!r}:
        rules = rules_for_mesh(init_device_mesh("cpu", shape,
                                                mesh_dim_names=("data",
                                                                "model")))
        grad_step, model = steps.make_grad_step(cfg, rules)
        step, _ = steps.make_train_step(cfg, rules)
        params = model.init(0, device="cpu")
        state = adamw.init_state(params)
        rng = np.random.default_rng(0)
        rows = _batch_rows(rules, 8)
        batch = {{k: torch.tensor(rng.integers(0, cfg.vocab_size, (8, 16))
                                 [rows], dtype=torch.int32)
                 for k in ("tokens", "labels")}}
        grads, _, _ = grad_step(params, batch, global_batch=8)
        _, s2, _ = step(params, state, batch, global_batch=8)
        # the blocks gather to one rank's tree, bit for bit
        one = tree_flatten(Model(cfg, NO_MESH).init(0, device="cpu"))[1]
        same = all(torch.equal(gather(t, pl), w) for t, pl, w in zip(
            tree_flatten(params)[1], tree_flatten(model.placements())[1],
            one))
        out[f"{{arch}} {{shape}}"] = {{
            "params": shapes(params), "grads": shapes(grads),
            "m": shapes(state["m"]), "v": shapes(state["v"]),
            "m2": shapes(s2["m"]), "v2": shapes(s2["v"]),
            "gathers_to_one_rank": same}}
with open(os.path.join(OUT, f"held.{{RANK}}.json"), "w") as f:
    json.dump(out, f)
"""

# STEPS train steps on each mesh (@MESHES@), for both archs, with the
# default clip and with the clip active: losses, norms and the gathered
# parameters
PORT_TRAIN = f"""
import pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models.sharding import gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

MESHES = [tuple(m) for m in json.loads("@MESHES@")]
out = {{}}
for arch in {ARCHS!r}:
    cfg = get_config(arch).reduced()
    for shape in MESHES:
        rules = rules_for_mesh(init_device_mesh("cpu", shape,
                                                mesh_dim_names=("data",
                                                                "model")))
        for clip in (1.0, {CLIP!r}):
            step, model = steps.make_train_step(
                cfg, rules, adamw.AdamWConfig(grad_clip=clip, **{OPT!r}))
            params = model.init(0, device="cpu")
            state = adamw.init_state(params)
            dc = DataConfig(cfg.vocab_size, {SEQ}, {GLOBAL_BATCH}, seed=3)
            rows = _batch_rows(rules, {GLOBAL_BATCH})
            losses, norms = [], []
            for i in range({STEPS}):
                batch = {{k: torch.from_numpy(v[rows])
                         for k, v in batch_at_step(dc, i).items()}}
                params, state, m = step(params, state, batch,
                                        global_batch={GLOBAL_BATCH})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            paths, leaves = tree_flatten(params)
            whole = [gather(t, pl).numpy() for t, pl in
                     zip(leaves, tree_flatten(model.placements())[1])]
            out[arch, shape, clip] = (losses, norms,
                                      dict(zip(map(keystr, paths), whole)))
with open(os.path.join(OUT, f"train.{{RANK}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

# a checkpoint of @ARCH@ saved on (2, 2) after two steps, restored on
# (4, 1): the held shapes, the gathered tree (to hold against the saved
# arrays) and one more step's loss
PORT_CKPT = f"""
import pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import placing
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models.sharding import gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

cfg = get_config("@ARCH@").reduced()
dc = DataConfig(cfg.vocab_size, {SEQ}, {GLOBAL_BATCH}, seed=3)
ck = Checkpointer(os.path.join(OUT, "ck"))

# steps first..last-1 on shape: from the seed, saved at the end
# (first == 0), or restored from step first
def run(shape, first, last):
    rules = rules_for_mesh(init_device_mesh("cpu", shape,
                                            mesh_dim_names=("data", "model")))
    step, model = steps.make_train_step(cfg, rules,
                                        adamw.AdamWConfig(**{OPT!r}))
    places = {{"params": model.placements(),
              "opt": adamw.state_placements(model.placements())}}
    if first == 0:
        params = model.init(0, device="cpu")
        state = adamw.init_state(params)
    else:     # the restore: into another seed's tree, at this mesh
        like = {{"params": model.init(1, device="cpu")}}
        like["opt"] = adamw.init_state(like["params"])
        tree, _ = ck.restore(first, like, sharding_fn=placing(like,
                                                               places))
        paths, leaves = tree_flatten(tree)
        held = {{keystr(p): list(t.shape)
                for p, t in zip(paths, leaves)}}
        whole = {{keystr(p): gather(t, pl).numpy() for p, t, pl in zip(
            paths, leaves, tree_flatten(places)[1])}}
        params, state = tree["params"], tree["opt"]
    losses = []
    rows = _batch_rows(rules, {GLOBAL_BATCH})
    for i in range(first, last):
        batch = {{k: torch.from_numpy(v[rows])
                 for k, v in batch_at_step(dc, i).items()}}
        params, state, m = step(params, state, batch,
                                global_batch={GLOBAL_BATCH})
        losses.append(float(m["loss"]))
    if first == 0:
        ck.save(last, {{"params": params, "opt": state}}, placements=places)
        return losses, None, None
    return losses, held, whole

saved, _, _ = run((2, 2), 0, 2)
resumed, held, whole = run((4, 1), 2, 3)
with open(os.path.join(OUT, f"ckpt.{{RANK}}.pkl"), "wb") as f:
    pickle.dump({{"saved": saved, "resumed": resumed, "held": held,
                 "whole": whole}}, f)
"""


# the reference's jitted train step on a (2, 2) XLA mesh, clip active:
# one step from its init (so m, v and the step carry over), that tree
# handed to the port as float32 numpy, then STEPS more steps' losses,
# norms and parameters
REF_SHARDED = f"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import DataConfig, batch_at_step
from repro.launch import steps
from repro.models.sharding import rules_for_mesh
from repro.optim import adamw

def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)

mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
out = {{}}
for arch in {REF_ARCHS!r}:
    cfg = get_config(arch).reduced()
    step, model = steps.make_train_step(
        cfg, rules_for_mesh(mesh), adamw.AdamWConfig(grad_clip={CLIP!r},
                                                     **{OPT!r}))
    step = jax.jit(step)
    dc = DataConfig(cfg.vocab_size, {SEQ}, {GLOBAL_BATCH}, seed=3)
    batch = lambda i: {{k: jnp.asarray(v)
                       for k, v in batch_at_step(dc, i).items()}}
    params = model.init(jax.random.PRNGKey(0))
    params, state, _ = step(params, adamw.init_state(params), batch(0))
    start = (host(params), {{"m": host(state["m"]), "v": host(state["v"]),
                            "step": np.asarray(state["step"])}})
    losses, norms = [], []
    for i in range(1, 1 + {STEPS}):
        params, state, m = step(params, state, batch(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[arch] = (start, losses, norms, host(params))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

# the port on a (2, 2) gloo mesh from the reference's tree, each rank
# keeping its blocks of it (params_from_reference / opt_state_from_
# reference with the model's placements), then the same STEPS steps
PORT_FROM_REF = f"""
import pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.launch.train import _batch_rows
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.models.sharding import gather, rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import keystr, tree_flatten

with open(os.path.join(OUT, "ref.pkl"), "rb") as f:
    ref = pickle.load(f)
rules = rules_for_mesh(init_device_mesh("cpu", (2, 2),
                                        mesh_dim_names=("data", "model")))
rows = _batch_rows(rules, {GLOBAL_BATCH})
out = {{}}
for arch in {REF_ARCHS!r}:
    cfg = get_config(arch).reduced()
    step, model = steps.make_train_step(
        cfg, rules, adamw.AdamWConfig(grad_clip={CLIP!r}, **{OPT!r}))
    places = model.placements()
    (tree, state), _, _, _ = ref[arch]
    params = params_from_reference(tree, torch.float32, "cpu",
                                   placements=places)
    state = opt_state_from_reference(state, "cpu", placements=places)
    paths, leaves = tree_flatten(params)
    held = {{keystr(p): list(t.shape) for p, t in zip(paths, leaves)}}
    moments = {{keystr(p): list(t.shape)
               for p, t in zip(*tree_flatten(state["m"]))}}
    dc = DataConfig(cfg.vocab_size, {SEQ}, {GLOBAL_BATCH}, seed=3)
    losses, norms = [], []
    for i in range(1, 1 + {STEPS}):
        batch = {{k: torch.from_numpy(v[rows])
                 for k, v in batch_at_step(dc, i).items()}}
        params, state, m = step(params, state, batch,
                                global_batch={GLOBAL_BATCH})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    paths, leaves = tree_flatten(params)
    whole = {{keystr(p): gather(t, pl).numpy() for p, t, pl in
             zip(paths, leaves, tree_flatten(places)[1])}}
    out[arch] = (losses, norms, whole, held, moments)
with open(os.path.join(OUT, f"fromref.{{RANK}}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""

# a SIGTERM to the second rank alone, while it runs step 1 of a placed
# run on (2, 1): train.run stops every rank after that step and they
# save the one checkpoint together
PORT_PREEMPT = """
import signal
from repro_torch.launch import train

draw = train.batch_at_step

def batch_at_step(dc, step, **kw):
    if RANK == 1 and step == 1:
        os.kill(os.getpid(), signal.SIGTERM)
    return draw(dc, step, **kw)

train.batch_at_step = batch_at_step
r = train.run(train.TrainConfig(
    arch="qwen3_0_6b", smoke=True, steps=6, seq_len=16, global_batch=4,
    use_mesh=True, ckpt_dir=os.path.join(OUT, "ck"), ckpt_every=100,
    log_every=0, device="cpu"))
with open(os.path.join(OUT, f"preempt.{RANK}.json"), "w") as f:
    json.dump({"final_step": r["final_step"], "losses": r["losses"]}, f)
"""


def _one_rank(arch, clip=1.0, first=0, last=STEPS, params=None, state=None):
    """One rank's run (no mesh): losses, norms, final tree."""
    from repro_torch.data import DataConfig, batch_at_step
    cfg = get_config(arch).reduced()
    step, model = steps.make_train_step(
        cfg, NO_MESH, adamw.AdamWConfig(grad_clip=clip, **OPT))
    if params is None:
        params = model.init(0, device="cpu")
        state = adamw.init_state(params)
    dc = DataConfig(cfg.vocab_size, SEQ, GLOBAL_BATCH, seed=3)
    losses, norms = [], []
    for i in range(first, last):
        batch = {k: torch.from_numpy(v) for k, v in
                 batch_at_step(dc, i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, params, state


def _flat(tree):
    paths, leaves = tree_flatten(tree)
    return {keystr(p): t for p, t in zip(paths, leaves)}


# ------------------------------------------------------------ held shapes
@pytest.fixture(scope="module")
def held(tmp_path_factory):
    d = tmp_path_factory.mktemp("held")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_HELD),
                            str(d / "ref.json")], env=env,
                           stderr=subprocess.PIPE, text=True)
    run_ranks(d, 8, PORT_HELD)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    port = [json.loads((d / f"held.{r}.json").read_text()) for r in range(8)]
    return json.loads((d / "ref.json").read_text()), port


@pytest.mark.parametrize("shape", HELD_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_references_shards(held, arch, shape):
    """Each rank holds every leaf of the parameters, gradients and AdamW
    moments (at init and after a step) at the reference's per-device
    shard shape: its parameters' as ``Model.init`` places them, which
    its jitted train step keeps its moments at (``m`` and ``v`` come out
    of the step at the placements its parameters come out at)."""
    ref, port = held
    r = ref[f"{arch} {shape}"]
    assert r["m"] == r["p2"] and r["v"] == r["p2"]
    for rank in port:
        mine = rank[f"{arch} {shape}"]
        for tree in ("params", "grads", "m", "v", "m2", "v2"):
            assert mine[tree] == r["params"], (tree, {
                k: (mine[tree][k], r["params"][k]) for k in r["params"]
                if mine[tree].get(k) != r["params"][k]})
    # FSDP over at least two data ranks: the blocks are smaller
    whole = steps.make_train_step(get_config(arch).reduced(), NO_MESH)[1
                                                                      ].init(
        0, device="cpu")
    assert sum(int(np.prod(v)) for v in r["params"].values()) < sum(
        t.numel() for t in tree_flatten(whole)[1])


@pytest.mark.parametrize("shape", HELD_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_init_gathers_to_one_ranks_tree(held, arch, shape):
    """Each rank draws every leaf whole (a stack a layer at a time) and
    keeps its block, so the blocks gather to one rank's tree from the
    same seed, bit for bit, on every rank."""
    _, port = held
    assert all(rank[f"{arch} {shape}"]["gathers_to_one_rank"]
               for rank in port)


# -------------------------------------------------------- sharded training
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d2, d4 = tmp_path_factory.mktemp("train2"), tmp_path_factory.mktemp(
        "train4")
    run_ranks(d2, 2, PORT_TRAIN.replace("@MESHES@", "[[2, 1], [1, 2]]"))
    run_ranks(d4, 4, PORT_TRAIN.replace("@MESHES@", "[[2, 2]]"))
    out = {}
    for d, world in ((d2, 2), (d4, 4)):
        ranks = []
        for r in range(world):
            with open(d / f"train.{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for key in ranks[0]:
            # every rank logs the global loss and norm and gathers the
            # same tree
            for other in ranks[1:]:
                assert other[key][:2] == ranks[0][key][:2], key
                for k, v in other[key][2].items():
                    np.testing.assert_array_equal(v, ranks[0][key][2][k])
        out.update(ranks[0])
    return out


@pytest.mark.parametrize("clip", (1.0, CLIP), ids=("clip1", "clip_active"))
@pytest.mark.parametrize("shape", ((2, 1), (1, 2), (2, 2)),
                         ids=("2x1", "1x2", "2x2"))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_training_equals_one_rank(trained, arch, shape, clip):
    """Three steps on the mesh from the same seed give one rank's losses,
    global gradient norms and (gathered) parameters: FSDP on "data" and
    the model axis, and OLMoE's experts on "model" beside FSDP on (2, 2).
    With the clip below every norm, each step is scaled by the norm of
    the whole gradient, which each rank computes alike."""
    losses, norms, whole = trained[arch, shape, clip]
    want_l, want_n, params, _ = _one_rank(arch, clip)
    np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, want_n, rtol=LOSS_RTOL)
    if clip != 1.0:
        assert min(want_n) > clip
    for key, want in _flat(params).items():
        np.testing.assert_allclose(whole[key], want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def from_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("fromref")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        + env.get("XLA_FLAGS", "")).strip()
    ref = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SHARDED),
                          str(d / "ref.pkl")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    run_ranks(d, 4, PORT_FROM_REF)
    ranks = []
    for r in range(4):
        with open(d / f"fromref.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(d / "ref.pkl", "rb") as f:
        return pickle.load(f), ranks


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_sharded_training_equals_the_references_sharded_step(
        from_reference, arch):
    """Both packages start from one tree on a (2, 2) mesh: the
    reference's after one jitted step (moments and step carried over),
    of which each port rank keeps its blocks through
    ``params_from_reference`` / ``opt_state_from_reference`` with the
    model's placements.  Three more steps with the clip active give the
    reference's losses and global gradient norms and, gathered, its
    parameters, within the sharded twins' limits."""
    ref, ranks = from_reference
    (tree, _), want_l, want_n, want_p = ref[arch]
    cfg = get_config(arch).reduced()
    for rank in ranks:
        losses, norms, whole, held, moments = rank[arch]
        assert (losses, norms) == tuple(ranks[0][arch][:2])
        # FSDP on data and, for OLMoE, its experts on model: blocks
        assert held["['embed']"][1] == cfg.d_model // 2
        assert moments == held
        assert sum(int(np.prod(v)) for v in held.values()) < sum(
            a.size for a in _flat_np(tree).values())
        np.testing.assert_allclose(losses, want_l, rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms, want_n, rtol=LOSS_RTOL)
        assert min(want_n) > CLIP
        want = _flat_np(want_p)
        assert set(whole) == set(want)
        for key, got in whole.items():
            np.testing.assert_allclose(got, want[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)


def _flat_np(tree, prefix=""):
    """A nested dict of arrays -> {keystr path: array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flat_np(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_a_signal_to_one_rank_stops_every_rank_at_one_step(tmp_path):
    """A placed save gathers on every rank, so a SIGTERM that reaches one
    rank stops all of them at the same step: both ranks end after step
    2 with the same losses, and the one checkpoint is that step's,
    marked preempted, in global shapes."""
    run_ranks(tmp_path, 2, PORT_PREEMPT, timeout=180)
    got = [json.loads((tmp_path / f"preempt.{r}.json").read_text())
           for r in range(2)]
    assert got[0] == got[1] and got[0]["final_step"] == 2
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.all_steps() == [2]
    cfg = get_config("qwen3_0_6b").reduced()
    _, model = steps.make_train_step(cfg, NO_MESH)
    params = model.init(1, device="cpu")
    like = {"params": params, "opt": adamw.init_state(params)}
    _, extra = ck.restore(2, like)
    assert extra == {"preempted": True}


def test_train_run_refuses_an_async_save_under_a_mesh():
    """A placed save is a collective that every rank waits out, so
    ``ckpt_async`` is refused under a mesh before anything starts."""
    from repro_torch.launch.train import TrainConfig, run
    with pytest.raises(ValueError, match="ckpt_async"):
        run(TrainConfig(use_mesh=True, ckpt_async=True, device="cpu"))


# ------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module", params=ARCHS)
def resumed(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    run_ranks(d, 4, PORT_CKPT.replace("@ARCH@", request.param))
    ranks = []
    for r in range(4):
        with open(d / f"ckpt.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return request.param, d / "ck", ranks


def test_checkpoint_saved_on_one_mesh_resumes_on_another(resumed):
    """Saved on (2, 2) (each leaf gathered, the first rank writing the
    whole arrays), restored on (4, 1) and on one rank: each rank holds
    its (4, 1) blocks, which gather back to the saved arrays bitwise, as
    one rank's restore does; the next step's loss is one rank's, and both
    are the loss of a run that never stopped."""
    arch, ck_dir, ranks = resumed
    with np.load(ck_dir / "step_2" / "arrays.npz") as data:
        saved = {k: data[k] for k in data.files}
    cfg = get_config(arch).reduced()
    _, model = steps.make_train_step(cfg, NO_MESH)
    like = {"params": model.init(1, device="cpu")}
    like["opt"] = adamw.init_state(like["params"])
    tree, _ = Checkpointer(str(ck_dir)).restore(2, like)
    for key, t in _flat(tree).items():
        np.testing.assert_array_equal(np.asarray(t), saved[key])
    for rank in ranks:
        assert rank["resumed"] == ranks[0]["resumed"]
        assert set(rank["whole"]) == set(saved)
        for key, got in rank["whole"].items():
            np.testing.assert_array_equal(np.asarray(got), saved[key],
                                          err_msg=key)
    # FSDP on data over 4 ranks: an embed-sharded leaf is a quarter
    embed = ranks[0]["held"]["['params']['embed']"]
    assert embed == [cfg.vocab_size, cfg.d_model // 4]
    one, _, _, _ = _one_rank(arch, first=2, last=3, params=tree["params"],
                             state=tree["opt"])
    np.testing.assert_allclose(ranks[0]["resumed"], one, rtol=LOSS_RTOL)
    straight, _, _, _ = _one_rank(arch, last=3)
    np.testing.assert_allclose(ranks[0]["saved"], straight[:2],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(one, straight[2:], rtol=LOSS_RTOL)


def test_placed_checkpoint_reads_in_the_reference(resumed):
    """The file a (2, 2) mesh wrote is the reference's format: its
    checkpointer restores every array bitwise into a tree of the global
    shapes."""
    arch, ck_dir, _ = resumed
    with np.load(ck_dir / "step_2" / "arrays.npz") as data:
        saved = {k: data[k] for k in data.files}
    cfg = get_config(arch).reduced()
    _, model = steps.make_train_step(cfg, NO_MESH)
    params = model.init(1, device="cpu")
    like = {"params": params, "opt": adamw.init_state(params)}

    def to_jax(node):
        if isinstance(node, dict):
            return {k: to_jax(v) for k, v in node.items()}
        return jnp.zeros(tuple(node.shape),
                         str(node.dtype).replace("torch.", ""))

    out, _ = RefCheckpointer(str(ck_dir)).restore(2, to_jax(like))
    flat, _ = jax.tree_util.tree_flatten_with_path(out)
    assert {jax.tree_util.keystr(p) for p, _ in flat} == set(saved)
    for p, x in flat:
        np.testing.assert_array_equal(np.asarray(x),
                                      saved[jax.tree_util.keystr(p)])


# ------------------------------------------------------------ the tool
def test_four_card_tool_rehearses_in_gloo_ranks(tmp_path):
    """``tools/fsdp_train.py --device cpu`` (the four-card runs at the
    reduced configs, in four gloo ranks) exits 0 with one line a run:
    one rank, Qwen3 on (4, 1) and (2, 2), OLMoE on (4, 1), Mamba2 on
    one rank in f64, then on one rank, its two one-rank controls (its
    batch's four row blocks; out_proj as two rounded row-block partials),
    (4, 1) and (2, 2) in its config's dtype, and one rank, (4, 1) and
    (2, 2) in f32; on every mesh a rank holds the reference's placed
    bytes, less than one rank holds, and its collective bytes a step are
    printed by mesh axis, and its first gradient, gathered, is one
    rank's leaf by leaf, as is the mean of the gradients of one rank's
    four row blocks; each Mamba2 baseline's gradient and that mean are
    held against the f64 baseline's, and the f32 mesh runs' limits are
    drawn from the baseline's distance from f64; then the sharded
    prefill and decodes on (2, 2) of Qwen3, Zamba2 (one rank alone in
    f64, then in f32 and its config's dtype, the limits drawn from one
    rank's distance from the wider run) and DeepSeek-V3 (at its
    capacity factor, and at 5 with 32 for the decodes), each rank on
    half the q heads (and half the SSM heads) and its vocab block of the
    logits, equal to one rank's within the tool's limit at every step
    before which and in which neither drops an expert slot (none drop
    at the reduced configs; the MoE's statistics all-reduced over "data"
    too), and each MoE decode's layers equal to one rank's.
    ``--archs`` keeps the runs of the archs it names.  The tool imports
    neither JAX nor the reference."""
    tool = REPO / "tools" / "fsdp_train.py"
    proc = subprocess.run([sys.executable, str(tool), "--device", "cpu",
                           "--cards", "4"], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line)["fsdp_train"]
            for line in proc.stdout.splitlines()
            if line.startswith('{"fsdp_train"')]
    assert [(r["arch"].split("-")[0], r["mesh"]) for r in rows] == [
        ("qwen3", [1, 1]), ("qwen3", [4, 1]), ("qwen3", [2, 2]),
        ("olmoe", [4, 1]), ("mamba2", [1, 1]), ("mamba2", [1, 1]),
        ("mamba2", [1, 1]), ("mamba2", [1, 1]),
        ("mamba2", [4, 1]), ("mamba2", [2, 2]), ("mamba2", [1, 1]),
        ("mamba2", [4, 1]), ("mamba2", [2, 2])]
    assert [r["dtype"] for r in rows] == ["float32"] * 4 + ["float64"] + [
        "float32"] * 8
    assert [r.get("control") for r in rows[5:8]] == [None, "split",
                                                     "rounded"]
    for r in rows[6:8]:
        # a control is one rank's arithmetic in another order: held to
        # no limit of its own, but within f32 rounding of one rank here
        assert r["bytes"] == rows[5]["bytes"]
        assert r["collective_bytes_per_step_by_axis"] == {}
        assert "loss_rtol" not in r
        assert max(r["loss_rel_diff_vs_one_card"]) <= 1e-4
    for r in rows:
        for held, placed in r["bytes"].values():
            assert held == placed, r
    for r in rows[1:3]:
        assert r["bytes"]["params"][0] < rows[0]["bytes"]["params"][0]
        assert max(r["loss_rel_diff_vs_one_card"]) <= r["loss_rtol"] == 1e-4
    for base, meshes in ((rows[5], rows[8:10]), (rows[10], rows[11:])):
        assert max(base["first_grad_f64_rel_err_by_leaf"].values()) <= 1e-4
        assert max(base["first_grad_split_f64_rel_err_by_leaf"].values()
                   ) <= 1e-4
        for r in meshes:
            assert r["bytes"]["params"][0] < rows[4]["bytes"]["params"][0]
            assert r["loss_rtol"] == 2 * max(base["loss_rel_diff_vs_f64"])
            assert max(r["loss_rel_diff_vs_one_card"]) <= r["loss_rtol"]
            assert r["first_grad_rtol_by_leaf"] == {
                k: 2 * v for k, v in
                base["first_grad_f64_rel_err_by_leaf"].items()}
    for r in rows[1:3] + rows[6:10] + rows[11:]:
        errs = r["first_grad_rel_err_by_leaf"]
        assert errs and max(errs.values()) <= 1e-4, errs
    for r in (rows[0], rows[4], rows[5], rows[10]):
        errs = r["first_grad_split_rel_err_by_leaf"]
        assert errs and max(errs.values()) <= 1e-4, errs
    for r in (rows[1], rows[8], rows[11]):
        assert set(r["collective_bytes_per_step_by_axis"]) == {"data"}
    for r in (rows[2], rows[9], rows[12]):
        assert set(r["collective_bytes_per_step_by_axis"]) == {"data",
                                                               "model"}
    served = [json.loads(line)["fsdp_serve"]
              for line in proc.stdout.splitlines()
              if line.startswith('{"fsdp_serve"')]
    archs = ("qwen3_0_6b", "zamba2_2_7b", "zamba2_2_7b", "deepseek_v3_671b",
             "deepseek_v3_671b")
    assert [r["arch"] for r in served] == [
        get_config(a).reduced().name for a in ("qwen3_0_6b", "qwen3_0_6b",
                                               "zamba2_2_7b") + tuple(
            a for a in archs[1:] for _ in (0, 1))]
    assert (served[2]["mesh"], served[2]["dtype"], served[2]["attention"]
            ) == ([1, 1], "float64", "sdpa")
    pairs = [served[0:2]] + [served[i:i + 2] for i in range(3, 11, 2)]
    assert [(r.get("capacity_factor"), r.get("decode_capacity_factor"))
            for r, _ in pairs] == [(None, None), (None, None), (None, None),
                                   (2.0, 2.0), (5.0, 32.0)]
    for arch, (one, sharded) in zip(archs, pairs):
        cfg = get_config(arch).reduced()
        assert [(r["mesh"], r["q_heads_per_rank"]) for r in (one, sharded)
                ] == [([1, 1], cfg.n_heads), ([2, 2], cfg.n_heads // 2)]
        if cfg.family == "hybrid":
            assert (one["ssm_heads_per_rank"], sharded["ssm_heads_per_rank"]
                    ) == (cfg.ssm_heads, cfg.ssm_heads // 2)
            far = max(one["logits_rel_diff_vs_one_card_in"]["float64"])
            assert sharded["logits_rtol"] == 2 * far
        else:
            assert sharded["logits_rtol"] == 1e-4
        if cfg.family == "moe":
            assert one["dropped_slots"] == sharded["dropped_slots"] == [
                0] * (1 + sharded["decode_steps"])
            # each decode's layers against one rank's: f32 sums in
            # another order, every token on the same experts
            layers = sharded["decode_layers_vs_one_card"]
            assert layers["tokens_rerouted"] == [0] * sharded["decode_steps"]
            for kind in ("attention", "ffn"):
                assert [len(s) for s in layers[kind]] == [
                    cfg.n_layers] * sharded["decode_steps"]
                assert max(map(max, layers[kind])) <= 1e-4
        assert sharded["logits_shape_per_rank"] == [
            sharded["batch"] // 2, 1, cfg.vocab_size // 2]
        assert set(sharded["prefill_collective_bytes_by_axis"]) == (
            {"model", "data"} if cfg.family == "moe" else {"model"})
        rel = sharded["logits_rel_diff_vs_one_card"]
        assert len(rel) == 1 + sharded["decode_steps"]
        assert sharded["logits_held_steps"] == list(range(len(rel)))
        assert max(rel) <= sharded["logits_rtol"]
    for line in tool.read_text(encoding="utf-8").splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line


def test_one_card_tool_runs_the_depth_sweep_and_the_moe_split_control(
        tmp_path):
    """``tools/fsdp_train.py --device cpu --cards 1 --archs
    mamba2_780m,deepseek_v3_671b`` runs Mamba2's one-rank baselines (f64
    first) and its two one-rank controls, and then the depth sweep: at each depth one batch's f32
    gradient and the mean of its four row blocks' f32 gradients, each
    against the f64 gradient leaf by leaf, and the two f32 gradients
    against each other; at the reduced config all within f32 rounding,
    the losses within 1e-6 of the f64 one.  Then DeepSeek-V3 served on
    one rank alone (no mesh), each run with its control: the same
    decodes with the batch in a (2, 2) mesh's two data-rank blocks, each
    step's logits and each layer's outputs against the whole batch's,
    and the tokens routed to other experts (none here)."""
    tool = REPO / "tools" / "fsdp_train.py"
    proc = subprocess.run([sys.executable, str(tool), "--device", "cpu",
                           "--cards", "1", "--archs",
                           "mamba2_780m,deepseek_v3_671b"],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line)["fsdp_train"]
            for line in proc.stdout.splitlines()
            if line.startswith('{"fsdp_train"')]
    assert [(r["mesh"], r["dtype"], r.get("control")) for r in rows] == [
        ([1, 1], "float64", None), ([1, 1], "float32", None),
        ([1, 1], "float32", "split"), ([1, 1], "float32", "rounded"),
        ([1, 1], "float32", None)]
    depth = [json.loads(line)["fsdp_depth"]
             for line in proc.stdout.splitlines()
             if line.startswith('{"fsdp_depth"')]
    assert [r["layers"] for r in depth] == [1, 2]
    names = {k for k in rows[0]["first_grad_split_rel_err_by_leaf"]}
    for r in depth:
        for key in ("f64_rel_err_by_leaf", "split_f64_rel_err_by_leaf",
                    "split_rel_err_by_leaf"):
            assert set(r[key]) == names
            assert 0 < max(r[key].values()) <= 1e-4, (key, r[key])
        assert abs(r["loss_float32"] - r["loss_float64"]) <= 1e-6 * abs(
            r["loss_float64"])
    served = [json.loads(line)["fsdp_serve"]
              for line in proc.stdout.splitlines()
              if line.startswith('{"fsdp_serve"')]
    cfg = get_config("deepseek_v3_671b").reduced()
    assert [(r["mesh"], r["capacity_factor"]) for r in served] == [
        ([1, 1], cfg.capacity_factor), ([1, 1], 5.0)]
    for r in served:
        steps = r["decode_steps"]
        assert len(r["split_decode_logits_rel_diff"]) == steps
        assert max(r["split_decode_logits_rel_diff"]) <= 1e-4
        layers = r["split_decode_layers"]
        assert layers["tokens_rerouted"] == [0] * steps
        assert [len(s) for s in layers["attention"]] == [cfg.n_layers] * steps
