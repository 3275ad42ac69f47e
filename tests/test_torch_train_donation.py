"""The train loop's donated step: ``launch.train.run`` updates the
parameters and AdamW moments in the tensors that hold them, as the
reference's ``run`` donates its tree to its jitted step
(``donate_argnums=(0, 1)``).  Held here at the reduced configs, f32 and
bf16, with no mesh and on a (2, 2) gloo mesh (``torch_ranks.run_ranks``):
each donated step keeps every leaf's tensor and storage and gives the
functional step's values bitwise from the same tree and batch; ``run``'s
losses are the reference's ``run``'s from the same weights; and an
async checkpoint holds the values of the step it was taken at while the
next steps update the tree in place.  ``chip_smoke.py``'s phase 11,
which checks the donation on the card, is rehearsed on the CPU."""
import dataclasses
import importlib.util
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import run as ref_run
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import NO_MESH, Model
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten

from torch_ranks import REPO, run_ranks

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS, SEQ, GLOBAL_BATCH = 3, 16, 4
# the port's run against the reference's: the train-step twin's loss
# limit (test_torch_substrate.test_train_step_matches_the_reference)
RUN_LOSS_RTOL = 1e-5


def _leaves(params, state):
    return tree_flatten({"params": params, "opt": state})[1]


def _batch(cfg, i):
    dc = DataConfig(cfg.vocab_size, SEQ, GLOBAL_BATCH, seed=3)
    return {k: torch.from_numpy(v) for k, v in
            batch_at_step(dc, i).items() if k in ("tokens", "labels")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "olmoe_1b_7b",
                                  "mamba2_780m"])
def test_donated_step_keeps_storage_and_equals_the_functional_step(
        arch, dtype):
    """Three steps with no mesh: the functional step leaves its inputs
    as they were and returns new tensors; the donated step, from the
    same tree and batch, returns the tensors it was given, in their
    storage, holding the functional step's values bitwise (parameters,
    moments, step count and metrics)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    opt = adamw.AdamWConfig(**OPT)
    functional, model = steps.make_train_step(cfg, NO_MESH, opt)
    donated, _ = steps.make_train_step(cfg, NO_MESH, opt, donate=True)
    params = model.init(0, device="cpu")
    state = adamw.init_state(params)
    given = _leaves(params, state)
    ptrs = [t.data_ptr() for t in given]
    assert len(set(ptrs)) == len(ptrs)      # no two leaves share storage
    for i in range(STEPS):
        batch = _batch(cfg, i)
        before = [t.clone() for t in given]
        want_p, want_s, want_m = functional(params, state, batch)
        for t, b in zip(given, before):
            assert torch.equal(t, b)
        got_p, got_s, got_m = donated(params, state, batch)
        assert got_p is params and got_s is state
        got = _leaves(got_p, got_s)
        assert all(g is t and g.data_ptr() == p
                   for g, t, p in zip(got, given, ptrs))
        for g, w in zip(got, _leaves(want_p, want_s)):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got_m[key], want_m[key]), key
    assert int(state["step"]) == STEPS


MESH_BODY = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.train import _batch_rows
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten

cfg = dataclasses.replace(get_config("qwen3_0_6b").reduced(),
                          dtype={dtype!r})
rules = rules_for_mesh(make_mesh_for_devices(4, 2, device="cpu"))
opt = adamw.AdamWConfig(**{opt!r})
functional, model = steps.make_train_step(cfg, rules, opt)
donated, _ = steps.make_train_step(cfg, rules, opt, donate=True)
params = model.init(0, device="cpu")
state = adamw.init_state(params)
leaves = lambda p, s: tree_flatten({{"params": p, "opt": s}})[1]
given = leaves(params, state)
ptrs = [t.data_ptr() for t in given]
rows = _batch_rows(rules, {gb})
dc = DataConfig(cfg.vocab_size, {seq}, {gb}, seed=3)
losses = []
for i in range({steps}):
    batch = {{k: torch.from_numpy(v[rows]) for k, v in
              batch_at_step(dc, i).items() if k in ("tokens", "labels")}}
    want_p, want_s, want_m = functional(params, state, batch,
                                        global_batch={gb})
    got_p, got_s, got_m = donated(params, state, batch, global_batch={gb})
    got = leaves(got_p, got_s)
    assert all(g is t and g.data_ptr() == p
               for g, t, p in zip(got, given, ptrs)), i
    for g, w in zip(got, leaves(want_p, want_s)):
        assert torch.equal(g, w), i
    assert torch.equal(got_m["loss"], want_m["loss"]), i
    losses.append(float(got_m["loss"]))
with open(os.path.join(OUT, f"mesh.{{RANK}}.json"), "w") as f:
    json.dump({{"losses": losses, "leaves": len(given),
               "held": sum(t.numel() for t in given)}}, f)
"""


@pytest.mark.parametrize("dtype", DTYPES)
def test_donated_step_on_a_2x2_mesh_equals_the_functional_step(tmp_path,
                                                               dtype):
    """The same on a (2, 2) gloo mesh, where each rank holds its blocks
    of the parameters and moments: every rank's donated step keeps its
    blocks' tensors and storage and gives the functional step's values
    bitwise; every rank logs the same global losses."""
    run_ranks(tmp_path, 4, MESH_BODY.format(dtype=dtype, opt=OPT,
                                            gb=GLOBAL_BATCH, seq=SEQ,
                                            steps=STEPS))
    got = [json.loads((tmp_path / f"mesh.{r}.json").read_text())
           for r in range(4)]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    assert all(np.isfinite(got[0]["losses"]))
    cfg = dataclasses.replace(get_config("qwen3_0_6b").reduced(),
                              dtype=dtype)
    params = Model(cfg).init(0, device="cpu")
    whole = sum(t.numel() for t in _leaves(params,
                                           adamw.init_state(params)))
    # the blocks: each rank holds less than the whole tree
    assert all(g["held"] < whole for g in got)


def _reference_params(cfg_name):
    rp = RefModel(ref_get_config(cfg_name).reduced()).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), rp)


@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke.py`` as a module (it imports ``tools.fsdp_train``)."""
    monkeypatch.syspath_prepend(str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke_train",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_run_donates_and_gives_the_references_losses(monkeypatch, smoke):
    """``train.run`` from the reference's weights: every step returns
    the tree it was given in its storage, and the losses are those of
    the reference's ``run`` (its step jitted with its tree donated) on
    the same data stream, within the train-step twin's limit."""
    want = ref_run(RefTrainConfig(arch="qwen3_0_6b", smoke=True, steps=6,
                                  seq_len=32, global_batch=4,
                                  log_every=0))["losses"]
    ref_params = _reference_params("qwen3_0_6b")
    monkeypatch.setattr(Model, "init", lambda self, seed, device="cuda":
                        params_from_reference(ref_params, torch.float32,
                                              device))
    with smoke.kept_storage() as kept:
        got = train.run(train.TrainConfig(
            arch="qwen3_0_6b", smoke=True, steps=6, seq_len=32,
            global_batch=4, log_every=0, device="cpu"))["losses"]
    assert kept == {"steps": 6, "moved": 0}
    np.testing.assert_allclose(got, want, rtol=RUN_LOSS_RTOL)


def test_async_checkpoint_holds_the_values_of_its_step(tmp_path,
                                                       monkeypatch):
    """``ckpt_async=True``: the writer thread runs while the next steps
    update the donated tree in place (here each write waits until the
    loop has finished one more step), yet each checkpoint holds the
    values of the step it was taken at: a blocking run's checkpoints,
    bitwise."""
    from repro_torch.checkpoint import checkpointer as ck
    base = dict(arch="qwen3_0_6b", smoke=True, steps=5, seq_len=SEQ,
                global_batch=GLOBAL_BATCH, ckpt_every=2, log_every=0,
                device="cpu")
    train.run(train.TrainConfig(ckpt_dir=str(tmp_path / "blocking"),
                                **base))
    done = {"steps": 0}
    cond = threading.Condition()
    make = train.make_train_step

    def counted_make(*args, **kw):
        step, model = make(*args, **kw)

        def counted(*a, **k):
            out = step(*a, **k)
            with cond:
                done["steps"] += 1
                cond.notify_all()
            return out
        return counted, model

    savez = np.savez

    def late_savez(path, **arrays):
        with cond:
            after = done["steps"] + 1
            cond.wait_for(lambda: done["steps"] >= after, timeout=60)
        savez(path, **arrays)

    monkeypatch.setattr(train, "make_train_step", counted_make)
    monkeypatch.setattr(ck.np, "savez", late_savez)
    train.run(train.TrainConfig(ckpt_dir=str(tmp_path / "async"),
                                ckpt_async=True, **base))
    monkeypatch.undo()
    assert done["steps"] == 5
    for step in (2, 4):
        name = f"step_{step}/arrays.npz"
        with np.load(tmp_path / "blocking" / name) as want, \
                np.load(tmp_path / "async" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{step} {key}")


def test_chip_smoke_train_phase_runs_on_the_host(smoke):
    """``chip_smoke.py``'s phase 11 on the CPU at the reduced config:
    its checks pass, the donated run's nine steps keep their storage
    (counted by ``kept_storage``), and the peaks are the card's alone."""
    numbers, launches = smoke.phase_train("cpu", device="cpu", smoke=True)
    assert numbers["storage_kept_steps"] == smoke.TRAIN_RESUME_STEPS
    assert numbers["step_peak_gib"] is None and numbers["peak_gib"] is None
    assert not any(launches["gemm"].values())
    # the watcher counts a step that returns new tensors as moved
    cfg = get_config("qwen3_0_6b").reduced()
    with smoke.kept_storage() as kept:
        step, model = train.make_train_step(cfg, NO_MESH)
        params = model.init(0, device="cpu")
        step(params, adamw.init_state(params), _batch(cfg, 0))
    assert kept["steps"] == 1
    assert kept["moved"] == len(_leaves(params, adamw.init_state(params)))
    assert train.make_train_step is steps.make_train_step
