"""Twins of ``test_substrate.py`` for the port's training substrate
(``optim/adamw.py``, ``data/pipeline.py``, ``checkpoint/``,
``launch/steps.py``, ``launch/train.py``), plus the port held against
the reference on the same numpy inputs: AdamW and its int8 variant over
5 steps, the data stream bitwise, checkpoints crossing between the
packages both ways, one train step of reduced Qwen3 (f32) from the
reference's parameters and state, and a 2-rank data-parallel run
against one rank (gloo, ``torch_ranks.run_ranks``)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.data import batch_at_step as ref_batch_at_step
from repro.data import DataConfig as RefDataConfig
from repro.launch import steps as ref_steps
from repro.models.sharding import NO_MESH as REF_NO_MESH
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, DataIterator, batch_at_step
from repro_torch.launch import steps
from repro_torch.models import NO_MESH
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.optim import adamw

from torch_ranks import run_ranks

torch.set_num_threads(1)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ---------------------------------------------------------------- optimizer
def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw.init_state(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, _ = adamw.apply_updates(cfg, params, g, state)
    assert float(loss(params)) < 1e-2


def test_adamw_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s))) for s in
           [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-8          # mid-warmup
    assert abs(lrs[2] - 1e-3) < 1e-8          # peak
    assert lrs[3] < lrs[2]                    # decaying
    assert abs(lrs[4] - 1e-4) < 1e-8          # floor
    # the reference's float32 schedule, step by step (its cos and the
    # port's may differ in the last bit)
    for s in range(0, 101, 7):
        assert float(adamw.schedule(cfg, torch.tensor(s))) == pytest.approx(
            float(ref_adamw.schedule(ref_adamw.AdamWConfig(
                **dataclasses.asdict(cfg)), jnp.asarray(s))), rel=1e-6)


def test_grad_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}        # norm 5
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_int8_error_feedback_compression_unbiased():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.standard_normal(1000), dtype=torch.float32)
    err = torch.zeros_like(g)
    # accumulate dequantized payloads over steps with a CONSTANT gradient:
    # error feedback must make the running mean converge to g
    total = torch.zeros_like(g)
    steps_ = 64
    for _ in range(steps_):
        q, scale, err = adamw.compress_int8(g, err)
        total = total + adamw.decompress_int8(q, scale)
    np.testing.assert_allclose((total / steps_).numpy(), g.numpy(),
                               atol=2e-2)


# AdamW against the reference over 5 steps on the same numpy trees:
# float32 arithmetic in another order, so 1e-6 relative a step at most;
# the limit leaves 10x room over 5 steps
ADAMW_TOL = dict(rtol=5e-5, atol=1e-7)


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((33, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(300).astype(np.float32),
                    "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((33, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(300).astype(np.float32),
                    "d": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_apply_updates_match_the_reference_over_five_steps(int8):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    ref_cfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    params, grads = _opt_trees(0)
    init, upd = ((adamw.init_state_int8, adamw.apply_updates_int8) if int8
                 else (adamw.init_state, adamw.apply_updates))
    ref_init, ref_upd = ((ref_adamw.init_state_int8,
                          ref_adamw.apply_updates_int8) if int8
                         else (ref_adamw.init_state, ref_adamw.apply_updates))
    p, rp = _torch(params), jax.tree.map(jnp.asarray, params)
    s, rs = init(p), ref_init(rp)
    for g in grads:
        p, s, m = upd(cfg, p, _torch(g), s)
        rp, rs, rm = ref_upd(ref_cfg, rp, jax.tree.map(jnp.asarray, g), rs)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(s["step"]) == int(rs["step"]) == 5
    for key, got in _flat(p).items():
        np.testing.assert_allclose(got.numpy(), _flat(_np(rp))[key],
                                   err_msg=key, **ADAMW_TOL)
    if not int8:
        for part in ("m", "v"):
            for key, got in _flat(s[part]).items():
                np.testing.assert_allclose(
                    got.numpy(), _flat(_np(rs[part]))[key], err_msg=key,
                    rtol=5e-5, atol=1e-9)


# -------------------------------------------------------------------- data
def test_data_determinism_and_restart_exactness():
    dc = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=7)
    b5a = batch_at_step(dc, 5)
    b5b = batch_at_step(dc, 5)
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])

    it = DataIterator(dc)
    [next(it)["tokens"] for _ in range(4)]
    state = it.state()
    rest1 = [next(it)["tokens"] for _ in range(3)]
    it2 = DataIterator(dc)
    it2.restore(state)
    rest2 = [next(it2)["tokens"] for _ in range(3)]
    for a, b in zip(rest1, rest2):
        np.testing.assert_array_equal(a, b)


def test_data_labels_are_shifted_tokens():
    dc = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=1)
    b = batch_at_step(dc, 0)
    assert b["tokens"].shape == (2, 8)
    assert b["labels"].shape == (2, 8)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 64


@pytest.mark.parametrize("frontend_dim", [None, 16])
def test_batches_are_bitwise_the_references(frontend_dim):
    kw = dict(vocab_size=151936, seq_len=33, global_batch=5, seed=3)
    for step in (0, 1, 17, 1000):
        got = batch_at_step(DataConfig(**kw), step, frontend_dim)
        want = ref_batch_at_step(RefDataConfig(**kw), step, frontend_dim)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------- checkpointer
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    ck.save(10, tree, extra={"loss": 1.5})
    out, extra = ck.restore(10, tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"],
                                                             tree["b"]["c"])
    assert extra["loss"] == 1.5


def test_checkpoint_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        ck.restore(1, {"x": torch.zeros((3, 3))})


def test_checkpoint_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.arange(10_000).float()}
    ck.save(5, tree, blocking=False)
    ck.wait()
    out, _ = ck.restore(5, tree)
    assert torch.equal(out["x"], tree["x"])


def test_checkpoint_resharding_hook(tmp_path):
    """Elastic restore: a sharding_fn re-places arrays arbitrarily."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(8).float()}
    ck.save(1, tree)
    calls = []

    def reshard(path, t):
        calls.append(path)
        return t * 1.0

    out, _ = ck.restore(1, tree, sharding_fn=reshard)
    assert calls and "w" in calls[0]
    assert torch.equal(out["w"], torch.arange(8).float())


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"embed": rng.standard_normal((5, 3)).astype(
                np.float32),
                       "blocks": {"w": rng.standard_normal((2, 3, 4)).astype(
                           np.float32)}},
            "opt": {"step": np.asarray(7, np.int32),
                    "m": {"w": rng.standard_normal(6).astype(np.float32)}}}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's on-disk format: the same npz keys (jax keystr
    paths), meta.json keys; an f32/int32 tree written by either package
    restores bitwise in the other."""
    tree = _mixed_tree(0)
    RefCheckpointer(str(tmp_path / "ref")).save(
        3, jax.tree.map(jnp.asarray, tree), extra={"loss": 2.0})
    Checkpointer(str(tmp_path / "port")).save(3, _torch(tree),
                                              extra={"loss": 2.0})
    metas = [json.loads((tmp_path / p / "step_3" / "meta.json").read_text())
             for p in ("ref", "port")]
    assert metas[0] == metas[1]
    assert "['opt']['step']" in metas[0]["keys"]
    # reference -> port
    out, extra = Checkpointer(str(tmp_path / "ref")).restore(
        3, _torch(_mixed_tree(1)))
    assert extra == {"loss": 2.0}
    for key, got in _flat(out).items():
        want = _flat(tree)[key]
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype, key
        np.testing.assert_array_equal(got.numpy(), want)
    # port -> reference
    out, _ = RefCheckpointer(str(tmp_path / "port")).restore(
        3, jax.tree.map(jnp.asarray, _mixed_tree(1)))
    for key, got in _flat(_np(out)).items():
        assert got.dtype == np.asarray(_flat(tree)[key]).dtype, key
        np.testing.assert_array_equal(got, _flat(tree)[key])


def test_bf16_leaves_round_trip_bitwise(tmp_path):
    """bf16 leaves are stored widened to f32 (exact) and cast back to
    the ``like`` leaf's dtype on restore."""
    t = torch.randn((64, 33), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    tree = {"w": t, "m": t.float() * 3}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    with np.load(tmp_path / "step_1" / "arrays.npz") as data:
        assert data["['w']"].dtype == np.float32
    out, _ = ck.restore(1, {"w": torch.zeros_like(t),
                            "m": torch.zeros((64, 33))})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), t.view(torch.int16))
    assert torch.equal(out["m"], tree["m"])


def test_opt_state_from_reference():
    """``convert.opt_state_from_reference`` carries the reference's
    ``adamw.init_state`` tree (after a step, so m, v and step are not
    zero) over exactly: f32 moments, an int32 step."""
    params, grads = _opt_trees(1)
    rp = jax.tree.map(jnp.asarray, params)
    _, rs, _ = ref_adamw.apply_updates(ref_adamw.AdamWConfig(), rp,
                                       jax.tree.map(jnp.asarray, grads[0]),
                                       ref_adamw.init_state(rp))
    s = opt_state_from_reference(_np(rs), device="cpu")
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 1
    for part in ("m", "v"):
        for key, got in _flat(s[part]).items():
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(),
                                          _flat(_np(rs[part]))[key])
    with pytest.raises(TypeError):
        opt_state_from_reference(dict(_np(rs), step=np.asarray(1.0)),
                                 device="cpu")


# ------------------------------------------------------------- train step
def test_train_step_matches_the_reference():
    """One train step of reduced Qwen3 (f32) from the reference's
    parameters and AdamW state: the loss within 1e-5 relative, the
    gradient norm within 1e-4, every updated parameter within 1e-6 of
    the reference's (the chunked CE and the f32 sums run in another
    order; lr 1e-3 at step 1, so a first Adam step moves each weight by
    ~1e-3 and the limit is 0.1% of that)."""
    ref_cfg = ref_get_config("qwen3_0_6b").reduced()
    cfg = get_config("qwen3_0_6b").reduced()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_step, ref_model = ref_steps.make_train_step(
        ref_cfg, REF_NO_MESH, ref_adamw.AdamWConfig(**opt))
    rp = ref_model.init(jax.random.PRNGKey(0))
    rs = ref_adamw.init_state(rp)
    # start from a state one step in, so m, v and step carry over
    batch = ref_batch_at_step(RefDataConfig(cfg.vocab_size, 32, 4, seed=5),
                              0)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    rp, rs, _ = jax.jit(ref_step)(rp, rs, rb)
    params = params_from_reference(jax.tree.map(
        lambda a: np.asarray(a, np.float32), rp), torch.float32, "cpu")
    state = opt_state_from_reference(_np(rs), device="cpu")
    batch = ref_batch_at_step(RefDataConfig(cfg.vocab_size, 32, 4, seed=5),
                              1)
    rp2, rs2, rm = jax.jit(ref_step)(rp, rs, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    step, _ = steps.make_train_step(cfg, NO_MESH, adamw.AdamWConfig(**opt))
    p2, s2, m = step(params, state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["ce"]) == pytest.approx(float(rm["ce"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
    assert int(s2["step"]) == int(rs2["step"]) == 2
    want = _flat(_np(rp2))
    for key, got in _flat(p2).items():
        np.testing.assert_allclose(got.numpy(), want[key], rtol=0,
                                   atol=1e-6, err_msg=key)


# ----------------------------------------------------------- train driver
def test_train_loop_loss_decreases(tmp_path):
    from repro_torch.launch.train import TrainConfig, run
    out = run(TrainConfig(arch="qwen3_0_6b", smoke=True, steps=30,
                          seq_len=32, global_batch=4,
                          ckpt_dir=str(tmp_path / "ck"), ckpt_every=10,
                          log_every=0, device="cpu"))
    assert out["final_step"] == 30
    assert out["last_loss"] < out["first_loss"]  # learnable synthetic data
    assert len(out["step_times"]) == 30


@pytest.mark.slow
def test_train_resume_from_checkpoint(tmp_path):
    from repro_torch.launch.train import TrainConfig, run
    ck = str(tmp_path / "ck")
    base = dict(arch="qwen3_0_6b", smoke=True, seq_len=32, global_batch=4,
                ckpt_dir=ck, ckpt_every=5, log_every=0, device="cpu")
    run(TrainConfig(steps=10, **base))
    out = run(TrainConfig(steps=20, **base))     # resumes at 10
    assert out["final_step"] == 20
    # resumed run trained only the remaining 10 steps
    assert len(out["losses"]) == 10


def test_serve_driver_completes_all_requests():
    from repro_torch.launch.serve import ServeConfig, run
    out = run(ServeConfig(arch="olmo_1b", smoke=True, batch_slots=3,
                          prompt_len=8, max_len=32, requests=5, max_new=6,
                          device="cpu"))
    assert out["requests"] == 5
    assert out["tokens"] == 5 * 6
    assert out["tok_per_s"] > 0


def test_cuda_train_run_raises_without_a_card():
    """The default device is the card: no fallback to the CPU."""
    from repro_torch.launch.train import TrainConfig, run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        run(TrainConfig(steps=1, seq_len=8, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        run(TrainConfig(steps=1, seq_len=8, global_batch=2, use_mesh=True))


# losses of a 2-rank data-parallel run against one rank: the gradients
# are the mean of two half-batch means, summed in another order, so the
# weights drift by float32 rounding amplified by Adam's first steps
DP_LOSS_RTOL = 1e-4

DP_BODY = """
from repro_torch.launch.train import TrainConfig, run
out = {}
for gb in (4, 3):   # 3: the data axis does not divide it (replicated)
    r = run(TrainConfig(arch="qwen3_0_6b", smoke=True, steps=4, seq_len=16,
                        global_batch=gb, use_mesh=True, log_every=0,
                        device="cpu", lr=1e-3))
    out[gb] = r["losses"]
with open(os.path.join(OUT, f"dp.{RANK}.json"), "w") as f:
    json.dump(out, f)
"""


def test_data_parallel_run_equals_one_rank(tmp_path):
    """``train.run(use_mesh=True)`` on 2 gloo ranks (a (2, 1) mesh: each
    rank trains on half of every global batch and the gradients are
    averaged) gives one rank's losses on the same global batches; a
    global batch the data axis does not divide is replicated, and its
    losses are one rank's too."""
    from repro_torch.launch.train import TrainConfig, run
    run_ranks(tmp_path, 2, DP_BODY)
    got = [json.loads((tmp_path / f"dp.{r}.json").read_text())
           for r in range(2)]
    assert got[0] == got[1]            # every rank logs the global mean
    for gb in (4, 3):
        want = run(TrainConfig(arch="qwen3_0_6b", smoke=True, steps=4,
                               seq_len=16, global_batch=gb, log_every=0,
                               device="cpu", lr=1e-3))["losses"]
        np.testing.assert_allclose(got[0][str(gb)], want,
                                   rtol=DP_LOSS_RTOL)


# reduced OLMoE at the config's capacity factor (E/K: nothing drops) and
# at 0.5, where tokens drop: under a (2, 1) mesh the router statistics,
# the capacity and each slot's position are the global batch's, so the
# aux loss and the dropped slots are one rank's
DP_MOE_BODY = """
import dataclasses
from repro_torch.launch import train
out = {{}}
for cf in {factors!r}:
    base = train.get_config("olmoe_1b_7b").reduced()
    train.get_config = lambda arch, c=dataclasses.replace(
        base, capacity_factor=cf): c
    r = train.run(train.TrainConfig(arch="olmoe_1b_7b", smoke=False,
                                    steps=3, seq_len=16, global_batch=4,
                                    use_mesh=True, log_every=0,
                                    device="cpu", lr=1e-3))
    out[str(cf)] = r["losses"]
with open(os.path.join(OUT, f"dpmoe.{{RANK}}.json"), "w") as f:
    json.dump(out, f)
"""
DP_MOE_FACTORS = (2.0, 0.5)


def test_data_parallel_moe_run_equals_one_rank(tmp_path, monkeypatch):
    """The MoE twin of ``test_data_parallel_run_equals_one_rank``: two
    gloo ranks on a (2, 1) mesh give one rank's losses, aux term
    included, at a capacity factor where nothing drops and at one where
    tokens drop."""
    import dataclasses
    from repro_torch.launch import train
    run_ranks(tmp_path, 2, DP_MOE_BODY.format(factors=DP_MOE_FACTORS))
    got = [json.loads((tmp_path / f"dpmoe.{r}.json").read_text())
           for r in range(2)]
    assert got[0] == got[1]
    base = train.get_config("olmoe_1b_7b").reduced()
    for cf in DP_MOE_FACTORS:
        monkeypatch.setattr(train, "get_config", lambda arch, c=dataclasses
                            .replace(base, capacity_factor=cf): c)
        want = train.run(train.TrainConfig(
            arch="olmoe_1b_7b", smoke=False, steps=3, seq_len=16,
            global_batch=4, log_every=0, device="cpu", lr=1e-3))["losses"]
        np.testing.assert_allclose(got[0][str(cf)], want, rtol=DP_LOSS_RTOL)


@pytest.mark.parametrize("arch", ["olmo_1b", "internvl2_26b"])
def test_train_step_gives_unused_parameters_zero_gradients(arch):
    """OLMo's non-parametric norms never read ``final_norm``, and a
    frontend's embeds never read ``embed``: as ``jax.grad`` does, the
    step gives such a parameter a zero gradient (it once raised)."""
    cfg = get_config(arch).reduced()
    step, model = steps.make_train_step(cfg, NO_MESH)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"labels": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                 (2, 16)))}
    if cfg.frontend:
        batch["embeds"] = torch.tensor(rng.standard_normal(
            (2, 16, cfg.d_model)), dtype=torch.float32)
    else:
        batch["tokens"] = torch.tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 16)))
    _, state, metrics = step(params, adamw.init_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    unused = "embed" if cfg.frontend else "final_norm"
    assert not state["m"][unused].any()
