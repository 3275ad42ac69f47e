"""Twins of ``test_pipeline.py`` for the port's ``launch/pipeline.py``:
the 1F1B schedule (a copy of the reference's), its memory bound and
bubble, and the executor's gradients (autograd's stage backward) held
against the unpipelined gradients and against the reference's executor
(``jax.vjp``) on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import pipeline as ref_pipeline
from repro_torch.launch.pipeline import (PipelineExecutor, bubble_fraction,
                                         make_stages_from_model,
                                         schedule_1f1b)

torch.set_num_threads(1)


def _validate_schedule(ticks, S, M):
    fwd_done = [[False] * M for _ in range(S)]
    bwd_done = [[False] * M for _ in range(S)]
    for row in ticks:
        assert len(row) == S
        for t in row:
            if t is None:
                continue
            if t.kind == "fwd":
                assert not fwd_done[t.stage][t.micro]
                if t.stage > 0:          # upstream fwd must be done
                    assert fwd_done[t.stage - 1][t.micro]
                fwd_done[t.stage][t.micro] = True
            else:
                assert fwd_done[t.stage][t.micro]
                assert not bwd_done[t.stage][t.micro]
                if t.stage < S - 1:      # downstream bwd must be done
                    assert bwd_done[t.stage + 1][t.micro]
                bwd_done[t.stage][t.micro] = True
    assert all(all(r) for r in fwd_done)
    assert all(all(r) for r in bwd_done)


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (4, 4), (3, 1), (1, 3)])
def test_1f1b_schedule_is_valid(S, M):
    ticks = schedule_1f1b(S, M)
    _validate_schedule(ticks, S, M)
    # the reference's schedule, tick for tick
    ref = ref_pipeline.schedule_1f1b(S, M)
    assert [[None if t is None else (t.stage, t.kind, t.micro) for t in row]
            for row in ticks] == [
        [None if t is None else (t.stage, t.kind, t.micro) for t in row]
        for row in ref]


def test_1f1b_memory_bound():
    """1F1B's point: at most ~S microbatch residuals live per stage."""
    S, M = 4, 16
    ticks = schedule_1f1b(S, M)
    live = set()
    peak = 0
    for row in ticks:
        for t in row:
            if t is None:
                continue
            if t.kind == "fwd":
                live.add((t.stage, t.micro))
            else:
                live.discard((t.stage, t.micro))
        peak = max(peak, len(live))
    # GPipe would hold S*M = 64; 1F1B stays near S*(S+1)/2
    assert peak <= S * (S + 1)


def test_bubble_fraction():
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 28) < 0.1


def test_pipeline_executor_matches_reference_grads():
    """2-stage pipelined fwd+bwd == monolithic autograd, and == the
    reference's executor on the same inputs (f32; tolerances the
    reference's own, 1e-6 / 1e-5 relative)."""
    rng = np.random.default_rng(0)
    d = 8
    w1n = (rng.standard_normal((d, d)) * 0.3).astype(np.float32)
    w2n = (rng.standard_normal((d, d)) * 0.3).astype(np.float32)
    xsn = [rng.standard_normal((4, d)).astype(np.float32) for _ in range(6)]
    w1, w2 = torch.from_numpy(w1n), torch.from_numpy(w2n)
    xs = [torch.from_numpy(x) for x in xsn]

    def stage_f(w, x):
        return torch.tanh(x @ w)

    fwd, bwd = make_stages_from_model(stage_f, 2)
    ex = PipelineExecutor(fwd, bwd, [w1, w2])
    outs, grads, stats = ex.run(xs, dy_fn=lambda m, y: torch.ones_like(y))

    # unpipelined: full model, summed over microbatches
    ws = [w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)]
    total = sum(torch.sum(stage_f(ws[1], stage_f(ws[0], x))) for x in xs)
    ref_g = torch.autograd.grad(total, ws)
    y_ref = stage_f(w2, stage_f(w1, xs[-1]))
    np.testing.assert_allclose(outs[-1].numpy(), y_ref.numpy(), rtol=1e-6)
    for got, want in zip(grads, ref_g):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert stats["bubble_frac"] == pytest.approx(1 / 7)

    # the reference's executor (jax.vjp stages) on the same numpy inputs
    rfwd, rbwd = ref_pipeline.make_stages_from_model(
        lambda w, x: jnp.tanh(x @ w), 2)
    rex = ref_pipeline.PipelineExecutor(rfwd, rbwd, [jnp.asarray(w1n),
                                                     jnp.asarray(w2n)])
    routs, rgrads, rstats = rex.run([jnp.asarray(x) for x in xsn],
                                    dy_fn=lambda m, y: jnp.ones_like(y))
    for got, want in zip(outs, routs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in zip(grads, rgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert stats == rstats


def test_pipeline_executor_tree_params():
    """A stage's parameters may be a tree (nested dicts), as a model's
    are: its gradients come back as the same tree."""
    rng = np.random.default_rng(1)
    p = [{"w": torch.tensor(rng.standard_normal((6, 6)) * 0.3,
                            dtype=torch.float32),
          "b": {"bias": torch.tensor(rng.standard_normal(6),
                                     dtype=torch.float32)}}
         for _ in range(3)]
    xs = [torch.tensor(rng.standard_normal((2, 6)), dtype=torch.float32)
          for _ in range(4)]

    def stage_f(q, x):
        return torch.tanh(x @ q["w"] + q["b"]["bias"])

    fwd, bwd = make_stages_from_model(stage_f, 3)
    _, grads, _ = PipelineExecutor(fwd, bwd, p).run(
        xs, dy_fn=lambda m, y: 2 * y)
    live = [{"w": q["w"].clone().requires_grad_(True),
             "b": {"bias": q["b"]["bias"].clone().requires_grad_(True)}}
            for q in p]
    total = 0
    for x in xs:
        y = x
        for q in live:
            y = stage_f(q, y)
        total = total + torch.sum(y * y)
    flat = [t for q in live for t in (q["w"], q["b"]["bias"])]
    want = torch.autograd.grad(total, flat)
    got = [t for g in grads for t in (g["w"], g["b"]["bias"])]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_int8_optimizer_state():
    """8-bit moments: converges on the quadratic and uses ~2 bytes/param."""
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                            total_steps=400)
    params = {"w": torch.tensor(np.random.default_rng(0)
                                .standard_normal(512) * 3,
                                dtype=torch.float32)}
    state = adamw.init_state_int8(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, _ = adamw.apply_updates_int8(cfg, params, g, state)
    # quantization noise leaves a small floor; demand a >500x reduction
    assert float(loss(params)) < min(5.0, l0 / 500)
    m = state["m"]["w"]
    m_bytes = m["q"].numel() * m["q"].element_size() + \
        m["scale"].numel() * m["scale"].element_size()
    assert m_bytes < 512 * 1.2  # ~1.03 bytes/param for m
