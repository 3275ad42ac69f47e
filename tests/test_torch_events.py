"""The port's discrete-event engine against the reference's.

Twins of ``test_events.py``: bitwise parity with the lump-sum model
(the port's numpy backend held bitwise to the reference's, the sim
ledgers exactly), the overlap invariant, idle accounting, the
Chrome-trace schema round trip and the engine's unit-level timing —
each beside the reference's numbers for the same inputs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core import events as ref_events
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro_torch.core import blas3
from repro_torch.core.events import (EventEngine, LinkTimeline, TimedTask,
                                     TimedXfer, max_concurrent, trace_spans,
                                     validate_trace)
from repro_torch.core.runtime import (BlasxRuntime, RuntimeConfig,
                                      config_from_reference)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy while this module runs (the reason is
    in ``test_torch_precision.py``)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit is an economy, not a requirement
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _ref_cfg(time_model, **kw):
    kw.setdefault("n_devices", 3)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 32 << 20)
    return RefConfig(time_model=time_model, **kw)


def _pair(time_model, **kw):
    """(reference runtime, port runtime) over one modeled machine, both
    on the numpy backend (the port's on the host)."""
    rc = _ref_cfg(time_model, **kw)
    return RefRuntime(rc), BlasxRuntime(
        config_from_reference(dataclasses.asdict(rc), device="cpu"))


def _port_cfg(**kw):
    return RuntimeConfig(backend="numpy", device="cpu", **kw)


def _call(mod, routine, dtype, runtime):
    n, tile = 320, 128   # ragged edge tiles included
    rng = np.random.default_rng(42)  # identical operands per engine
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))
    C = rng.standard_normal((n, n))
    kw = dict(tile=tile, runtime=runtime, dtype=dtype)
    if routine == "gemm":
        return mod.gemm(A, B, C, beta=0.5, **kw)
    if routine == "symm":
        return mod.symm(A, B, **kw)
    if routine == "syrk":
        return mod.syrk(A, C, beta=0.5, uplo="L", **kw)
    if routine == "syr2k":
        return mod.syr2k(A, B, **kw)
    if routine == "trmm":
        return mod.trmm(A, B, uplo="L", **kw)
    if routine == "trsm":
        return mod.trsm(A + n * np.eye(n), B, **kw)
    raise AssertionError(routine)


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize(
    "routine", ["gemm", "symm", "syrk", "syr2k", "trmm", "trsm"])
def test_event_engine_bitwise_parity(routine, dtype):
    """The event engine only reassigns clocks: the port's outputs are
    bitwise identical to the lump-sum model — and to the reference's —
    on every routine and precision, with the reference's ledgers."""
    outs = {}
    for time_model in ("events", "lump"):
        ref_rt, rt = _pair(time_model)
        got = _call(blas3, routine, dtype, rt)
        want = _call(ref_blas3, routine, dtype, ref_rt)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
        assert rt.stats() == ref_rt.stats()
        assert rt.makespan() == ref_rt.makespan()
        outs[time_model] = got
    assert outs["events"].dtype == outs["lump"].dtype
    assert np.array_equal(outs["events"], outs["lump"])


# --------------------------------------------------- overlap invariant
@pytest.mark.parametrize(
    "policy", ["blasx", "parsec", "cublasxt", "static", "supermatrix"])
def test_overlap_on_never_slower_than_off(policy):
    """Letting communication hide behind compute can only shorten the
    modeled makespan — on every policy, as in the reference."""
    def makespans(overlap):
        rc = RefConfig(n_devices=2, mode="sim", policy=policy, execute=False,
                       cache_bytes=1 << 30, overlap_comm=overlap,
                       record_trace=False)
        ref_rt, rt = RefRuntime(rc), BlasxRuntime(
            config_from_reference(dataclasses.asdict(rc), device="cpu"))
        ref_blas3.shadow_run("gemm", 4096, tile=512, runtime=ref_rt)
        blas3.shadow_run("gemm", 4096, tile=512, runtime=rt)
        assert rt.makespan() == ref_rt.makespan()
        return rt.makespan()

    assert makespans(True) <= makespans(False) * (1 + 1e-9)


# -------------------------------------------------- idle-time accounting
@pytest.mark.parametrize("time_model", ["events", "lump"])
def test_trsm_chain_stall_is_accounted_idle(time_model):
    """A single-tile-column TRSM chain forces the second device to
    stall-nudge while the chain serializes on its peer; the nudged time
    is ledger-charged so busy + idle sums to the clock."""
    n, tile = 512, 128
    r = np.random.default_rng(11)
    A = r.standard_normal((n, n)) + n * np.eye(n)
    B = r.standard_normal((n, tile))   # one tile column -> pure chain
    ref_rt, rt = _pair(time_model, n_devices=2)
    out = blas3.trsm(A, B, tile=tile, runtime=rt)
    assert np.array_equal(out, ref_blas3.trsm(A, B, tile=tile,
                                              runtime=ref_rt))
    np.testing.assert_allclose(np.triu(A) @ out, B, rtol=1e-8, atol=1e-8)
    assert rt.stats() == ref_rt.stats()
    assert sum(d.ledger.idle_time for d in rt.devices) > 0
    for d in rt.devices:
        assert d.ledger.busy_time + d.ledger.idle_time == \
            pytest.approx(d.clock, rel=1e-9, abs=1e-12)


def test_dependency_wait_is_idle_not_busy():
    n, tile = 512, 128
    r = np.random.default_rng(12)
    A = r.standard_normal((n, n)) + n * np.eye(n)
    B = r.standard_normal((n, n))
    ref_rt, rt = _pair("events", n_devices=2, policy="cublasxt")
    blas3.trsm(A, B, tile=tile, runtime=rt)
    ref_blas3.trsm(A, B, tile=tile, runtime=ref_rt)
    assert rt.stats() == ref_rt.stats()
    for d in rt.devices:
        assert d.ledger.busy_time + d.ledger.idle_time == \
            pytest.approx(d.clock, rel=1e-9, abs=1e-12)
    assert sum(d.ledger.idle_time for d in rt.devices) > 0


# ----------------------------------------------------- ledger additions
def test_event_ledger_link_busy_and_overlap_efficiency():
    A = np.random.default_rng(13).standard_normal((512, 512))
    ref_rt, rt = _pair("events", n_devices=2)
    blas3.gemm(A, A, tile=128, runtime=rt)
    ref_blas3.gemm(A, A, tile=128, runtime=ref_rt)
    assert rt.stats() == ref_rt.stats()
    led0 = rt.devices[0].ledger
    assert led0.h2d_busy_s > 0 and led0.d2h_busy_s > 0
    for d in rt.devices:
        led = d.ledger
        assert led.h2d_busy_s + led.d2d_busy_s + led.d2h_busy_s == \
            pytest.approx(led.comm_time, rel=1e-9)
        assert 0.0 <= led.overlap_efficiency <= 1.0
        assert led.unoverlapped_comm <= led.comm_time * (1 + 1e-9)
    stats = rt.stats()["device0"]
    assert "overlap_efficiency" in stats and "idle_time" in stats
    assert "h2d_busy_s" in stats


# ------------------------------------------------------------- tracing
def _traced_gemm_ctx(policy="blasx", passes=2, port=True):
    from repro.api import BlasxContext as RefContext
    from repro_torch.api import BlasxContext

    r = np.random.default_rng(14)
    A = r.standard_normal((1024, 1024))
    B = r.standard_normal((1024, 1024))
    if port:
        ctx = BlasxContext(_port_cfg(n_devices=2, mode="sim",
                                     policy=policy), tile=128)
    else:
        ctx = RefContext(RefConfig(n_devices=2, mode="sim", policy=policy),
                         tile=128)
    Ah, Bh = ctx.tile(A), ctx.tile(B)
    for _ in range(passes):
        ctx.gemm(Ah, Bh)
    return ctx


def test_trace_roundtrip_and_stream_concurrency(tmp_path):
    """A 2-device DGEMM trace round-trips through the schema validator
    with >= n_streams concurrent compute spans on at least one device,
    and its spans are the reference's."""
    ctx = _traced_gemm_ctx()
    ref_ctx = _traced_gemm_ctx(port=False)
    try:
        path = tmp_path / "trace.json"
        tr = ctx.trace(str(path))
        summary = validate_trace(tr)
        assert summary["spans"] > 0
        reloaded = json.loads(path.read_text())
        assert validate_trace(reloaded) == summary
        n_streams = ctx.cfg.n_streams
        assert max(max_concurrent(reloaded, device=d)
                   for d in range(2)) >= n_streams
        cats = {sp["cat"] for sp in trace_spans(reloaded)}
        assert cats <= {"compute", "h2d", "d2d", "d2h"}
        assert "compute" in cats and "h2d" in cats
        ref_tr = ref_ctx.trace()
        assert summary == ref_events.validate_trace(ref_tr)

        def timing(spans):
            return [(s["cat"], s["start"], s["end"]) for s in spans]

        assert timing(trace_spans(tr)) == \
            timing(ref_events.trace_spans(ref_tr))
    finally:
        ctx.close()
        ref_ctx.close()


def test_trace_cublasxt_caps_streams_at_two():
    ctx = _traced_gemm_ctx(policy="cublasxt")
    try:
        tr = ctx.trace()
        validate_trace(tr)
        for dev in range(2):
            conc = max_concurrent(tr, device=dev)
            assert 1 <= conc <= 2
    finally:
        ctx.close()


def test_trace_empty_but_valid_outside_event_engine():
    rt = BlasxRuntime(_port_cfg(n_devices=2, mode="sim", time_model="lump",
                                cache_bytes=32 << 20))
    A = np.random.default_rng(15).standard_normal((256, 256))
    blas3.gemm(A, A, tile=128, runtime=rt)
    summary = validate_trace(rt.trace())
    assert summary["spans"] == 0


def test_trace_resets_with_runtime():
    rt = BlasxRuntime(_port_cfg(n_devices=2, mode="sim",
                                cache_bytes=32 << 20))
    A = np.random.default_rng(16).standard_normal((256, 256))
    blas3.gemm(A, A, tile=128, runtime=rt)
    assert validate_trace(rt.trace())["spans"] > 0
    rt.reset()
    assert validate_trace(rt.trace())["spans"] == 0


# ----------------------------------------------- validator adversarial
def test_validator_rejects_malformed_traces():
    good = {"traceEvents": [
        {"name": "x", "cat": "compute", "ph": "B", "ts": 0.0,
         "pid": 0, "tid": 0, "args": {}},
        {"name": "x", "cat": "compute", "ph": "E", "ts": 5.0,
         "pid": 0, "tid": 0},
    ], "otherData": {"schema": 1}}
    assert validate_trace(good) == ref_events.validate_trace(good)
    unbalanced = {"traceEvents": good["traceEvents"][:1],
                  "otherData": {"schema": 1}}
    with pytest.raises(ValueError, match="unbalanced"):
        validate_trace(unbalanced)
    orphan_e = {"traceEvents": [good["traceEvents"][1]],
                "otherData": {"schema": 1}}
    with pytest.raises(ValueError, match="E without matching B"):
        validate_trace(orphan_e)
    backwards = {"traceEvents": [
        dict(good["traceEvents"][0], ts=7.0),
        dict(good["traceEvents"][1], ts=5.0),
    ], "otherData": {"schema": 1}}
    with pytest.raises(ValueError, match="monotonic"):
        validate_trace(backwards)
    with pytest.raises(ValueError, match="schema"):
        validate_trace({"traceEvents": [], "otherData": {}})


# ----------------------------------------------------- engine unit level
def test_shared_host_link_serializes_h2d_across_devices():
    """Two devices fetching concurrently on a shared host link must
    serialize; on private links they proceed in parallel."""
    def span_of(shared):
        cfg = _port_cfg(n_devices=2, mode="sim", shared_host_link=shared)
        eng = EventEngine(cfg)
        items = [TimedTask(task_id=0, name="t", compute_s=0.0,
                           fetches=[TimedXfer("h2d", 8, 1.0, "A")])]
        s0, _, _ = eng.schedule_batch(0, 0.0, items, 4, True)
        s1, _, _ = eng.schedule_batch(1, 0.0, items, 4, True)
        return s0, s1

    assert span_of(shared=True) == (1.0, 2.0)
    assert span_of(shared=False) == (1.0, 1.0)


def test_link_timeline_fifo():
    link = LinkTimeline()
    assert link.acquire(0.0, 2.0) == 0.0
    assert link.acquire(1.0, 1.0) == 2.0   # queued behind in-flight xfer
    assert link.acquire(5.0, 1.0) == 5.0   # idle gap: starts on request
    assert link.busy_s == pytest.approx(4.0)


def test_no_overlap_batch_serializes_on_one_lane():
    cfg = _port_cfg(n_devices=1, mode="sim")
    eng = EventEngine(cfg)
    items = [TimedTask(task_id=i, name=f"t{i}", compute_s=1.0,
                       fetches=[TimedXfer("h2d", 8, 1.0, "A")])
             for i in range(2)]
    span_overlap, _, _ = eng.schedule_batch(0, 0.0, items, 4, True)
    eng2 = EventEngine(cfg)
    span_serial, finishes, _ = eng2.schedule_batch(0, 0.0, items, 4, False)
    assert span_serial == pytest.approx(4.0)   # (fetch+compute) x 2, chained
    assert finishes == [pytest.approx(2.0), pytest.approx(4.0)]
    assert span_overlap < span_serial
