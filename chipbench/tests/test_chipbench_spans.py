"""The reduction of the program's spans (``yardstick/spans.py``) against
hand-worked traces, the benchmark's readers on traces with and without
the program's spans, and the span tracer on the cells' CPU runs."""
import pytest
from conftest import SMALL_DGEMM, SMALL_RING
from test_chipbench_counts import _obs, read
from yardstick import registry, spans, trace
from yardstick.spans import SpanEv

import traced_spans

CALL = trace.SPAN


def _events():
    """Two calls on thread 1.  Call 0 preps, runs two blocks with a hop
    between them, waits and accumulates; call 1 runs one block.  A
    worker thread 2 has a span of its own."""
    host = [
        SpanEv(CALL, "user_annotation", 0, 100, 1),
        SpanEv(CALL, "user_annotation", 100, 200, 1),
        SpanEv("blasx.gemm.prep", "user_annotation", 2, 10, 1),
        SpanEv("blasx.ring.block", "user_annotation", 10, 30, 1),
        SpanEv("blasx.ring.hop", "user_annotation", 30, 35, 1),
        SpanEv("blasx.ring.block", "user_annotation", 35, 40, 1),
        SpanEv("blasx.ring.wait", "user_annotation", 40, 90, 1),
        SpanEv("blasx.ring.accumulate", "user_annotation", 90, 98, 1),
        # a child span inside the accumulate: its self time is 8 - 3
        SpanEv("blasx.x.inner", "user_annotation", 92, 95, 1),
        SpanEv("blasx.ring.block", "user_annotation", 110, 120, 1),
        SpanEv("blasx.rt.dispatch", "user_annotation", 150, 160, 2),
        SpanEv("aten::mm", "cpu_op", 11, 29, 1, corr=900),
    ]
    launches = [
        SpanEv("cudaMemcpyAsync", "cuda_runtime", 3, 4, 1, corr=1),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 12, 13, 1, corr=2),
        SpanEv("cuLaunchKernelEx", "cuda_driver", 31, 32, 1, corr=3),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 36, 37, 1, corr=4),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 93, 94, 1, corr=5),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 99, 99, 1, corr=6),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 111, 112, 1, corr=7),
        SpanEv("cudaLaunchKernel", "cuda_runtime", 152, 153, 2, corr=8),
        # thread 2 launches while only thread 1 is in a span
        SpanEv("cudaLaunchKernel", "cuda_runtime", 112, 113, 2, corr=9),
    ]
    device = [
        SpanEv("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 5, 9, 7, 1),
        SpanEv("sm80_xmma_gemm_f32f32", "kernel", 14, 50, 7, 2),
        SpanEv("ncclDevKernel_SendRecv", "kernel", 33, 60, 8, 3),
        SpanEv("sm80_xmma_gemm_f32f32", "kernel", 50, 58, 7, 4),
        SpanEv("vectorized_elementwise_kernel", "kernel", 95, 97, 7, 5),
        SpanEv("elementwise_kernel", "kernel", 99, 101, 7, 6),
        SpanEv("sm80_xmma_gemm_f32f32", "kernel", 113, 130, 7, 7),
        SpanEv("dmma_gemm_kernel", "kernel", 154, 170, 9, 8),
        SpanEv("fill_kernel", "kernel", 171, 175, 9, 9),
        # no launch in the trace
        SpanEv("orphan_kernel", "kernel", 180, 185, 7, 77),
        # the annotation ranges torch puts on the device are not work
        SpanEv("blasx.ring.block", "gpu_user_annotation", 14, 58, 7, 0),
        SpanEv(CALL, "gpu_user_annotation", 0, 200, 7, 0),
    ]
    return host + launches + device


def test_reduce_the_program_spans_by_hand():
    r = spans.reduce(_events())
    assert r["calls"] == 2 and r["window_s"] == pytest.approx(200e-9)
    n = r["names"]
    assert {k: v["count"] for k, v in n.items()} == {
        "blasx.gemm.prep": 1, "blasx.ring.block": 3, "blasx.ring.hop": 1,
        "blasx.ring.wait": 1, "blasx.ring.accumulate": 1,
        "blasx.x.inner": 1, "blasx.rt.dispatch": 1}
    assert n["blasx.ring.accumulate"]["self_s"] == pytest.approx(5e-9)
    assert n["blasx.x.inner"]["self_s"] == pytest.approx(3e-9)
    assert n["blasx.ring.wait"]["self_s"] == pytest.approx(50e-9)
    # device time by the innermost span of each launch
    assert n["blasx.gemm.prep"]["device_s"] == pytest.approx(4e-9)
    assert n["blasx.ring.block"]["device_s"] == pytest.approx(
        (36 + 8 + 17) * 1e-9)
    assert n["blasx.ring.hop"]["device_s"] == pytest.approx(27e-9)
    assert n["blasx.x.inner"]["device_s"] == pytest.approx(2e-9)
    assert n["blasx.ring.accumulate"]["device_s"] == 0.0
    assert n["blasx.rt.dispatch"]["device_s"] == pytest.approx(16e-9)
    assert n["blasx.ring.wait"]["device_s"] == 0.0
    # the hop [33, 60) under the blocks' [14, 58): 2 ns alone
    assert n["blasx.ring.hop"]["alone_s"] == pytest.approx(2e-9)
    assert n["blasx.ring.block"]["alone_s"] == pytest.approx(
        (19 + 17) * 1e-9)
    # launched in no span: [99, 101), thread 2's [171, 175), the orphan
    assert r["outside_s"] == pytest.approx((2 + 4 + 5) * 1e-9)
    assert n["blasx.ring.block"]["device_ops"] == [
        ["sm80_xmma_gemm_f32f32", pytest.approx(61e-9)]]
    assert n["blasx.ring.block"]["by_call"] == [
        [pytest.approx(25e-9), pytest.approx(44e-9)],
        [pytest.approx(10e-9), pytest.approx(17e-9)]]
    # busy [5, 9) [14, 60) [95, 97) [99, 101) [113, 130) [154, 170)
    # [171, 175) [180, 185); the gaps' middles: [0, 5) in the prep,
    # [9, 14) in a block, [60, 95) in the wait, [97, 99) at the
    # accumulate's end (``trace.attribute`` holds a span's end), the
    # rest in no span
    assert r["busy_s"] == pytest.approx(96e-9)
    assert dict(r["idle_gaps"]) == pytest.approx({
        "blasx.gemm.prep": 5e-9, "blasx.ring.block": 5e-9,
        "blasx.ring.wait": 35e-9, "blasx.ring.accumulate": 2e-9,
        spans.NO_SPAN: (12 + 24 + 1 + 5 + 15) * 1e-9})


def test_reduce_without_the_harness_span_is_nothing():
    assert spans.reduce([SpanEv("blasx.ring.block", "user_annotation",
                                0, 1, 1)]) is None


def test_innermost_and_self_times_of_nested_spans():
    outer = SpanEv("a", "user_annotation", 0, 100)
    mid = SpanEv("b", "user_annotation", 10, 50)
    inner = SpanEv("c", "user_annotation", 20, 30)
    later = SpanEv("d", "user_annotation", 60, 70)
    got = spans.innermost([later, inner, outer, mid],
                          [25, 5, 55, 100, 65, 10, 30])
    assert [s.name if s else None for s in got] == [
        "c", "a", "a", None, "d", "b", "b"]
    empty = SpanEv("e", "user_annotation", 75, 75)
    own = spans.self_times([outer, mid, inner, later, empty])
    assert own == {outer: 100 - 40 - 10, mid: 30, inner: 10, later: 10,
                   empty: 0}


def test_the_ring_phases_a_call():
    r = spans.reduce(_events())
    got = spans.per_call(r)
    assert got["hop_exposed_ms_per_call"] == pytest.approx(2e-9 / 2 * 1e3)
    assert got["gather_ms_per_call"] == 0.0
    assert got["prep_ms_per_call"] == pytest.approx(4e-9 / 2 * 1e3)
    assert got["outside_share_pct"] == pytest.approx(100 * 11 / 96)


def test_events_missing_their_kind_are_told_apart():
    assert spans._kind_of("blasx.ring.block", True) == "gpu_user_annotation"
    assert spans._kind_of("blasx.ring.block", False) == "user_annotation"
    assert spans._kind_of(CALL, False) == "user_annotation"
    assert spans._kind_of("cuLaunchKernelEx", False) == "cuda_runtime"
    assert spans._kind_of("Memcpy DtoD (Device -> Device)", True) == \
        "gpu_memcpy"
    assert spans._kind_of("ncclDevKernel_SendRecv", True) == "kernel"


# ------------------------------------------- the benchmark's readers
def _ring_trace(with_program_spans: bool):
    """A ring call as ``trace.reduce`` sees it, with or without the
    program's spans, which torch records as host operators."""
    ev = [
        trace.Ev(CALL, "user_annotation", 0, 100, 1),
        trace.Ev("aten::pad", "cpu_op", 1, 9, 1),
        trace.Ev("cudaMemcpyAsync", "cuda_runtime", 3, 4, 1),
        trace.Ev("aten::mm", "cpu_op", 10, 30, 1),
        trace.Ev("nccl:coalesced", "cpu_op", 30, 35, 1),
        trace.Ev("nccl:coalesced", "gpu_user_annotation", 33, 60, 8),
        trace.Ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 5, 9, 7),
        trace.Ev("sm80_xmma_gemm_f32f32", "kernel", 14, 50, 7),
        trace.Ev("ncclDevKernel_SendRecv", "kernel", 33, 60, 8),
        trace.Ev("ncclDevKernel_AllGather_RING_LL", "kernel", 70, 90, 8),
        trace.Ev("cudaDeviceSynchronize", "cuda_runtime", 90, 99, 1),
    ]
    if with_program_spans:
        for name, s, e in (("blasx.gemm.prep", 1, 10),
                           ("blasx.ring.block", 10, 30),
                           ("blasx.ring.hop", 30, 35),
                           ("blasx.ring.wait", 35, 70),
                           ("blasx.gemm.gather", 70, 90)):
            ev.append(trace.Ev(name, "cpu_op", s, e, 1))
    return ev


READERS = ("ring_matmul_roofline", "p2p_hops_per_call",
                "exposed_comm_ms_per_call", "call_mfu", "device_idle_share",
                "copy_ms_per_call", "gemm_kernel_roofline", "tflops",
                "latency_p95_ms", "peak_device_gib", "setup_s",
                "h2d_bytes_per_call", "launches_per_call")


def test_the_readers_read_the_same_beside_the_program_spans():
    plain = trace.reduce(_ring_trace(False))
    spanned = trace.reduce(_ring_trace(True))
    # only the idle breakdown names the spans: the gap [9, 14) falls in
    # the block, not its aten::mm, and [60, 70) in the wait, not in
    # Python between operations
    assert {k: v for k, v in spanned.items() if k != "idle_gaps"} == {
        k: v for k, v in plain.items() if k != "idle_gaps"}
    assert dict(spanned["idle_gaps"]) == pytest.approx({
        "aten::pad": 5e-9, "blasx.ring.block": 5e-9,
        "blasx.ring.wait": 10e-9, "cudaDeviceSynchronize": 10e-9})
    assert dict(plain["idle_gaps"]) == pytest.approx({
        "aten::pad": 5e-9, "aten::mm": 5e-9, trace.NO_HOST_OP: 10e-9,
        "cudaDeviceSynchronize": 10e-9})
    for name in READERS:
        obs = _obs(chips=4, dtype="float32", calls=1)
        before = read(name, dict(obs, trace=[plain]))
        after = read(name, dict(obs, trace=[spanned]))
        assert before == after, name
    assert plain["exposed_comm_s"] == pytest.approx(30e-9)


def test_a_user_annotation_on_the_device_would_read_as_a_kernel():
    """Why the port records its spans as operators: on a torch without
    ``activity_type``, the device range of a user annotation named like
    the program's spans is a kernel to ``trace.reduce`` (and one named
    ``blasx.gemm.*`` a GEMM kernel to ``ring_matmul_roofline``)."""
    assert trace._kind_of("blasx.ring.block", True) == "kernel"
    assert trace._kind_of(CALL, True) == "gpu_user_annotation"


def test_the_span_tracer_keeps_the_profiler_options():
    assert spans.SpanTracer.__enter__ is trace.Tracer.__enter__
    assert spans.SpanTracer.span is trace.Tracer.span


# ------------------------------------------- the cells' CPU runs
def test_the_gloo_rehearsal_reduces_the_ring_spans(bench):
    got = traced_spans.run(bench, "ring-sgemm16k-x4", 2**31 + 29,
                           SMALL_RING)
    assert got["line"]["correct"]
    summaries = got["obs"]["trace"]
    assert len(summaries) == 4
    for s in summaries:
        r = s["spans"]
        per_call = {k: v["count"] / r["calls"] for k, v in r["names"].items()}
        assert per_call == {"blasx.gemm.prep": 2, "blasx.ring.block": 4,
                            "blasx.ring.hop": 3, "blasx.ring.wait": 3,
                            "blasx.ring.accumulate": 4,
                            "blasx.gemm.gather": 1}
        assert r["outside_s"] == 0.0
        assert all(len(v["by_call"]) == r["calls"]
                   for v in r["names"].values())
    # A (64 x 64 f32) padded by nothing is still a new tensor; B and the
    # ring's block go as they are
    counters = got["obs"]["counters"]
    assert counters["prep_bytes"] == 64 * 64 * 4 * got["obs"]["calls"]
    assert counters["p2p"] == 3 * got["obs"]["calls"]
    per_call = traced_spans.phases(got)
    assert per_call["prep_bytes_per_call"] == 64 * 64 * 4
    assert set(per_call) == {"hop_exposed_ms_per_call", "gather_ms_per_call",
                             "prep_ms_per_call", "outside_share_pct",
                             "prep_bytes_per_call"}


def test_the_dgemm_run_reduces_the_runtime_spans(bench_plus):
    got = traced_spans.run(bench_plus, "dgemm16k-resident", 2**31 + 29,
                           SMALL_DGEMM)
    assert got["line"]["correct"]
    r = got["obs"]["trace"][0]["spans"]
    counts = {k: v["count"] for k, v in r["names"].items()}
    calls = r["calls"]
    batches = counts["blasx.rt.gather"]
    assert batches >= calls
    assert counts == {"blasx.gemm.out": calls, "blasx.rt.plan": 2 * calls,
                      "blasx.rt.gather": batches,
                      "blasx.rt.dispatch": batches,
                      "blasx.rt.finalize": batches}


def test_the_tool_leaves_the_drivers_as_they_were(bench_plus):
    ring = registry.load_module("drivers", "ring")
    dgemm = registry.load_module("drivers", "blas_context")
    counters = ring.Port.counters
    traced_spans.run(bench_plus, "dgemm16k-resident", 2**31 + 31,
                     SMALL_DGEMM)
    with traced_spans._swapped(ring, Tracer=spans.SpanTracer), \
            traced_spans._swapped(ring.Port,
                                  counters=traced_spans._port_counters):
        assert ring.Tracer is spans.SpanTracer
    assert dgemm.Tracer is trace.Tracer
    assert ring.Tracer is trace.Tracer
    assert ring.Port.counters is counters


def test_the_port_counters_add_prep_bytes_only_where_the_program_has_it():
    class Dist:
        COLLECTIVES = {"p2p": 3}

    port = type("P", (), {"dist": Dist})()
    assert traced_spans._port_counters(port) == {"p2p": 3}
    Dist.PREP_BYTES = 1 << 30
    assert traced_spans._port_counters(port) == {"p2p": 3,
                                                 "prep_bytes": 1 << 30}
