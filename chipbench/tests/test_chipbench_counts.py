"""Operation and byte counts, roofline shares and the trace's reduction
against hand-worked values."""
import pytest
from yardstick import peaks, registry, trace
from yardstick.trace import Ev

N = 16384


def test_gemm_counts():
    assert peaks.gemm_flops(N, N, N) == 8_796_093_022_208
    assert peaks.gemm_flops(2, 3, 4) == 48
    assert peaks.gemm_bytes(N, N, N, 8) == 6_442_450_944
    assert peaks.gemm_bytes(2, 3, 4, 4) == (8 + 12 + 6) * 4


def test_least_time_and_its_bound():
    t, which = peaks.least_time(peaks.gemm_flops(N, N, N),
                                peaks.gemm_bytes(N, N, N, 8), "float64")
    assert which == "compute" and t == pytest.approx(0.1312849705)
    # one rank of four: its quarter of the products in f32
    t, _ = peaks.least_time(peaks.gemm_flops(N, N, N) / 4,
                            (N * N // 4 * 2 + N * N) * 4, "float32")
    assert t == pytest.approx(0.0328212426)
    # an outer product is bound by its bytes
    t, which = peaks.least_time(peaks.gemm_flops(8192, 8192, 1),
                                peaks.gemm_bytes(8192, 8192, 1, 4),
                                "float32")
    assert which == "memory"
    assert t == pytest.approx((8192 * 2 + 8192 * 8192) * 4 / 3.35e12)


def test_share_is_not_clipped_and_needs_a_time():
    assert peaks.share_pct(0.131, 0.22) == pytest.approx(59.545454545)
    assert peaks.share_pct(0.2, 0.1) == pytest.approx(200.0)
    assert peaks.share_pct(0.1, 0.0) is None


def test_interval_arithmetic():
    assert trace.union([(5, 9), (0, 3), (2, 4), (9, 9)]) == [(0, 4), (5, 9)]
    assert trace.minus([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert trace.minus([(0, 10)], []) == 10
    assert trace.minus([(0, 10)], [(0, 3), (4, 6), (8, 20)]) == 3
    assert trace.gaps([(10, 70), (120, 170)], 0, 200) == [
        (0, 10), (70, 120), (170, 200)]
    assert trace.gaps([(0, 250)], 0, 200) == []


def _events():
    return [
        Ev(trace.SPAN, "user_annotation", 0, 100, 1),
        Ev(trace.SPAN, "user_annotation", 100, 200, 1),
        Ev(trace.SPAN, "gpu_user_annotation", 0, 200, 0),
        Ev("outer", "cpu_op", 0, 200, 1),
        Ev("aten::copy_", "cpu_op", 70, 95, 1),
        Ev("cudaMemcpyAsync", "cuda_runtime", 75, 90, 1),
        Ev("elsewhere", "cpu_op", 0, 200, 2),
        Ev("void dmma_gemm_kernel<128, 64, 16, 3>(double const*)", "kernel",
           10, 50, 7),
        Ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40, 70, 7),
        Ev("ncclDevKernel_SendRecv(ncclDevComm*)", "kernel", 120, 160, 7),
        Ev("sm90_xmma_gemm_f32f32_f32f32", "kernel", 150, 170, 7),
        Ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 190, 260, 7),
    ]


def test_reduce_a_trace_by_hand():
    s = trace.reduce(_events())
    assert s["window_s"] == pytest.approx(200e-9)
    # busy: [10, 70], [120, 170], [190, 200] (the last copy clipped)
    assert s["busy_s"] == pytest.approx(120e-9)
    assert s["exposed_comm_s"] == pytest.approx(30e-9)
    assert s["copy_s"] == pytest.approx({"HtoD": 30e-9, "DtoH": 10e-9})
    assert s["kernels"]["ncclDevKernel_SendRecv(ncclDevComm*)"] == [
        pytest.approx(40e-9), 1]
    assert s["device_ops"][0][1] == pytest.approx(40e-9)
    # gaps [0, 10] and [170, 190] under "outer", [70, 120] (middle 95)
    # under aten::copy_ on the calling thread
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"outer": 30e-9, "aten::copy_": 50e-9})


def test_reduce_without_spans_is_nothing():
    assert trace.reduce([Ev("k", "kernel", 0, 1, 0)]) is None


def test_a_gap_outside_every_host_event():
    events = [Ev(trace.SPAN, "user_annotation", 0, 100, 1),
              Ev("k", "kernel", 0, 40, 0)]
    s = trace.reduce(events)
    assert s["idle_gaps"] == [[trace.NO_HOST_OP, pytest.approx(60e-9)]]


def _obs(**kw):
    obs = {"platform": "gpu", "chips": 1, "dtype": "float64",
           "m": N, "n": N, "k": N,
           "flops_per_call": peaks.gemm_flops(N, N, N),
           "bytes_per_call": peaks.gemm_bytes(N, N, N, 8),
           "local_flops_per_call": peaks.gemm_flops(N, N, N),
           "local_bytes_per_call": peaks.gemm_bytes(N, N, N, 8),
           "calls": 4, "window_s": 10.0, "latencies_s": [2.5] * 4,
           "setup_s": 12.5, "peak_bytes": 6 * 2**30,
           "counters": {"h2d_bytes": 4 * 4294967296, "kernel_launches": 256,
                        "p2p": 12},
           "trace": [{"window_s": 10.0, "busy_s": 2.5, "exposed_comm_s": 0.02,
                      "kernels": {"void dmma_gemm_kernel<128>(double)":
                                  [0.88, 256],
                                  "ncclDevKernel_SendRecv": [0.1, 12],
                                  "ampere_sgemm_128x64_nn": [0.4, 16]},
                      "copy_s": {"HtoD": 1.2, "DtoH": 0.4, "DtoD": 9.0},
                      "device_ops": [], "idle_gaps": []}]}
    obs.update(kw)
    return obs


def read(name, obs):
    return registry.load_module("metrics", name).read(obs)


def test_metric_readers_by_hand():
    obs = _obs()
    assert read("tflops", obs) == pytest.approx(4 * 8.796093022208 / 10)
    assert read("peak_device_gib", obs) == pytest.approx(6.0)
    assert read("setup_s", obs) == 12.5
    assert read("h2d_bytes_per_call", obs) == 4294967296
    assert read("launches_per_call", obs) == 64
    assert read("p2p_hops_per_call", obs) == 3
    assert read("copy_ms_per_call", obs) == pytest.approx(400.0)
    assert read("gemm_kernel_roofline", obs) == pytest.approx(
        100 * 0.1312849705 / 0.22)
    assert read("call_mfu", obs) == pytest.approx(
        100 * 4 * 8.796093022208e12 / (10.0 * 67e12))
    assert read("device_idle_share", obs) == pytest.approx(75.0)
    assert read("exposed_comm_ms_per_call", obs) == pytest.approx(5.0)
    assert read("latency_p95_ms", obs) == pytest.approx(2500.0)


def test_ring_readers_by_hand():
    quarter = peaks.gemm_flops(N, N, N) // 4
    obs = _obs(chips=4, dtype="float32", local_flops_per_call=quarter,
               local_bytes_per_call=(N * N // 4 * 2 + N * N) * 4)
    # every GEMM kernel, never the collective: (0.88 + 0.4) / 4 s a call
    assert read("ring_matmul_roofline", obs) == pytest.approx(
        100 * 0.0328212426 / 0.32)
    # the whole call's share is of every card's peak
    assert read("call_mfu", obs) == pytest.approx(
        100 * 4 * 8.796093022208e12 / (10.0 * 67e12 * 4))
    assert read("tflops", obs) == pytest.approx(4 * 8.796093022208 / 10)
    assert read("device_idle_share", obs) == pytest.approx(75.0)


def test_readers_find_nothing_where_nothing_was_read():
    bare = _obs(trace=None, counters={}, platform="cpu", latencies_s=[])
    for name in ("copy_ms_per_call", "gemm_kernel_roofline",
                 "ring_matmul_roofline", "exposed_comm_ms_per_call",
                 "device_idle_share", "h2d_bytes_per_call",
                 "launches_per_call", "p2p_hops_per_call", "call_mfu",
                 "peak_device_gib", "latency_p95_ms"):
        assert read(name, bare) is None, name
    idle = _obs()
    idle["trace"][0]["busy_s"] = 0.0
    assert read("device_idle_share", idle) is None
    assert read("copy_ms_per_call", idle) is None
    no_kernel = _obs()
    no_kernel["trace"][0]["kernels"] = {}
    assert read("gemm_kernel_roofline", no_kernel) is None
    assert read("exposed_comm_ms_per_call", no_kernel) is None
