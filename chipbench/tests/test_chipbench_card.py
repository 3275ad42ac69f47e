"""The harness on a card at small sizes: every metric of a cell is read,
shares stay under 100%, and the control fails.  Each test decides inside
itself whether a card is here and skips without one.

  python -m pytest -q -m cuda chipbench/tests
"""
import pytest

from controls import readings

ON_CARD = {"config": {"m": 2048, "n": 2048, "k": 2048, "tile": 512,
                      "runtime": {"device": "cuda", "cache_bytes": 1 << 30}}}


def _need_card(n=1):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dgemm16k-host", "dgemm16k-resident"])
def test_small_dgemm_cells_on_the_card(run_cell, bench_plus, cell):
    bench = bench_plus
    _need_card()
    from yardstick import registry
    plain = run_cell(cell, seconds=1.0, overrides=ON_CARD)
    assert plain["correct"] and plain["device"]["platform"] == "gpu"
    assert set(plain["metrics"]) == {
        m["name"] for m in registry.end_to_end_for(bench, cell)}
    traced = run_cell(cell, trace=True, overrides=ON_CARD)
    assert traced["correct"]
    assert set(traced["metrics"]) == {
        m["name"] for m in registry.per_layer_for(bench, cell)}
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name in ("gemm_kernel_roofline", "call_mfu"):
        assert 0 < traced["metrics"][name]["value"] <= 105
    assert traced["metrics"]["launches_per_call"]["value"] > 0


@pytest.mark.cuda
def test_the_dgemm_control_fails_on_the_card(bench_plus):
    _need_card()
    rows = readings("dgemm16k-host", "control", [31, 32, 33], 0.5,
                    overrides=ON_CARD, bench=bench_plus)
    assert [r["correct"] for r in rows] == [False] * 3


@pytest.mark.cuda
def test_a_small_ring_on_four_cards(run_cell):
    _need_card(4)
    line = run_cell("ring-sgemm16k-x4", trace=True,
                    overrides={"config": {"device": "cuda", "m": 2048,
                                          "n": 2048, "k": 2048}})
    assert line["correct"] and line["device"]["count"] == 4
    assert 0 < line["metrics"]["ring_matmul_roofline"]["value"] <= 105
