"""Every piece of every cell is found by its name, and BENCHMARK.json
keeps to the benchmark's contract."""
import json
import re

import pytest
from conftest import with_dgemm
from yardstick import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_pieces(bench_plus):
    bench = bench_plus
    for w in bench["workloads"]:
        config = registry.load_json("configs", w["config"])
        registry.load_json("traffic", w["traffic"])
        driver = registry.load_module("drivers", config["driver"])
        assert callable(driver.run)
        for m in (registry.end_to_end_for(bench, w["name"])
                  + registry.per_layer_for(bench, w["name"])):
            assert callable(registry.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind,name", [
    ("configs", "no_such_config"), ("traffic", "no_such_mix"),
    ("drivers", "no_such_driver"), ("metrics", "no_such_metric")])
def test_a_missing_piece_is_named(kind, name):
    with pytest.raises(FileNotFoundError, match=name):
        registry.path_of(kind, name)


@pytest.mark.parametrize("name", ["../run", "a/b", "", "x" * 65, "a b"])
def test_a_name_cannot_leave_its_folder(name):
    with pytest.raises(ValueError):
        registry.path_of("configs", name)


def test_unknown_workload_is_refused(bench):
    with pytest.raises(KeyError, match="nope"):
        registry.workload(bench, "nope")


def test_metrics_by_cell(bench_plus):
    bench = bench_plus
    e2e = {w["name"]: [m["name"] for m in registry.end_to_end_for(
        bench, w["name"])] for w in bench["workloads"]}
    assert e2e["dgemm16k-resident"] == ["tflops", "peak_device_gib",
                                        "setup_s"]
    assert e2e["ring-sgemm16k-x4"] == ["tflops", "latency_p95_ms",
                                       "peak_device_gib", "setup_s"]
    layer = {w["name"]: {m["name"] for m in registry.per_layer_for(
        bench, w["name"])} for w in bench["workloads"]}
    assert layer["dgemm16k-resident"] == layer["dgemm16k-host"] == {
        "h2d_bytes_per_call", "copy_ms_per_call", "launches_per_call",
        "gemm_kernel_roofline", "call_mfu", "device_idle_share"}
    assert layer["ring-sgemm16k-x4"] == {
        "ring_matmul_roofline", "p2p_hops_per_call",
        "exposed_comm_ms_per_call", "call_mfu", "device_idle_share"}


def test_a_per_layer_metric_without_cells_follows_what_it_moves(bench_plus):
    b = json.loads(json.dumps(bench_plus))
    b["per_layer"].append({"name": "x_share", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "latency_p95_ms"})
    assert "x_share" in {m["name"] for m in registry.per_layer_for(
        b, "ring-sgemm16k-x4")}
    assert "x_share" not in {m["name"] for m in registry.per_layer_for(
        b, "dgemm16k-resident")}


@pytest.mark.parametrize("with_cells", [False, True],
                         ids=["as_committed", "with_dgemm_cells"])
def test_benchmark_json_keeps_to_the_contract(bench, with_cells):
    if with_cells:
        bench = with_dgemm(bench)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["chipbench"]
    assert bench["command"][1] == "chipbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"] == f"chipbench/configs/{c['name']}.json"
        data = registry.load_json("configs", c["name"])
        assert data["reduced"] == c["reduced"]
    cells = bench["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    used = {w["config"] for w in cells}
    assert used == set(configs)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in
                                  registry.end_to_end_for(bench, cell)]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        got = registry.end_to_end_for(bench, w["name"])
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert registry.per_layer_for(bench, w["name"])
