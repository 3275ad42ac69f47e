"""The DeepSeek-V3 decode cell end to end on the CPU, at a small size of
its own (float32; 16 experts in 4 groups, 1 kept, top 4, experts 4..7
held: a token's held experts are all of them or none; 4 slots of 64
positions, each compared at 33): the port computes with the weights the
harness draws, a sound run is correct and reports its host-clock
metrics, a traced run records the program's spans, and a router that
skips the group limit is not correct."""
import time

import pytest
import torch
from repro_torch.configs.deepseek_v3_ep import DeepSeekV3Config
from repro_torch.models import Model
from repro_torch.models.sharding import NO_MESH
from repro_torch.tree import tree_flatten
from yardstick import cell, registry

CELL = "dsv3-ep32-decode8k"
SMALL = {
    "config": {"device": "cpu", "dtype": "float32", "hidden_size": 64,
               "num_attention_heads": 4, "num_key_value_heads": 4,
               "intermediate_size": 128, "vocab_size": 256,
               "num_hidden_layers": 3, "q_lora_rank": 32,
               "kv_lora_rank": 16, "qk_nope_head_dim": 8,
               "qk_rope_head_dim": 8, "v_head_dim": 8,
               "moe_intermediate_size": 32, "experts_routed_over": 16,
               "n_routed_experts": 4, "first_held_expert": 4,
               "num_experts_per_tok": 4, "n_group": 4, "topk_group": 1},
    "traffic": {"slots": 4, "max_len": 64, "prompt_min": 4,
                "prompt_max": 16, "requests": 24, "warmup_steps": 1,
                "compare_steps": 32, "trace_calls": 4},
}
SPANS = ("blasx.mla.prefill", "blasx.mla.decode", "blasx.moe.route",
         "blasx.moe.experts", "blasx.moe.shared")


def _job(bench, seed=2**31 + 11, seconds=0.5, trace=False, **fields):
    return cell.plan(bench, CELL, seed, seconds, trace, time.perf_counter(),
                     overrides=SMALL, **fields)


def test_the_cell_is_declared(bench):
    w = registry.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "deepseek_v3_ep32_l9", "decode_256x8k", 1)
    config = registry.load_json("configs", w["config"])
    assert {"n_routed_experts", "vocab_size", "num_hidden_layers"} <= set(
        config["reduced"])
    assert (config["n_routed_experts"], config["experts_routed_over"],
            config["vocab_size"] * 8) == (8, 256, 129280)
    assert [m["name"] for m in registry.end_to_end_for(bench, CELL)] == [
        "tflops", "peak_device_gib", "setup_s"]
    assert {m["name"] for m in registry.per_layer_for(bench, CELL)} == {
        "mla_decode_roofline", "expert_roofline", "router_ms_per_step"}


def _driver():
    return registry.load_module("drivers", "dsv3_serve")


def test_the_port_computes_with_the_harness_weights(bench):
    """The port's parameter tree holds the harness's tensors themselves,
    under every name the port builds; a name missing or a leaf of
    another dtype is refused."""
    hf = _job(bench).config
    weights = _driver().draw_weights(hf, 2**31 + 7, "cpu", torch.float32)
    model = Model(DeepSeekV3Config.from_hf(hf, dtype="float32"), NO_MESH)
    params = _driver().load_params(model, weights)
    paths, leaves = tree_flatten(params)
    assert paths == tree_flatten(weights)[0] == tree_flatten(
        model.init(0, device="cpu"))[0]
    assert all(a is b for a, b in zip(leaves, tree_flatten(weights)[1]))
    with pytest.raises(KeyError):
        _driver().load_params(model, {k: v for k, v in weights.items()
                                      if k != "lm_head"})
    with pytest.raises(ValueError):
        _driver().load_params(model, dict(weights,
                                          embed=weights["embed"].double()))


def test_the_harness_draws_what_the_configuration_states(bench):
    """Each matrix N(0, 1/fan_in), the embedding and the selection bias
    at the file's deviations, norms at its value; a held expert's
    weights are those of its number among all, whichever the share."""
    hf = dict(_job(bench).config, experts_routed_over=256, n_group=8)
    init = hf["init"]
    w = _driver().draw_weights(hf, 5, "cpu", torch.float32)
    assert float(w["embed"].std()) == pytest.approx(init["embed_std"],
                                                    rel=0.05)
    assert float(w["moe_blocks"]["moe"]["bias"].std()) == pytest.approx(
        init["bias_std"], rel=0.1)
    for path, leaf in zip(*tree_flatten(w)):
        if "norm" in path[-1] or path[-1] in ("ln1", "ln2"):
            assert bool((leaf == init["norm"]).all()), path
        elif leaf.ndim >= 2 and path[-1] not in ("embed", "bias"):
            fan_in = leaf.shape[-2]
            assert float(leaf.std()) * fan_in ** 0.5 == pytest.approx(
                1.0, rel=0.05), path
    other = _driver().draw_weights(dict(hf, first_held_expert=2,
                                        n_routed_experts=8), 5, "cpu",
                                   torch.float32)
    for name in ("w_gate", "w_up", "w_down"):
        # experts 4..7: the 3rd to 6th held there, the 1st to 4th here
        torch.testing.assert_close(other["moe_blocks"]["moe"][name][:, 2:6],
                                   w["moe_blocks"]["moe"][name],
                                   rtol=0, atol=0)
    torch.testing.assert_close(other["lm_head"], w["lm_head"], rtol=0, atol=0)


def test_a_sound_run_is_correct(bench):
    line = cell.execute(_job(bench), bench)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["limits"]) == {"normwise", "route_mismatch"}
    assert line["limits"]["normwise"]["value"] < 1e-5
    assert line["limits"]["route_mismatch"]["value"] == 0
    # peak_device_gib reads the card's allocator: no number on the CPU
    assert {"tflops", "setup_s"} == set(line["metrics"])
    assert line["metrics"]["tflops"]["value"] > 0


def test_a_traced_run_records_the_programs_spans(bench):
    job = _job(bench, trace=True)
    obs = registry.load_module("drivers", "dsv3_serve").run(job)
    assert obs["calls"] == SMALL["traffic"]["trace_calls"]
    names = obs["trace"][0]["spans"]["names"]
    layers = SMALL["config"]["num_hidden_layers"]
    calls = obs["calls"]
    assert names["blasx.mla.decode"]["count"] == layers * calls
    for name in ("blasx.moe.route", "blasx.moe.experts", "blasx.moe.shared"):
        assert names[name]["count"] >= (layers - 1) * calls
    assert set(SPANS) - {"blasx.mla.prefill"} <= set(names)
    assert obs["counters"]["held_slots"] > 0
    # 1 warm-up and 4 traced steps: each slot's request decoded on to
    # compare 32, every slot compared (4 of the cell's 8)
    (row,) = obs["compared"]
    assert [r["positions"] for r in row["slots"]] == [1 + 32] * 4
    assert len({r["slot"] for r in row["slots"]}) == 4
    assert row["positions"] == 4 * 33 and row["pairs"] == 4 * 33 * 2
    assert obs["mla_decode_least_s"] > 0 and obs["expert_least_s"] > 0
    # no device time on the CPU: the readers say nothing
    for name in ("mla_decode_roofline", "expert_roofline",
                 "router_ms_per_step"):
        assert registry.load_module("metrics", name).read(obs) is None


def test_a_router_without_its_group_limit_is_not_correct(bench, monkeypatch):
    from repro_torch.models import moe

    def ungrouped(cfg, p, xt):
        scores = torch.sigmoid(xt.float() @ p["router"].float())
        experts = (scores + p["bias"].float()).topk(cfg.top_k, -1).indices
        w = scores.gather(1, experts)
        return w / w.sum(-1, keepdim=True) * cfg.routed_scaling_factor, \
            experts

    monkeypatch.setattr(moe, "published_router", ungrouped)
    line = cell.execute(_job(bench), bench)
    assert line["correct"] is False and line["failed"] == 1
    # the routes alone tell it: the 4 x 33 x 2 pairs differ by the dozen
    assert line["limits"]["route_mismatch"]["value"] > 20


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_the_fp8_control_is_not_correct(bench, seed):
    driver = registry.load_module("drivers", "dsv3_serve")
    # a window shorter than any request keeps the compared request the
    # watched slot's first, decoded on: the reading is the seed's alone
    job = _job(bench, seed=seed, seconds=0.02, program="control")
    limits, failed = cell.judge(driver.run(job)["compared"],
                                job.config["limits"])
    assert failed == 1
