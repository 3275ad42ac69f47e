"""DeepSeek-V3 under the port's ``DeepSeekV3Config`` against the plain
reference (``tests/reference_deepseek_v3.py``), on the CPU in float32.

At a small size with every mechanism in it (16 experts in 4 groups, 2
groups kept, top 4, experts 4..7 held, one dense layer and two MoE
layers): the prefill and 8 decode steps through ``Server`` against the
reference's full forward, logits and routes; the held experts' shares
of one MoE layer adding up to the uncut layer; the router on a case
built by hand; YaRN at the published numbers.
"""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_deepseek_v3 as ref
from repro_torch.configs.deepseek_v3_ep import DeepSeekV3Config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import Model
from repro_torch.models import moe
from repro_torch.models.sharding import NO_MESH

REPO = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((REPO / "chipbench" / "configs" /
                        "deepseek_v3_ep32_l9.json").read_text())
SMALL = dict(PUBLISHED, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=128, vocab_size=256,
             num_hidden_layers=3, q_lora_rank=32, kv_lora_rank=16,
             qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
             moe_intermediate_size=32, experts_routed_over=16,
             n_routed_experts=4, first_held_expert=4, num_experts_per_tok=4,
             n_group=4, topk_group=2)


def _normwise(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _held(experts, hf):
    lo = hf["first_held_expert"]
    return (experts >= lo) & (experts < lo + hf["n_routed_experts"])


def _held_sets(experts, hf):
    """Each row's held experts chosen, as a sorted tuple."""
    return [tuple(sorted(e for e in row.tolist()
                         if hf["first_held_expert"] <= e <
                         hf["first_held_expert"] + hf["n_routed_experts"]))
            for row in experts]


@pytest.fixture(scope="module")
def small():
    cfg = DeepSeekV3Config.from_hf(SMALL, dtype="float32")
    model = Model(cfg, NO_MESH)
    return cfg, model, model.init(seed=3, device="cpu")


def test_the_small_config_reads_the_file(small):
    cfg, _, params = small
    assert (cfg.n_experts, cfg.experts_held, cfg.expert_first) == (16, 4, 4)
    assert (cfg.n_layers, cfg.n_dense_layers, cfg.norm_eps) == (3, 1, 1e-6)
    assert not cfg.mtp and "mtp_block" not in params
    m = params["moe_blocks"]["moe"]
    assert m["router"].shape == (2, 64, 16) and m["bias"].shape == (2, 16)
    assert m["w_gate"].shape == (2, 4, 64, 32)


def test_prefill_and_decode_match_the_reference(small):
    """Prefill of two prompts of different lengths into two slots, then
    8 batched decode steps: every step's logits of both slots against
    the reference's full forward over the slot's tokens so far, and
    the held experts each MoE layer chose at that position."""
    cfg, model, params = small
    rng = np.random.default_rng(11)
    reqs = [Request(i, rng.integers(0, SMALL["vocab_size"], (n,)
                                    ).astype(np.int32), 64)
            for i, n in enumerate((11, 6))]
    server = Server(cfg, model, params, 2, 32)
    got, held_counts = [], 0
    for slot, req in enumerate(reqs):
        with moe.record_routes() as routes:
            server.admit(req, slot)
        got.append((req, len(req.prompt) - 1, server.last_logits.clone(),
                    [r[-1] for r in routes]))
    for _ in range(8):
        with moe.record_routes() as routes, \
                moe.count_held_slots() as held:
            server.step()
        held_counts += sum(sum(c) for c in held)
        for slot, req in enumerate(reqs):
            got.append((req, len(req.prompt) + len(req.out) - 2,
                        server.last_logits[slot].clone(),
                        [r[slot] for r in routes]))
    want_held = 0
    for req, pos, logits, routes in got:
        tokens = torch.as_tensor(np.concatenate([req.prompt, req.out])
                                 [:pos + 1], dtype=torch.long)
        want, want_routes = ref.forward(params, tokens, SMALL, at=[pos])
        assert _normwise(logits, want[0]) < 1e-5, pos
        assert [_held_sets(r[None], SMALL) for r in routes] == \
            [_held_sets(r[pos][None], SMALL) for r in want_routes]
        if pos >= len(req.prompt):      # a decode step's position
            want_held += sum(int(_held(r[pos], SMALL).sum())
                             for r in want_routes)
    assert held_counts == want_held > 0


def _layer(cfg, params, first, held):
    """MoE layer 0's weights with only experts first..first+held-1."""
    p = {k: v[0] for k, v in params["moe_blocks"]["moe"].items()
         if k != "shared"}
    p["shared"] = {k: v[0] for k, v in
                   params["moe_blocks"]["moe"]["shared"].items()}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = p[k][first:first + held]
    return dataclasses.replace(cfg, expert_first=first, experts_held=held), p


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards' held-expert outputs, plus the shared expert counted
    once, equal the reference's layer with all 16 experts held."""
    hf = dict(SMALL, n_routed_experts=16, first_held_expert=0)
    cfg = DeepSeekV3Config.from_hf(hf, dtype="float32")
    params = Model(cfg, NO_MESH).init(seed=5, device="cpu")
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(2))
    c0, p0 = _layer(cfg, params, 0, 0)
    shared, _ = moe.held_moe_block(c0, p0, x, NO_MESH)
    total = shared.clone()
    for j in range(4):
        c, p = _layer(cfg, params, 4 * j, 4)
        y, aux = moe.held_moe_block(c, p, x, NO_MESH)
        assert aux == {}
        total += y - shared
    cu, pu = _layer(cfg, params, 0, 16)
    uncut, _ = moe.held_moe_block(cu, pu, x, NO_MESH)
    want, _ = ref.moe(hf, pu, x.reshape(10, 64), torch.matmul, ref.route)
    assert _normwise(total.reshape(10, 64), want) < 1e-6
    assert _normwise(uncut.reshape(10, 64), want) < 1e-6


def _logit(s):
    return math.log(s / (1 - s))


# sigmoid scores by group of 4: group 0 holds the best expert (0.95) but
# the worst pair; groups 1 (0.80 + 0.75) and 2 (0.70 + 0.65) are kept
SCORES = [0.95, 0.10, 0.10, 0.10, 0.10, 0.80, 0.75, 0.10,
          0.70, 0.65, 0.10, 0.10, 0.60, 0.55, 0.10, 0.10]


def _route(bias):
    cfg = DeepSeekV3Config.from_hf(SMALL, dtype="float32")
    router = torch.zeros((16, 16))
    router[0] = torch.tensor([_logit(s) for s in SCORES])
    x = torch.zeros((1, 16))
    x[0, 0] = 1.0
    w, e = moe.published_router(cfg, {"router": router,
                                      "bias": torch.tensor(bias)}, x)
    order = torch.argsort(e[0])
    return e[0][order].tolist(), w[0][order]


def test_the_router_keeps_to_its_groups_bias_and_scale():
    experts, weights = _route([0.0] * 16)
    # expert 0 scores best, but its group's pair is the worst
    assert experts == [5, 6, 8, 9]
    want = torch.tensor([0.80, 0.75, 0.70, 0.65])
    torch.testing.assert_close(weights, want / want.sum() * 2.5)
    assert float(weights.sum()) == pytest.approx(2.5)
    # a bias lifts expert 10 (0.10 + 0.62) past expert 9 (0.65): it is
    # chosen, and weighed by its unbiased score
    bias = [0.0] * 16
    bias[10] = 0.62
    experts, weights = _route(bias)
    assert experts == [5, 6, 8, 10]
    want = torch.tensor([0.80, 0.75, 0.70, 0.10])
    torch.testing.assert_close(weights, want / want.sum() * 2.5)
    # the reference chooses the same
    hf = dict(SMALL, experts_routed_over=16)
    router = torch.zeros((16, 16))
    router[0] = torch.tensor([_logit(s) for s in SCORES])
    x = torch.zeros((1, 16))
    x[0, 0] = 1.0
    _, chosen = ref.route(hf, {"router": router,
                               "bias": torch.tensor(bias)}, x, torch.matmul)
    assert sorted(chosen[0].tolist()) == [5, 6, 8, 10]


def test_yarn_at_the_published_numbers():
    cfg = DeepSeekV3Config.from_hf(PUBLISHED)
    inv = cfg.rope_inv_freq(64, torch.float64)
    assert inv.shape == (32,)
    assert float(inv[0]) == 1.0          # extrapolated: kept
    assert float(inv[-1]) == pytest.approx(
        1 / (40 * 10000 ** (62 / 64)), rel=1e-12)   # interpolated: / 40
    assert cfg.mla_softmax_scale() == pytest.approx(
        192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2, rel=1e-12)
    assert cfg.mla_softmax_scale() == pytest.approx(
        ref.softmax_scale(PUBLISHED))
    torch.testing.assert_close(cfg.rope_inv_freq(64),
                               ref.yarn_inv_freq(PUBLISHED))


def test_the_registry_config_keeps_its_own_router():
    """The registry's DeepSeek-V3 builds no selection bias and holds
    every expert: the published router runs under the new type alone."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek_v3_671b").reduced()
    p = Model(cfg, NO_MESH).init(seed=0, device="cpu")
    assert "bias" not in p["moe_blocks"]["moe"]
    assert p["moe_blocks"]["moe"]["w_gate"].shape[1] == cfg.n_experts


def test_the_benchmark_holds_a_copy_of_the_reference():
    assert (REPO / "chipbench" / "reference" / "deepseek_v3.py"
            ).read_text() == (REPO / "tests" /
                              "reference_deepseek_v3.py").read_text()
