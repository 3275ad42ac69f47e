"""The held experts' grouped kernels (``kernels/moe_experts.py``): their
plain version, the wrapper's checks and launches and the layer's slot
counts on the CPU, and the kernels against the plain version on the
card.

Tests marked ``cuda`` need an NVIDIA card and skip without one (decided
inside the test, never at import).  Run them on the machine with the
card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_experts.py
"""
import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro_torch.configs.deepseek_v3_ep import DeepSeekV3Config
from repro_torch.kernels import build
from repro_torch.kernels import moe_experts as kme
from repro_torch.kernels.ref import moe_experts_ref
from repro_torch.models import moe
from repro_torch.models.sharding import NO_MESH
from torch_launch import cpu_launch, fake_entry  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SOURCE = Path(kme.__file__).parent / "csrc" / "moe_experts.cu"
PUBLISHED = json.loads((REPO / "chipbench" / "configs" /
                        "deepseek_v3_ep32_l9.json").read_text())
# 16 experts in 4 groups, 2 kept, top 4, experts 4..7 held (as in
# test_torch_deepseek_v3.py)
SMALL = dict(PUBLISHED, hidden_size=64, moe_intermediate_size=32,
             experts_routed_over=16, n_routed_experts=4,
             first_held_expert=4, num_experts_per_tok=4, n_group=4,
             topk_group=2)


def _layer(hf, dtype, device, seed=0):
    """A config of ``hf`` and one MoE layer's weights: the router and its
    bias in f32, the held and shared experts in ``dtype``, N(0, 1/fan_in)."""
    cfg = DeepSeekV3Config.from_hf(hf, dtype="float32")
    g = torch.Generator(device=device).manual_seed(seed)
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    held = len(cfg.held_experts())

    def mat(*shape, dt=dtype):
        w = torch.randn(shape, generator=g, device=device)
        return (w * shape[-2] ** -0.5).to(dt)

    p = {"router": mat(d, E, dt=torch.float32),
         "bias": 0.1 * torch.randn((E,), generator=g, device=device),
         "w_gate": mat(held, d, ff), "w_up": mat(held, d, ff),
         "w_down": mat(held, ff, d),
         "shared": {"wg": mat(d, ff), "wi": mat(d, ff), "wo": mat(ff, d)}}
    return cfg, p


# ------------------------------------------------------------------ CPU
def test_plain_version_is_the_old_loop_in_f32():
    """In f32 the plain version computes exactly what the layer's loop
    computed before the kernels, bit for bit."""
    cfg, p = _layer(SMALL, torch.float32, "cpu")
    xt = torch.randn((24, 64), generator=torch.Generator().manual_seed(1))
    weights, experts = moe.published_router(cfg, p, xt)
    y, offsets = moe_experts_ref(xt, experts, weights, p["w_gate"],
                                 p["w_up"], p["w_down"], 4)
    before = chip_smoke.moe_loop_before(xt, experts, weights, p["w_gate"],
                                        p["w_up"], p["w_down"], 4)
    torch.testing.assert_close(y, before, rtol=0, atol=0)
    held = (experts >= 4) & (experts < 8)
    assert offsets.tolist()[-1] == int(held.sum())


def test_plain_version_rounds_h_once_in_bf16():
    """In bf16 the products run in f32 and h is rounded once to bf16: a
    token's output is the f32 sum over its held slots of weight times
    bf16(silu(x Wg) (x Wu)) Wd, whatever order the slots come in."""
    cfg, p = _layer(SMALL, torch.bfloat16, "cpu", seed=2)
    g = torch.Generator().manual_seed(3)
    xt = torch.randn((20, 64), generator=g).to(torch.bfloat16)
    weights, experts = moe.published_router(cfg, p, xt)
    y, _ = moe_experts_ref(xt, experts, weights, p["w_gate"], p["w_up"],
                           p["w_down"], 4)
    assert y.dtype == torch.float32
    want = torch.zeros_like(y)
    f = {k: p[k].float() for k in ("w_gate", "w_up", "w_down")}
    for t in range(20):
        for j in range(cfg.top_k):
            e = int(experts[t, j]) - 4
            if 0 <= e < 4:
                x = xt[t].float()
                h = (F.silu(x @ f["w_gate"][e]) * (x @ f["w_up"][e])
                     ).to(torch.bfloat16).float()
                want[t] += weights[t, j] * (h @ f["w_down"][e])
    # the same f32 products, summed in another order
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 1), (1, 40)], ids=["decode",
                                                          "prefill"])
def test_counts_read_once_when_the_block_closes(shape):
    """Inside ``count_held_slots`` each layer call appends its offsets
    (a tensor); once the block closes the list holds one list of ints a
    call, the bincount of the call's held routes."""
    cfg, p = _layer(SMALL, torch.float32, "cpu", seed=4)
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn((*shape, 64), generator=g) for _ in range(3)]
    with moe.count_held_slots() as held, moe.record_routes() as routes:
        for x in xs:
            moe.held_moe_block(cfg, p, x, NO_MESH)
        assert len(held) == 3 and all(isinstance(o, torch.Tensor)
                                      for o in held)
    assert len(routes) == 3
    for counts, r in zip(held, routes):
        local = r.reshape(-1) - 4
        want = torch.bincount(local[(local >= 0) & (local < 4)],
                              minlength=4)
        assert isinstance(counts, list) and all(type(c) is int
                                                for c in counts)
        assert counts == want.tolist()
    assert sum(map(sum, held)) > 0
    assert moe.MOE_HELD_SLOTS is None


def test_no_list_outside_the_block_and_nested_blocks_keep_their_own():
    cfg, p = _layer(SMALL, torch.float32, "cpu", seed=6)
    x = torch.randn((8, 1, 64), generator=torch.Generator().manual_seed(7))
    moe.held_moe_block(cfg, p, x, NO_MESH)
    assert moe.MOE_HELD_SLOTS is None
    with moe.count_held_slots() as outer:
        moe.held_moe_block(cfg, p, x, NO_MESH)
        with moe.count_held_slots() as inner:
            moe.held_moe_block(cfg, p, x, NO_MESH)
            moe.held_moe_block(cfg, p, x, NO_MESH)
        assert len(inner) == 2 and inner[0] == inner[1]
    assert outer == inner[:1]


def test_a_layer_holding_no_expert_adds_nothing():
    cfg, p = _layer(dict(SMALL, n_routed_experts=0), torch.float32, "cpu")
    xt = torch.randn((6, 64), generator=torch.Generator().manual_seed(8))
    weights, experts = moe.published_router(cfg, p, xt)
    y, offsets = kme.moe_experts(xt, experts, weights, p["w_gate"],
                                 p["w_up"], p["w_down"], 4, 16)
    assert offsets.tolist() == [0] and not y.any()


@pytest.mark.parametrize("slots,n_experts,want", [
    (256 * 8, 256, 64),      # the benchmark cell's decode: 8 an expert
    (1024 * 8, 256, 64),     # a 1024-token prompt: 32 an expert
    (1025 * 8, 256, 128),    # past half the small tile
    (4096 * 8, 256, 128),    # the longest prompt: 128 an expert
])
def test_token_tile_follows_the_routed_slots(slots, n_experts, want):
    assert kme.token_tile(slots, n_experts) == want


def test_down_splits_keep_whole_runs():
    assert kme.splits(2048) == 2        # DeepSeek-V3's ff: 32 tiles
    assert kme.splits(32) == kme.splits(1024) == 1
    assert kme.splits(4096) == 4


def test_compiled_tables_match_the_source():
    src = SOURCE.read_text()
    defines = dict(re.findall(r"#define (MOE_\w+) (\d+)", src))
    assert int(defines["MOE_BM"]) == kme.BM
    assert int(defines["MOE_BK"]) == kme.BK
    assert int(defines["MOE_TILE_SMALL"]) == kme.TILE_SMALL
    assert int(defines["MOE_TILE_LARGE"]) == kme.TILE_LARGE
    assert int(defines["MOE_MAX_HELD"]) == kme.MAX_HELD
    # the largest ring: gate's and up's two 8 KB boxes and 128 token rows
    # a stage, as many stages as fit 200 KB, the barriers, the offsets
    # and the unit prefix, and 1 KB of alignment
    stage = 4 * 64 * kme.BK * 2 + kme.TILE_LARGE * kme.BK * 2
    stages = min(int(defines["MOE_MAX_STAGES"]), 200 * 1024 // stage)
    assert stages >= 2
    assert stages * stage + 16 * stages + 8 * (kme.MAX_HELD + 1) + 1024 \
        <= 232448


@pytest.mark.parametrize("case", ["rank", "routes", "expert_dtype",
                                  "weight_shape", "weight_dtype", "device"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    cfg, p = _layer(SMALL, torch.float32, "cpu")
    xt = torch.randn((6, 64), generator=torch.Generator().manual_seed(9))
    weights, experts = moe.published_router(cfg, p, xt)
    w = [p["w_gate"], p["w_up"], p["w_down"]]
    if case == "rank":
        xt = xt[None]
    elif case == "routes":
        weights = weights[:, :2]
    elif case == "expert_dtype":
        experts = experts.int()
    elif case == "weight_shape":
        w[2] = w[2].transpose(1, 2)
    elif case == "weight_dtype":
        w[1] = w[1].double()
    elif case == "device":
        weights = torch.empty(weights.shape, device="meta")
    with pytest.raises(ValueError):
        kme.moe_experts(xt, experts, weights, *w, 4, 16)


def test_card_checks_refuse_what_the_kernels_cannot_read():
    _, p = _layer(dict(SMALL, moe_intermediate_size=36), torch.bfloat16,
                  "cpu")
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        kme._card_check(x, p["w_gate"], p["w_up"], p["w_down"])
    _, p = _layer(dict(SMALL, n_routed_experts=0), torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="held experts"):
        kme._card_check(x, p["w_gate"], p["w_up"], p["w_down"])
    _, p = _layer(SMALL, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        kme._card_check(x.float(), p["w_gate"], p["w_up"], p["w_down"])
    _, p = _layer(SMALL, torch.float16, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        kme._card_check(x.half(), p["w_gate"], p["w_up"], p["w_down"])
    _, p = _layer(SMALL, torch.bfloat16, "cpu")
    up = p["w_up"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        kme._card_check(x, p["w_gate"], up, p["w_down"])


def test_a_card_call_is_three_counted_launches(cpu_launch, monkeypatch):
    """The launches a card call makes, with the card's seam stood in
    for: the layout, then gate and up with the small token tile, then
    down in two K runs, on the sorted rows' buffers; each counted once
    under its kernel and tag."""
    layout, grouped = fake_entry("moe_layout"), fake_entry("moe_grouped")
    monkeypatch.setattr(kme, "_layout_entry", lambda: layout)
    monkeypatch.setattr(kme, "_grouped_entry", lambda: grouped)
    cfg, p = _layer(dict(SMALL, moe_intermediate_size=2048),
                    torch.bfloat16, "cpu")
    xt = torch.zeros((32, 64), dtype=torch.bfloat16)
    experts = torch.zeros((32, 4), dtype=torch.int64)
    weights = torch.zeros((32, 4))
    y, offsets = kme._launch(xt, experts, weights, p["w_gate"], p["w_up"],
                             p["w_down"], 4, 16)
    assert y.shape == (32, 64) and y.dtype == torch.float32
    assert offsets.shape == (5,) and offsets.dtype == torch.int32
    rows = 32 * 4
    (la,), (gu, dn) = layout.calls, grouped.calls
    assert la[0] == build._DTYPE_CODES[torch.bfloat16]
    assert la[4:9] == (32, 4, 64, 4, 4) and la[14] == 2 * 132
    assert gu[1:3] == (1, 64) and gu[5:7] == (2048, 64 * 2048)
    assert gu[8] == rows and gu[10:14] == (4, 2048, 64, 1)
    assert dn[1:3] == (0, 64) and dn[4] is None
    assert dn[5:7] == (64, 2048 * 64)
    assert dn[10:14] == (4, 64, 2048, 2) and dn[15] == 64
    assert gu[7] == la[12] and dn[7] == gu[14]   # xs, then h
    assert build.snapshot() == {
        build.Launch("moe_layout", "wgmma", "bfloat16"): 1,
        build.Launch("moe_experts", "wgmma", "bfloat16", ("gate_up",)): 1,
        build.Launch("moe_experts", "wgmma", "bfloat16", ("down",)): 1}


def test_a_refused_launch_raises_and_counts_nothing(cpu_launch,
                                                    monkeypatch):
    monkeypatch.setattr(kme, "_layout_entry",
                        lambda: fake_entry("moe_layout", rc=-2))
    _, p = _layer(SMALL, torch.bfloat16, "cpu")
    xt = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="moe_layout launch failed"):
        kme._launch(xt, torch.zeros((4, 4), dtype=torch.int64),
                    torch.zeros((4, 4)), p["w_gate"], p["w_up"],
                    p["w_down"], 4, 16)
    assert build.snapshot() == {}


# ----------------------------------------------------------------- card
pytest_cuda = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The benchmark cell's layer: DeepSeek-V3's widths, 8 experts held of 256
CELL = dict(PUBLISHED)
# kernels vs plain version on the card, normwise over each token's row
# of y: both sum bf16 products in f32 and round h once to bf16, but the
# tensor cores sum in another order and round otherwise than the plain
# version's f32 products, so h lands on its other bf16 neighbour in a
# share of its elements; the sound kernels read 0.65e-3 at the cell's
# decode and 2.4e-3 at its longest prefill (worst token, H100; the loop
# before the kernels, bf16 products, 4.9e-3 and 5.2e-3).  A k16 slice
# of x lost from the gate and up products reads 0.10-0.11.
TOL = 1e-2


def _row_normwise(got, want):
    """Worst row's ||got - want|| / ||want|| over rows with a held slot;
    rows without one must be exactly 0 in both."""
    norm = torch.linalg.norm(want.double(), dim=1)
    err = torch.linalg.norm((got - want).double(), dim=1)
    live = norm > 0
    assert not got[~live].any()
    return float((err[live] / norm[live]).max()) if live.any() else 0.0


def _check(cfg, p, xt, weights, experts):
    held = len(cfg.held_experts())
    build.reset()
    y, offsets = kme.moe_experts(xt, experts, weights, p["w_gate"],
                                 p["w_up"], p["w_down"],
                                 cfg.held_experts().start, cfg.n_experts)
    torch.cuda.synchronize()
    assert build.launches("moe_experts", path="wgmma", tag="gate_up") == 1
    assert build.launches("moe_experts", path="wgmma", tag="down") == 1
    assert build.launches("moe_experts") == 2
    assert build.launches("moe_layout") == 1
    want, want_off = moe_experts_ref(xt, experts, weights, p["w_gate"],
                                     p["w_up"], p["w_down"],
                                     cfg.held_experts().start)
    assert offsets.tolist() == want_off.tolist()
    assert len(offsets) == held + 1
    return _row_normwise(y, want), offsets.tolist()


@pytest_cuda
@pytest.mark.parametrize("n", [256, 4096], ids=["decode", "prefill"])
def test_kernels_match_the_plain_version_at_the_cell(card, n):
    """The cell's decode (256 tokens) and its longest prefill (4096), top
    8 of 256 by the published router on seeded inputs, experts 0-7."""
    cfg, p = _layer(CELL, torch.bfloat16, card, seed=11)
    g = torch.Generator(device=card).manual_seed(12)
    xt = torch.randn((n, cfg.d_model), generator=g, device=card
                     ).to(torch.bfloat16)
    weights, experts = moe.published_router(cfg, p, xt)
    err, offsets = _check(cfg, p, xt, weights, experts)
    assert offsets[-1] > 0
    assert err <= TOL, err


def _routes(n, rows, card):
    """Routes of n tokens built by hand: rows[t] is token t's top 8 (8
    experts of 256, those past 7 held elsewhere), weights from a seed."""
    experts = torch.tensor(rows, dtype=torch.int64, device=card)
    g = torch.Generator(device=card).manual_seed(13)
    return torch.rand((n, 8), generator=g, device=card) + 0.5, experts


@pytest_cuda
@pytest.mark.parametrize("case", ["an_empty_expert", "all_on_one",
                                  "several_held", "none_held"])
def test_kernels_at_the_edges(card, case):
    """An expert with no slot (expert 3); every token on one held expert
    (count = N, more than one token tile); tokens on several held
    experts at once; no slot on any held expert (y is zero)."""
    cfg, p = _layer(CELL, torch.bfloat16, card, seed=14)
    n = 300
    far = list(range(100, 108))
    if case == "an_empty_expert":
        rows = [[t % 8 if t % 8 != 3 else 4] + far[1:] for t in range(n)]
    elif case == "all_on_one":
        rows = [[5] + far[1:] for _ in range(n)]
    elif case == "several_held":
        rows = [[(t + j) % 8 for j in range(1 + t % 8)] + far[1 + t % 8:]
                for t in range(n)]
    else:
        rows = [far for _ in range(n)]
    weights, experts = _routes(n, rows, card)
    g = torch.Generator(device=card).manual_seed(15)
    xt = torch.randn((n, cfg.d_model), generator=g, device=card
                     ).to(torch.bfloat16)
    err, offsets = _check(cfg, p, xt, weights, experts)
    counts = [b - a for a, b in zip(offsets, offsets[1:])]
    if case == "an_empty_expert":
        assert counts[3] == 0 and min(counts[:3] + counts[4:]) > 0
    elif case == "all_on_one":
        assert counts[5] == n and sum(counts) == n
    elif case == "several_held":
        assert sum(counts) == sum(1 + t % 8 for t in range(n))
    else:
        assert sum(counts) == 0
    assert err <= TOL, err


@pytest_cuda
def test_the_layer_reads_nothing_to_the_host(card):
    """``held_moe_block`` at the cell's decode shape makes no host read,
    inside a ``count_held_slots`` block and outside one; the block's
    close reads the counts."""
    cfg, p = _layer(CELL, torch.bfloat16, card, seed=16)
    cfg = DeepSeekV3Config.from_hf(CELL, dtype="bfloat16")
    g = torch.Generator(device=card).manual_seed(17)
    x = torch.randn((256, 1, cfg.d_model), generator=g, device=card
                    ).to(torch.bfloat16)
    moe.held_moe_block(cfg, p, x, NO_MESH)   # builds and warms
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with moe.count_held_slots() as held:
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe.held_moe_block(cfg, p, x, NO_MESH)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe.held_moe_block(cfg, p, x, NO_MESH)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert len(held) == 1 and len(held[0]) == 8 and sum(held[0]) > 0
    assert torch.isfinite(y).all()
