"""The MLA absorbed-decode kernel (``kernels/mla_decode.py``): its plain
version and wrapper on the CPU, and the kernel against the plain version
on the card.

Tests marked ``cuda`` need an NVIDIA card and skip without one (decided
inside the test, never at import).  Run them on the machine with the
card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_decode.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.core.dtypes import dtype_name
from repro_torch.kernels import mla_decode as kmla
from repro_torch.kernels.ref import mla_decode_ref
from repro_torch.models import attention as attn

SOURCE = Path(kmla.__file__).parent / "csrc" / "mla_decode.cu"


def _operands(gen, b, h, skv, r, dr, cache_dtype):
    """q_c f32, q_rope f32 and a cache of ``cache_dtype``, all N(0, 1), on
    the generator's device."""
    dev = gen.device
    q_c = torch.randn((b, h, r), generator=gen, device=dev)
    q_rope = torch.randn((b, h, dr), generator=gen, device=dev)
    ckv = torch.randn((b, skv, r), generator=gen, device=dev).to(cache_dtype)
    kr = torch.randn((b, skv, dr), generator=gen, device=dev).to(cache_dtype)
    return q_c, q_rope, ckv, kr


def _launches() -> int:
    """The kernel's launches in this process, of every path and dtype."""
    return sum(n for d in kmla.LAUNCHES_BY_PATH.values() for n in d.values())


def _old_absorbed_decode(cfg, p, cache, idx, q_nope, q_rope, ckv, k_rope,
                         H, scale):
    """``_absorbed_decode`` as it was before the kernel: f32 over the
    whole padded cache, in PyTorch."""
    wide = attn.wide
    B = q_nope.shape[0]
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    rows = torch.arange(B, device=q_nope.device)
    ckv_c, krope_c = cache["ckv"], cache["k_rope"]
    ckv_c[rows, idx] = ckv[:, 0]
    krope_c[rows, idx] = k_rope[:, 0]
    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, H, nope + vd)
    w_uk = wide(wkv_b[..., :nope])
    w_uv = wide(wkv_b[..., nope:])
    q_c = torch.einsum("bshn,rhn->bshr", wide(q_nope), w_uk)
    Skv = ckv_c.shape[1]
    kpos = torch.arange(Skv, dtype=torch.int32, device=q_nope.device)
    valid = (idx + 1)[:, None, None, None]
    scores = (torch.einsum("bshr,bkr->bhsk", q_c, wide(ckv_c))
              + torch.einsum("bshr,bkr->bhsk", wide(q_rope),
                             wide(krope_c))) * scale
    scores = torch.where(kpos[None, None, None, :] < valid, scores,
                         torch.tensor(-1e30, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    o_c = torch.einsum("bhsk,bkr->bshr", w, wide(ckv_c))
    return torch.einsum("bshr,rhv->bshv", o_c, w_uv)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_absorbed_decode_equals_the_code_it_replaced_bit_for_bit(dtype):
    """On the CPU the decode takes the plain version, which computes
    exactly what ``_absorbed_decode`` computed before the kernel, on a
    reduced DeepSeek-V3's widths in each cache dtype."""
    cfg = get_config("deepseek_v3_671b").reduced()
    g = torch.Generator().manual_seed(3)
    B, H, S = 3, cfg.n_heads, 12
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    p = {"wkv_b": torch.randn((cfg.kv_lora_rank, H * (nope + vd)),
                              generator=g).to(dtype)}
    q_nope = torch.randn((B, 1, H, nope), generator=g).to(dtype)
    q_rope = torch.randn((B, 1, H, rope), generator=g).to(dtype)
    ckv = torch.randn((B, 1, cfg.kv_lora_rank), generator=g).to(dtype)
    kr = torch.randn((B, 1, rope), generator=g).to(dtype)
    cache = {"ckv": torch.randn((B, S, cfg.kv_lora_rank),
                                generator=g).to(dtype),
             "k_rope": torch.randn((B, S, rope), generator=g).to(dtype)}
    twin = {k: v.clone() for k, v in cache.items()}
    idx = torch.tensor([0, 5, S - 1])
    before = _launches()
    got = attn._absorbed_decode(cfg, p, cache, idx, q_nope, q_rope, ckv,
                                kr, H, 0.3)
    want = _old_absorbed_decode(cfg, p, twin, idx, q_nope, q_rope, ckv, kr,
                                H, 0.3)
    assert torch.equal(got, want)
    assert all(torch.equal(cache[k], twin[k]) for k in cache)
    assert _launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64], ids=str)
def test_cpu_calls_take_the_plain_version_and_count_no_launch(
        dtype, idx_dtype, monkeypatch):
    monkeypatch.setattr(kmla, "LAUNCHES_BY_PATH", {})
    g = torch.Generator().manual_seed(1)
    ops = _operands(g, 2, 3, 10, 16, 8, dtype)
    idx = torch.tensor([2, 9], dtype=idx_dtype)
    before = _launches()
    got = kmla.mla_decode(*ops, idx, 0.25)
    assert torch.equal(got, mla_decode_ref(*ops, idx, 0.25))
    assert got.shape == (2, 3, 16) and got.dtype == torch.float32
    assert _launches() == before
    assert kmla.LAUNCHES_BY_PATH == {}


def test_plain_version_reads_only_the_live_positions():
    """What lies past a slot's last live position (idx) changes nothing,
    and each slot's output is softmax attention over its own prefix."""
    g = torch.Generator().manual_seed(2)
    q_c, q_rope, ckv, kr = _operands(g, 2, 3, 12, 16, 8, torch.float32)
    idx = torch.tensor([4, 11])
    got = mla_decode_ref(q_c, q_rope, ckv, kr, idx, 0.2)
    ckv2, kr2 = ckv.clone(), kr.clone()
    ckv2[0, 5:] = 7.0
    kr2[0, 5:] = -3.0
    torch.testing.assert_close(
        mla_decode_ref(q_c, q_rope, ckv2, kr2, idx, 0.2), got,
        rtol=0, atol=0)
    for b in range(2):
        n = int(idx[b]) + 1
        s = (q_c[b] @ ckv[b, :n].T + q_rope[b] @ kr[b, :n].T) * 0.2
        torch.testing.assert_close(got[b], torch.softmax(s, -1) @ ckv[b, :n],
                                   rtol=1e-5, atol=1e-6)


def test_operator_fake_and_flop_formula():
    """On fake tensors the operator launches nothing and leaves o's shape
    and dtype; ``FlopCounterMode`` counts it at the padded length it is
    given: the scores over latent and RoPE key and the latent sum,
    2 B H Skv (2 R + Dr), as ``Counts.attention`` counts them at a live
    length."""
    B, H, S, R, Dr = 3, 128, 8192, 512, 64
    with FakeTensorMode():
        q_c = torch.empty(B, H, R)
        q_rope = torch.empty(B, H, Dr)
        ckv = torch.empty(B, S, R, dtype=torch.bfloat16)
        kr = torch.empty(B, S, Dr, dtype=torch.bfloat16)
        idx = torch.zeros(B, dtype=torch.int64)
        o = torch.empty(B, H, R)
        before = _launches()
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.mla_decode(q_c, q_rope, ckv, kr,
                                                   idx, o, 0.1)
    assert out is None
    assert o.shape == (B, H, R) and o.dtype == torch.float32
    assert _launches() == before
    assert fc.get_total_flops() == 2 * B * H * S * (2 * R + Dr)


@pytest.mark.parametrize("skv,b,h,sms,want", [
    (8192, 256, 128, 132, (8192, 1)),   # the benchmark cell: no split
    (8192, 1, 128, 132, (256, 32)),     # one slot: the shortest runs
    (8192, 4, 32, 132, (256, 32)),      # H under one group of 64
    (16, 2, 4, 132, (32, 1)),           # shorter than one tile
    (1000, 64, 64, 132, (256, 4)),      # ragged Skv: whole tiles a run
])
def test_splits_follow_skv_b_and_h(skv, b, h, sms, want):
    split, n = kmla.splits(skv, b, h, sms)
    assert (split, n) == want
    assert split % kmla.BK == 0 and split * n >= skv > split * (n - 1)


def test_cell_workspace_stays_small():
    """The cell's 256 slots fill the card unsplit, so it needs no
    partials; split into 4 runs they would still be far under the f32
    copies of the padded cache the kernel replaced (4.3 GB a copy)."""
    split, n = kmla.splits(8192, 256, 128, 132)
    assert n == 1 and kmla.workspace_floats(256, 128, n) == 0
    assert 0 < kmla.workspace_floats(256, 128, 4) * 4 < 0.6e9


def test_compiled_tables_match_the_source():
    src = SOURCE.read_text()
    defines = dict(re.findall(r"#define (MLA_\w+) (\d+)", src))
    assert int(defines["MLA_R"]) == kmla.R
    assert int(defines["MLA_ROPE"]) == kmla.ROPE
    assert int(defines["MLA_HEADS"]) == kmla.HEADS
    assert int(defines["MLA_BK"]) == kmla.BK
    assert int(defines["MLA_SIMT_MAX_R"]) == kmla.SIMT_MAX_R
    assert int(defines["MLA_SIMT_MAX_DQ"]) == kmla.SIMT_MAX_DQ
    # the wgmma block's shared memory: Q hi and lo, the ring, P hi and
    # lo, three rows of 64 floats, the barriers and 1 KB of alignment
    stages = int(defines["MLA_STAGES"])
    q = (kmla.R + kmla.ROPE) * kmla.HEADS * 2
    smem = (2 * q + stages * (kmla.R + kmla.ROPE) * kmla.BK * 2
            + 2 * kmla.HEADS * kmla.BK * 2 + 3 * kmla.HEADS * 4
            + 2 * stages * 8 + 1024)
    assert smem <= 232448


@pytest.mark.parametrize("case", ["rank", "dtype", "shape", "idx", "stride",
                                  "cache_dtypes", "device"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    g = torch.Generator().manual_seed(4)
    q_c, q_rope, ckv, kr = _operands(g, 2, 3, 10, 16, 8, torch.float32)
    idx = torch.tensor([1, 2])
    if case == "rank":
        q_c = q_c[None]
    elif case == "dtype":
        idx = idx.float()
    elif case == "shape":
        kr = kr[:, :, :4]
    elif case == "idx":
        idx = idx[:1]
    elif case == "stride":
        ckv = torch.randn(2, 10, 32, generator=g)[:, :, ::2]
    elif case == "cache_dtypes":
        kr = kr.to(torch.bfloat16)
    elif case == "device":
        idx = torch.empty(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kmla.mla_decode(q_c, q_rope, ckv, kr, idx, 0.1)


def test_mla_paths_by_cache_dtype():
    assert kmla.mla_path(torch.bfloat16) == "wgmma"
    assert kmla.mla_path(torch.float16) == "wgmma"
    assert kmla.mla_path(torch.float32) == "simt"
    assert set(kmla.PATHS) == {"wgmma", "simt"}


# ----------------------------------------------------------------- card
pytest_cuda = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel vs plain version (f32 over the padded cache), normwise per slot:
# the cache is read exactly; q_c and P enter the products as two 16-bit
# terms each (~16 bits of each: 2^-17 relative), exp2 is the 2^-22
# approximation, and the f32 sums run in another order, so the kernel
# should read ~1e-5.  P rounded once to bf16 (the usual flash shortcut)
# reads ~2e-3 (PERF.md, K5), which this limit fails.
WGMMA_TOL = 1e-4
# the simt path: f32 FMAs in another order than the plain version's
SIMT_TOL = 1e-5
# the lengths the card tests cover: one position, one tile and its
# neighbours, the cell's shortest prompt plus one, a slot's end minus one
# thousand, and the whole cache
LIVE = (1, 63, 64, 65, 1025, 7167, 8192)


def _worst_slot(got, want) -> float:
    err = torch.linalg.norm((got - want).double().flatten(1), dim=1)
    return float((err / torch.linalg.norm(want.double().flatten(1),
                                          dim=1)).max())


def _lengths(b, skv, gen):
    """LIVE cyclically over the first slots, the rest uniform in [1,
    skv]; as idx (last live position), int64 on the card."""
    live = np.array([min(LIVE[i % len(LIVE)], skv) for i in range(b)])
    rest = np.random.default_rng(gen).integers(1, skv + 1, size=b)
    live[len(LIVE):] = rest[len(LIVE):]
    return torch.from_numpy(live - 1)


@pytest_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_kernel_at_the_cells_shape(card, dtype):
    """H 128, R 512, rope 64, Skv 8192, B 256, each LIVE length on a slot
    of its own and the rest uniform; the kernel against the plain
    version on the card."""
    B, H, S = 256, 128, 8192
    g = torch.Generator(device=card).manual_seed(10)
    ops = _operands(g, B, H, S, 512, 64, dtype)
    idx = _lengths(B, S, 10).to(card)
    name = dtype_name(dtype)
    before = kmla.LAUNCHES_BY_PATH.get("wgmma", {}).get(name, 0)
    got = kmla.mla_decode(*ops, idx, 192 ** -0.5)
    torch.cuda.synchronize()
    assert kmla.LAUNCHES_BY_PATH["wgmma"][name] == before + 1
    want = mla_decode_ref(*ops, idx, 192 ** -0.5)
    assert _worst_slot(got, want) <= WGMMA_TOL


@pytest_cuda
@pytest.mark.parametrize("h", [32, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_kernel_with_fewer_heads_than_a_group(card, h, dtype):
    """H/n heads a rank under tensor parallelism: the rows of a 64-head
    group past H are masked, and nothing past H is written."""
    B, S = 8, 8192
    g = torch.Generator(device=card).manual_seed(h)
    ops = _operands(g, B, h, S, 512, 64, dtype)
    idx = _lengths(B, S, h).to(card).to(torch.int32)
    got = kmla.mla_decode(*ops, idx, 0.1)
    torch.cuda.synchronize()
    assert got.shape == (B, h, 512)
    assert _worst_slot(got, mla_decode_ref(*ops, idx, 0.1)) <= WGMMA_TOL


@pytest_cuda
@pytest.mark.parametrize("b,skv,live", [
    (2, 1056, (1031, 1040)),     # chip_smoke phase 10's DeepSeek-V3: 4 runs
    (1, 8192, (8192,)),          # one slot over the whole cache: 32 runs
])
def test_kernel_with_few_slots_splits_the_positions(card, b, skv, live):
    """Few slots split each slot's positions into runs (B * 2 head groups
    alone would leave most SMs idle); the runs' partials merged by the
    combine kernel, a block a (slot, head), match the plain version."""
    H = 128
    split, n = kmla.splits(skv, b, H, torch.cuda.get_device_properties(
        card).multi_processor_count)
    assert n > 1 and split * (n - 1) < max(live)
    g = torch.Generator(device=card).manual_seed(skv)
    ops = _operands(g, b, H, skv, 512, 64, torch.bfloat16)
    idx = torch.tensor(live, device=card) - 1
    got = kmla.mla_decode(*ops, idx, 192 ** -0.5)
    torch.cuda.synchronize()
    assert _worst_slot(got, mla_decode_ref(*ops, idx, 192 ** -0.5)) \
        <= WGMMA_TOL


@pytest_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_kernel_reads_strided_cache_views_in_place(card, dtype):
    """A stacked cache of layers with c_kv and the RoPE key side by side
    in one 576-wide row: the layer's ckv and k_rope are strided views
    (seq stride 576, batch stride 2 Skv 576), read as they are."""
    B, H, S = 6, 128, 4096
    g = torch.Generator(device=card).manual_seed(7)
    stack = torch.randn((B, 2, S, 576), generator=g, device=card).to(dtype)
    ckv, kr = stack[:, 1, :, :512], stack[:, 1, :, 512:]
    q_c = torch.randn((B, H, 512), generator=g, device=card)
    q_rope = torch.randn((B, H, 64), generator=g, device=card)
    idx = torch.tensor([0, 31, 32, 1024, 4000, 4095], device=card)
    got = kmla.mla_decode(q_c, q_rope, ckv, kr, idx, 0.1)
    torch.cuda.synchronize()
    want = mla_decode_ref(q_c, q_rope, ckv.contiguous(), kr.contiguous(),
                          idx, 0.1)
    assert _worst_slot(got, want) <= WGMMA_TOL


@pytest_cuda
@pytest.mark.parametrize("widths", [(512, 64), (16, 8)], ids=str)
def test_f32_cache_takes_the_simt_path(card, widths):
    r, dr = widths
    B, H, S = 3, 8, 300
    g = torch.Generator(device=card).manual_seed(r)
    ops = _operands(g, B, H, S, r, dr, torch.float32)
    idx = torch.tensor([0, 64, 299], device=card)
    before = kmla.LAUNCHES_BY_PATH.get("simt", {}).get("float32", 0)
    got = kmla.mla_decode(*ops, idx, 0.2)
    torch.cuda.synchronize()
    assert kmla.LAUNCHES_BY_PATH["simt"]["float32"] == before + 1
    assert _worst_slot(got, mla_decode_ref(*ops, idx, 0.2)) <= SIMT_TOL


@pytest_cuda
def test_bad_shapes_raise_and_a_good_launch_follows(card):
    """What the kernel cannot take raises before any launch (other
    widths on the tensor-core path, a cache stride TMA cannot read);
    the C entry refuses what reaches it unchecked; a launch after them
    is right."""
    g = torch.Generator(device=card).manual_seed(5)
    q_c, q_rope, ckv, kr = _operands(g, 2, 64, 256, 512, 64,
                                     torch.bfloat16)
    idx = torch.tensor([100, 255], device=card)
    with pytest.raises(ValueError, match="compiled for R 512"):
        kmla.mla_decode(q_c[..., :256], q_rope, ckv[..., :256].contiguous(),
                        kr, idx, 0.1)
    odd = torch.zeros((2, 256, 520), dtype=torch.bfloat16, device=card)
    odd = odd[:, :, 1:513]
    with pytest.raises(ValueError, match="16-byte"):
        kmla.mla_decode(q_c, q_rope, odd, kr, idx, 0.1)
    o = torch.empty_like(q_c)
    rc = kmla._entry()(3, q_c.data_ptr(), q_rope.data_ptr(),
                       ckv.data_ptr(), kr.data_ptr(), idx.data_ptr(), 1,
                       o.data_ptr(), None, 2, 64, 256, 256, 64, 256, 1,
                       0.1, *q_c.stride()[:2], *q_rope.stride()[:2],
                       *o.stride()[:2], *ckv.stride()[:2], *kr.stride()[:2],
                       torch.cuda.current_stream().cuda_stream)
    assert rc == -2
    got = kmla.mla_decode(q_c, q_rope, ckv, kr, idx, 0.1)
    torch.cuda.synchronize()
    want = mla_decode_ref(q_c, q_rope, ckv, kr, idx, 0.1)
    assert _worst_slot(got, want) <= WGMMA_TOL


@pytest_cuda
def test_mla_layer_decodes_through_the_kernel_on_the_card(card):
    """A bf16 DeepSeek-V3 MLA layer's decode at full width takes the
    kernel (one launch) and matches the code it replaced on the card."""
    cfg = get_config("deepseek_v3_671b")
    H, B, S, dt = cfg.n_heads, 4, 2048, torch.bfloat16
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    g = torch.Generator(device=card).manual_seed(9)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=card) * std).to(dt)
    p = {"wkv_b": randn(cfg.kv_lora_rank, H * (nope + vd), std=0.05)}
    q_nope, q_rope = randn(B, 1, H, nope), randn(B, 1, H, rope)
    ckv, kr = randn(B, 1, cfg.kv_lora_rank), randn(B, 1, rope)
    cache = {"ckv": randn(B, S, cfg.kv_lora_rank), "k_rope": randn(B, S, rope)}
    twin = {k: v.clone() for k, v in cache.items()}
    idx = torch.tensor([0, 700, 1500, S - 1], device=card)
    before = _launches()
    got = attn._absorbed_decode(cfg, p, cache, idx, q_nope, q_rope, ckv, kr,
                                H, 0.1)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    want = _old_absorbed_decode(cfg, p, twin, idx, q_nope, q_rope, ckv, kr,
                                H, 0.1)
    assert all(torch.equal(cache[k], twin[k]) for k in cache)
    assert _worst_slot(got[:, 0], want[:, 0]) <= WGMMA_TOL
