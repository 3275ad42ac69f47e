"""The port's kernel and main path on the card.

Marked ``cuda``: each test needs an NVIDIA card and skips without one
(decided inside the test, never at import).  Run them on the machine
with the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import BlasxContext
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels.ref import batched_contract_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 2e-2,
       torch.float16: 2e-2}


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 65, 33, 129), (1, 1, 1, 7, 5),
                                   (3, 2, 200, 97, 130)])
def test_kernel_matches_plain_version(card, dtype, shape):
    g, s, m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn((g, s, m, k), generator=gen, device=card).to(dtype)
    b = torch.randn((g, s, k, n), generator=gen, device=card).to(dtype)
    before = kmm.LAUNCHES
    got = kmm.batched_contract(a, b)
    torch.cuda.synchronize()
    assert kmm.LAUNCHES == before + 1
    want = batched_contract_ref(a, b)
    err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(
        want.double())
    assert float(err) <= TOL[dtype]


# the tensor-core paths' hazards: the runtime's group shape, one
# 64-tile, ragged M/N with aligned strides across item boundaries, M = 1
# with K = N = 8, and an uneven 200 x 96 x 136
TC_SHAPES = [(4, 16, 1024, 1024, 1024), (1, 1, 64, 64, 64),
             (2, 3, 1000, 64, 1000), (1, 1, 1, 8, 8), (3, 2, 200, 96, 136)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64], ids=str)
@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
def test_tensor_core_paths_match_plain_version(card, dtype, shape):
    from repro_torch.core.dtypes import dtype_name
    g, s, m, k, n = shape
    path = "dmma" if dtype == torch.float64 else "wgmma"
    assert kmm.kernel_path(dtype, m, k, n) == path
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    a = torch.randn((g, s, m, k), generator=gen, device=card).to(dtype)
    b = torch.randn((g, s, k, n), generator=gen, device=card).to(dtype)
    name = dtype_name(dtype)
    before = kmm.LAUNCHES_BY_PATH.get(path, {}).get(name, 0)
    got = kmm.batched_contract(a, b)
    torch.cuda.synchronize()
    assert kmm.LAUNCHES_BY_PATH[path][name] == before + 1
    want = batched_contract_ref(a, b)
    err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(
        want.double())
    assert float(err) <= TOL[dtype]
    for blocks in kmm.compiled_blocks(path):
        other = kmm.batched_contract(a, b, blocks=blocks)
        err = torch.linalg.norm((other - want).double()) / torch.linalg.norm(
            want.double())
        assert float(err) <= TOL[dtype], blocks


def test_entry_refuses_operands_the_path_cannot_read(card):
    """The wrapper picks the path; the C entry still refuses what that
    path cannot read (rc -2) rather than reading past it: another type
    on dmma or wgmma, and 16-bit operands off TMA's 16-byte alignment."""
    def call(path, a, b, blocks):
        g, s, m, k = a.shape
        n = b.shape[3]
        c = torch.empty((g, m, n), device=card, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream
        return kmm._entry()(kmm.PATH_CODES[path], kmm._DTYPE_CODES[a.dtype],
                            1, a.data_ptr(), b.data_ptr(), None, 0,
                            c.data_ptr(), g, s, m, k, n, *blocks,
                            kmm.BLOCKS[path][blocks], stream)
    wg, dm = kmm.compiled_blocks("wgmma")[0], kmm.compiled_blocks("dmma")[0]
    f32 = torch.ones((1, 1, 64, 64), device=card)
    bf = f32.bfloat16()
    assert call("wgmma", f32, f32, wg) == -2
    assert call("dmma", bf, bf, dm) == -2
    assert call("simt", f32.double(), f32.double(), (64, 64, 8)) == -2
    off = torch.ones(64 * 64 + 1, device=card, dtype=torch.bfloat16)[1:]
    assert call("wgmma", off.view(1, 1, 64, 64), bf, wg) == -2
    torch.cuda.synchronize()


def test_context_launches_take_the_tensor_core_paths(card):
    """A bf16 and an f64 GEMM through the context on 64-tiles: every
    bf16 launch takes wgmma and every f64 launch dmma."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((256, 192))
    B = rng.standard_normal((192, 320))
    for dtype, path in (("bfloat16", "wgmma"), ("float64", "dmma")):
        kmm.LAUNCHES_BY_PATH.clear()
        kmm.LAUNCHES_BY_DTYPE.clear()
        with BlasxContext(RuntimeConfig(n_devices=2), tile=64,
                          dtype=dtype) as ctx:
            out = ctx.gemm(A, B)
            launches = ctx.stats()["launch"]["kernel_launches"]
        assert kmm.LAUNCHES_BY_PATH == {path: {dtype: launches}}
        tol = 1e-12 if dtype == "float64" else 2e-2
        got = torch.as_tensor(out.array()).double().numpy()
        assert np.linalg.norm(got - A @ B) / np.linalg.norm(A @ B) <= tol


def test_context_gemm_launches_match_ledger(card):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((300, 200))
    B = rng.standard_normal((200, 250))
    with BlasxContext(RuntimeConfig(n_devices=2), tile=64) as ctx:
        before = kmm.LAUNCHES
        out = ctx.gemm(A, B)
        ls = ctx.stats()["launch"]
        assert kmm.LAUNCHES - before == ls["kernel_launches"]
        assert set(ls["engine_flops"]) <= {"cuda", "torch"}
        np.testing.assert_allclose(out.array(), A @ B, rtol=1e-12,
                                   atol=1e-12)


# ------------------------------------------------ the GEMM's fused epilogue
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu",
                                        "tanh"])
def test_epilogue_matches_plain_version(card, dtype, activation):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.randn((100, 70), generator=gen, device=card).to(dtype)
    b = torch.randn((70, 130), generator=gen, device=card).to(dtype)
    bias = torch.randn((130,), generator=gen, device=card)
    before = kmm.LAUNCHES_EPILOGUE
    got = ops.matmul(a, b, bias, activation=activation)
    torch.cuda.synchronize()
    assert kmm.LAUNCHES_EPILOGUE == before + 1
    want = matmul_ref(a, b, bias, activation)
    err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(
        want.double())
    assert float(err) <= (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu",
                                        "tanh"])
def test_epilogue_on_the_wgmma_path(card, dtype, activation):
    """The MLP projection's shape (1024, 1024, 3072) with a bias row and
    each activation, on the wgmma path, against the plain version."""
    from repro_torch.core.dtypes import dtype_name
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.randn((1024, 1024), generator=gen, device=card).to(dtype)
    b = torch.randn((1024, 3072), generator=gen, device=card).to(dtype)
    bias = torch.randn((3072,), generator=gen, device=card)
    assert ops.kernel_path(dtype, 1024, 1024, 3072) == "wgmma"
    before = kmm.LAUNCHES_BY_PATH.get("wgmma", {}).get(dtype_name(dtype), 0)
    got = ops.matmul(a, b, bias, activation=activation)
    torch.cuda.synchronize()
    assert kmm.LAUNCHES_BY_PATH["wgmma"][dtype_name(dtype)] == before + 1
    want = matmul_ref(a, b, bias, activation)
    err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(
        want.double())
    assert float(err) <= 2e-2


# ------------------------------------------------------- flash attention
FLASH_CASES = [(2, 256, 256, 4, 4, 64, True), (1, 200, 200, 4, 2, 32, True),
               (2, 128, 384, 8, 2, 64, False), (1, 130, 130, 2, 1, 16, True),
               (1, 64, 64, 1, 1, 128, True), (2, 37, 37, 4, 2, 8, True),
               (1, 300, 170, 4, 2, 128, True)]
# the mma path's other hazards (chip_smoke.FLASH_HAZARDS): Sq = 1, one key
# past a block, non-causal Sq != Sk, causal Sq < Sk, D = 8 and 16 across
# blocks
FLASH_HAZARDS = [(1, 1, 1, 4, 2, 128, True), (1, 1, 200, 4, 2, 64, False),
                 (1, 65, 65, 4, 2, 128, True), (1, 100, 65, 4, 2, 32, False),
                 (1, 70, 200, 2, 1, 64, True), (2, 130, 130, 4, 1, 8, True),
                 (1, 300, 170, 4, 2, 16, True)]
# max abs: the reference's tolerances (f16 held to bf16's); 16-bit also
# normwise (chip_smoke.FLASH_NORMWISE_TOL)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2, torch.float16: 5e-2}


def _flash_operands(card, dtype, case):
    b, sq, sk, h, hkv, d, _ = case
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    return (torch.randn((b, sq, h, d), generator=gen, device=card).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=card).to(dtype),
            torch.randn((b, sk, hkv, d), generator=gen, device=card).to(dtype))


def _flash_close(got, want, dtype):
    want = want.float()
    assert float((got.float() - want).abs().max()) <= FLASH_TOL[dtype]
    if dtype != torch.float32:
        # max abs 5e-2 is near a typical |o| at long rows; the normwise
        # limit sits between the sound kernel's reading and a planted
        # fault's (chip_smoke.FLASH_NORMWISE_TOL)
        err = torch.linalg.norm((got.float() - want).double()) / \
            torch.linalg.norm(want.double())
        assert float(err) <= 1e-3


@pytest.mark.parametrize("dtype", list(FLASH_TOL), ids=str)
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_HAZARDS, ids=str)
def test_flash_kernel_matches_plain_version(card, dtype, case):
    """Every case on the path flash_path names: mma for 16-bit, simt for
    f32."""
    from repro_torch.core.dtypes import dtype_name
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    causal = case[-1]
    q, k, v = _flash_operands(card, dtype, case)
    path = kfa.flash_path(dtype, case[5], q, k, v)
    assert path == ("simt" if dtype == torch.float32 else "mma")
    name = dtype_name(dtype)
    before = kfa.LAUNCHES_BY_PATH.get(path, {}).get(name, 0)
    got = kfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kfa.LAUNCHES_BY_PATH[path][name] == before + 1
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_flash_views_take_the_path_their_strides_allow(card, dtype):
    """flash_attention_bhsd's permuted views read in place on the mma
    path; a seq stride off a multiple of 8 elements takes simt."""
    from repro_torch.core.dtypes import dtype_name
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    name = dtype_name(dtype)
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((8, 150, 64), (2, 150, 64), (2, 150, 64)))
    before = dict(kfa.LAUNCHES_BY_PATH.get("mma", {}))
    got = kfa.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert kfa.LAUNCHES_BY_PATH["mma"][name] == before.get(name, 0) + 1
    view = lambda x: x.permute(1, 0, 2)[None]
    want = flash_attention_ref(view(q), view(k), view(v))[0].permute(1, 0, 2)
    _flash_close(got, want, dtype)

    b, s, h, hkv, d = 1, 200, 4, 2, 64
    wide = lambda heads: torch.randn((b, s, heads * d + 1), generator=gen,
                                     device=card).to(dtype)[
        ..., :heads * d].unflatten(-1, (heads, d))
    q, k, v = wide(h), wide(hkv), wide(hkv)
    assert kfa.flash_path(dtype, d, q, k, v) == "simt"
    before = kfa.LAUNCHES_BY_PATH.get("simt", {}).get(name, 0)
    got = kfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kfa.LAUNCHES_BY_PATH["simt"][name] == before + 1
    _flash_close(got, flash_attention_ref(q, k, v), dtype)


def test_flash_entry_refuses_operands_the_path_cannot_read(card):
    """The wrapper picks the path; the C entry still refuses (rc -2) what
    the mma path cannot read: f32, and a 16-bit base off 16 bytes."""
    from repro_torch.kernels import flash_attention as kfa

    def call(q, kv, o):
        b, s, h, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        st = [x.stride(i) for x in (q, kv, kv, o) for i in range(3)]
        return kfa._entry()(kfa.PATH_CODES["mma"], kfa._DTYPE_CODES[q.dtype],
                            d, *kfa.BLOCKS["mma"], q.data_ptr(), kv.data_ptr(),
                            kv.data_ptr(), o.data_ptr(), b, h, kv.shape[2],
                            s, kv.shape[1], 0.125, 1, *st, stream)
    f32 = torch.ones((1, 64, 2, 64), device=card)
    assert call(f32, f32, torch.empty_like(f32)) == -2
    bf = f32.bfloat16()
    off = torch.ones(bf.numel() + 1, device=card,
                     dtype=torch.bfloat16)[1:].view(bf.shape)
    assert call(off, bf, torch.empty_like(bf)) == -2
    assert call(bf, bf, torch.empty_like(bf)) == 0
    torch.cuda.synchronize()


def test_serve_run_launches_flash_once_per_layer_and_prefill(card):
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import ServeConfig, run
    before = kfa.LAUNCHES
    out = run(ServeConfig(smoke=True, device="cuda", requests=5,
                          batch_slots=2, max_new=4))
    assert out["requests"] == 5 and out["tokens"] == 20
    assert kfa.LAUNCHES - before == 2 * 5  # 2 layers x 5 prefills


def test_bf16_serve_run_puts_every_flash_launch_on_mma(card, monkeypatch):
    """The smoke config served in bf16 (head dim 8): every flash launch
    is a 16-bit one on the mma path."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import ServeConfig, run
    reduced = ModelConfig.reduced
    monkeypatch.setattr(ModelConfig, "reduced", lambda self:
                        dataclasses.replace(reduced(self), dtype="bfloat16"))
    monkeypatch.setattr(kfa, "LAUNCHES_BY_PATH", {})
    out = run(ServeConfig(smoke=True, device="cuda", requests=5,
                          batch_slots=2, max_new=4))
    assert out["requests"] == 5 and out["tokens"] == 20
    assert out["nonfinite_logits"] == 0
    assert kfa.LAUNCHES_BY_PATH == {"mma": {"bfloat16": 2 * 5}}
