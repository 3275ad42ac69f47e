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
from repro_torch.kernels import build
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
    before = build.launches("gemm")
    got = kmm.batched_contract(a, b)
    torch.cuda.synchronize()
    assert build.launches("gemm") == before + 1
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
    assert kmm.kernel_path(dtype) == path
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    a = torch.randn((g, s, m, k), generator=gen, device=card).to(dtype)
    b = torch.randn((g, s, k, n), generator=gen, device=card).to(dtype)
    name = dtype_name(dtype)
    before = build.launches("gemm", path=path, dtype=name)
    got = kmm.batched_contract(a, b)
    torch.cuda.synchronize()
    assert build.launches("gemm", path=path, dtype=name) == before + 1
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
    """The wrapper picks the path and stages what wgmma cannot read in
    place; the C entry still refuses what the path cannot read (rc -2)
    rather than reading past it: another type on dmma, wgmma or simt
    (16-bit is never simt's), 16-bit operands off TMA's 16-byte
    alignment or rows, 16-byte simt copies off their rows or bases, and
    padded rows off wgmma; a copy width simt does not have is rc -1.
    The shared launch call raises on each and counts none."""
    def call(path, a, b, blocks, k=None, n=None, vec=1):
        g, s, m, lda = a.shape
        ldb = b.shape[3]
        k, n = k or lda, n or ldb
        c = torch.empty((g, m, n), device=card, dtype=torch.float32)
        build.launch(kmm._entry(), card, kmm.PATH_CODES[path],
                     build._DTYPE_CODES[a.dtype], 1, a.data_ptr(),
                     b.data_ptr(), None, 0, c.data_ptr(), g, s, m, k, n,
                     lda, ldb, *blocks, kmm.BLOCKS[path][blocks], vec,
                     key=("gemm", path, a.dtype, ()),
                     details=lambda: f"{path} {a.dtype} vec={vec}")

    def refused(rc, *args, **kw):
        with pytest.raises(RuntimeError, match="blasx_batched_gemm launch "
                           f"failed: error {rc} "):
            call(*args, **kw)
        return True
    wg, dm = kmm.compiled_blocks("wgmma")[0], kmm.compiled_blocks("dmma")[0]
    sm = kmm.compiled_blocks("simt")[0]
    f32 = torch.ones((1, 1, 64, 64), device=card)
    bf = f32.bfloat16()
    before = build.snapshot()
    assert refused(-2, "wgmma", f32, f32, wg)
    assert refused(-2, "dmma", bf, bf, dm)
    assert refused(-2, "simt", f32.double(), f32.double(), sm)
    assert refused(-2, "simt", bf, bf, sm)
    assert refused(-2, "simt", f32, f32, sm, k=60)  # padded rows off wgmma
    assert refused(-1, "simt", f32, f32, sm, vec=2)
    f32_62 = torch.ones((1, 1, 64, 62), device=card)
    assert refused(-2, "simt", f32_62, f32[:, :, :62], sm, vec=4)
    f32_off = torch.ones(64 * 64 + 1, device=card)[1:].view(1, 1, 64, 64)
    assert refused(-2, "simt", f32_off, f32, sm, vec=4)
    off = torch.ones(64 * 64 + 1, device=card, dtype=torch.bfloat16)[1:]
    assert refused(-2, "wgmma", off.view(1, 1, 64, 64), bf, wg)
    rows60 = torch.ones((1, 1, 64, 60), device=card, dtype=torch.bfloat16)
    assert refused(-2, "wgmma", rows60, bf[:, :, :60], wg)
    assert build.snapshot() == before
    call("simt", f32_off, f32, sm, vec=1)
    torch.cuda.synchronize()
    assert build.launches("gemm") == sum(
        n for k, n in before.items() if k.kernel == "gemm") + 1


# ------------------------------------------- f32 simt and 16-bit staging
def _normwise(got, want):
    return float(torch.linalg.norm((got - want).double())
                 / torch.linalg.norm(want.double()))


# (G,S,M,K,N) by copy variant: 16-byte (K, N multiples of 4, aligned
# bases) and 4-byte (K % 4, N % 4, or an A base 4 bytes off 16)
SIMT_SHAPES = {"16-byte": [(2, 3, 200, 96, 136), (4, 2, 256, 128, 256)],
               "4-byte": [(2, 3, 65, 33, 129), (1, 2, 100, 64, 130),
                          (3, 1, 70, 30, 44)]}


@pytest.mark.parametrize("variant", list(SIMT_SHAPES))
@pytest.mark.parametrize("blocks", list(kmm.BLOCKS["simt"]), ids=str)
def test_f32_simt_on_every_block_and_copy_variant(card, blocks, variant):
    """The redesigned f32 kernel on each compiled block and both copy
    variants, against the plain version at the f32 limit; every launch
    on simt.  The shifted-base case puts A 4 bytes past a 16-byte
    boundary with K and N multiples of 4."""
    gen = torch.Generator(device=card).manual_seed(sum(blocks))
    cases = []
    for g, s, m, k, n in SIMT_SHAPES[variant]:
        cases.append((torch.randn((g, s, m, k), generator=gen, device=card),
                      torch.randn((g, s, k, n), generator=gen, device=card)))
    if variant == "4-byte":
        g, s, m, k, n = 2, 2, 96, 64, 128
        buf = torch.randn(g * s * m * k + 1, generator=gen, device=card)
        a = buf[1:].view(g, s, m, k)
        assert a.data_ptr() % 16 == 4
        cases.append((a, torch.randn((g, s, k, n), generator=gen,
                                     device=card)))
    for a, b in cases:
        before = build.launches("gemm", path="simt", dtype="float32")
        copies = build.launches("gemm", tag=variant)
        got = kmm.batched_contract(a, b, blocks=blocks)
        torch.cuda.synchronize()
        assert build.launches("gemm", path="simt", dtype="float32") == \
            before + 1
        assert build.launches("gemm", tag=variant) == copies + 1
        assert _normwise(got, batched_contract_ref(a, b)) <= 1e-4


# 16-bit shapes and offsets TMA cannot read in place: K % 8, N % 8, both,
# and an aligned shape whose A base sits 2 bytes off 16
STAGED_SHAPES = [(2, 3, 65, 33, 129), (1, 1, 100, 70, 128),
                 (1, 2, 64, 64, 60), (3, 2, 1000, 997, 1003),
                 (4, 16, 1024, 1020, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_staged_16bit_shapes_take_wgmma(card, dtype):
    """Every 16-bit shape runs on wgmma: operands TMA cannot read in
    place are staged into a zero-padded copy first.  Within 2e-2 of the
    plain version, f32 sums too, and no 16-bit launch on simt."""
    from repro_torch.core.dtypes import dtype_name
    name = dtype_name(dtype)
    gen = torch.Generator(device=card).manual_seed(11)
    cases = []
    for g, s, m, k, n in STAGED_SHAPES:
        cases.append((torch.randn((g, s, m, k), generator=gen,
                                  device=card).to(dtype),
                      torch.randn((g, s, k, n), generator=gen,
                                  device=card).to(dtype)))
    buf = torch.randn(64 * 64 + 1, generator=gen, device=card).to(dtype)
    cases.append((buf[1:].view(1, 1, 64, 64),
                  torch.randn((1, 1, 64, 64), generator=gen,
                              device=card).to(dtype)))
    for a, b in cases:
        assert kmm.operand_path(a, b) == "wgmma"
        assert any(kmm.operand_staging(a, b))
        before = build.launches("gemm", path="wgmma", dtype=name)
        simt = build.launches("gemm", path="simt", dtype=name)
        got = kmm.batched_contract(a, b)
        wide = kmm.batched_contract(a, b, torch.float32)
        torch.cuda.synchronize()
        assert build.launches("gemm", path="wgmma", dtype=name) == before + 2
        assert build.launches("gemm", path="simt", dtype=name) == simt
        assert _normwise(got, batched_contract_ref(a, b)) <= 2e-2
        assert _normwise(wide, batched_contract_ref(a, b, torch.float32)) \
            <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu",
                                        "tanh"])
def test_epilogue_on_staged_16bit_shapes(card, dtype, activation):
    """The bias row and each activation on shapes that are staged (K
    and N off a multiple of 8), against the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    gen = torch.Generator(device=card).manual_seed(5)
    for m, k, n in [(100, 70, 130), (513, 129, 257)]:
        a = torch.randn((m, k), generator=gen, device=card).to(dtype)
        b = torch.randn((k, n), generator=gen, device=card).to(dtype)
        bias = torch.randn((n,), generator=gen, device=card)
        assert kmm.operand_staging(a, b) == (True, True)
        before = build.launches("gemm", tag="epilogue")
        got = ops.matmul(a, b, bias, activation=activation)
        torch.cuda.synchronize()
        assert build.launches("gemm", tag="epilogue") == before + 1
        assert _normwise(got, matmul_ref(a, b, bias, activation)) <= 2e-2


def test_kernels_refuse_inputs_that_require_grad(card):
    """Neither hand kernel has a backward (nor has the reference's), so
    a CUDA call whose inputs require grad raises with grad mode on, and
    runs under ``torch.no_grad()``."""
    from repro_torch.kernels import flash_attention as kfa
    a = torch.randn((1, 1, 64, 32), device=card, requires_grad=True)
    b = torch.randn((1, 1, 32, 48), device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        kmm.batched_contract(a, b)
    with torch.no_grad():
        assert kmm.batched_contract(a, b).shape == (1, 64, 48)
    q = torch.randn((1, 16, 4, 64), device=card, requires_grad=True)
    kv = torch.randn((1, 16, 2, 64), device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        kfa.flash_attention(q, kv, kv)
    with torch.no_grad():
        assert kfa.flash_attention(q, kv, kv).shape == q.shape


def test_train_mode_attention_on_the_card_keeps_grad_fn(card):
    """A train-mode forward of the reduced Qwen3 on the card under the
    default "flash" backend takes the plain chunked path (no flash
    launch) and keeps its gradients; without grad the kernel runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    cfg = get_config("qwen3_0_6b").reduced()
    model = Model(cfg)
    params = model.init(seed=0, device="cuda")

    def trainable(tree):
        if isinstance(tree, dict):
            return {k: trainable(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(True)

    train = trainable(params)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), device=card)
    assert attn.ATTENTION_BACKEND == "flash"
    before = build.launches("flash")
    logits, _ = model.train_logits(train, tokens=tok)
    assert build.launches("flash") == before and logits.grad_fn is not None
    logits.float().square().mean().backward()
    assert train["blocks"]["attn"]["wq"].grad is not None
    with torch.no_grad():
        model.train_logits(train, tokens=tok)
    torch.cuda.synchronize()
    assert build.launches("flash") == before + cfg.n_layers


def test_context_launches_take_the_tensor_core_paths(card):
    """A bf16 and an f64 GEMM through the context on 64-tiles: every
    bf16 launch takes wgmma and every f64 launch dmma."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((256, 192))
    B = rng.standard_normal((192, 320))
    for dtype, path in (("bfloat16", "wgmma"), ("float64", "dmma")):
        build.reset()
        with BlasxContext(RuntimeConfig(n_devices=2), tile=64,
                          dtype=dtype) as ctx:
            out = ctx.gemm(A, B)
            launches = ctx.stats()["launch"]["kernel_launches"]
        assert build.launches("gemm") == launches
        assert build.launches("gemm", path=path, dtype=dtype) == launches
        tol = 1e-12 if dtype == "float64" else 2e-2
        got = torch.as_tensor(out.array()).double().numpy()
        assert np.linalg.norm(got - A @ B) / np.linalg.norm(A @ B) <= tol


def test_context_gemm_launches_match_ledger(card):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((300, 200))
    B = rng.standard_normal((200, 250))
    with BlasxContext(RuntimeConfig(n_devices=2), tile=64) as ctx:
        before = build.launches("gemm")
        out = ctx.gemm(A, B)
        ls = ctx.stats()["launch"]
        assert build.launches("gemm") - before == ls["kernel_launches"]
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
    before = build.launches("gemm", tag="epilogue")
    got = ops.matmul(a, b, bias, activation=activation)
    torch.cuda.synchronize()
    assert build.launches("gemm", tag="epilogue") == before + 1
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
    assert ops.kernel_path(dtype) == "wgmma"
    name = dtype_name(dtype)
    before = build.launches("gemm", path="wgmma", dtype=name)
    got = ops.matmul(a, b, bias, activation=activation)
    torch.cuda.synchronize()
    assert build.launches("gemm", path="wgmma", dtype=name) == before + 1
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
    path = kfa.flash_path(dtype)
    assert path == ("simt" if dtype == torch.float32 else "mma")
    assert not any(kfa.operand_staging(q, k, v))
    name = dtype_name(dtype)
    before = build.launches("flash", path=path, dtype=name)
    got = kfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launches("flash", path=path, dtype=name) == before + 1
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_flash_views_take_the_path_their_strides_allow(card, dtype):
    """flash_attention_bhsd's permuted views read in place on the mma
    path; a seq stride off a multiple of 8 elements is staged onto mma
    (its launch tagged "staged"), never put on simt."""
    from repro_torch.core.dtypes import dtype_name
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    name = dtype_name(dtype)
    gen = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((8, 150, 64), (2, 150, 64), (2, 150, 64)))
    before = build.launches("flash", path="mma", dtype=name)
    got = kfa.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert build.launches("flash", path="mma", dtype=name) == before + 1
    view = lambda x: x.permute(1, 0, 2)[None]
    want = flash_attention_ref(view(q), view(k), view(v))[0].permute(1, 0, 2)
    _flash_close(got, want, dtype)

    b, s, h, hkv, d = 1, 200, 4, 2, 64
    wide = lambda heads: torch.randn((b, s, heads * d + 1), generator=gen,
                                     device=card).to(dtype)[
        ..., :heads * d].unflatten(-1, (heads, d))
    q, k, v = wide(h), wide(hkv), wide(hkv)
    assert kfa.operand_staging(q, k, v) == (True, True, True)
    before = build.launches("flash", path="mma", dtype=name)
    staged = build.launches("flash", dtype=name, tag="staged")
    simt = build.launches("flash", path="simt", dtype=name)
    got = kfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert build.launches("flash", path="mma", dtype=name) == before + 1
    assert build.launches("flash", dtype=name, tag="staged") == staged + 1
    assert build.launches("flash", path="simt", dtype=name) == simt
    _flash_close(got, flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("d", [8, 16, 32, 64, 80, 128])
def test_f32_simt_kernel_on_every_head_dim(card, d):
    """The f32 kernel at every compiled head dim, on every case and
    hazard with its head dim replaced by ``d``, within the reference's
    2e-5 max abs of the plain version; every launch on simt, none
    staged."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    assert d in kfa.HEAD_DIMS
    for case in FLASH_CASES + FLASH_HAZARDS:
        case = (*case[:5], d, case[6])
        q, k, v = _flash_operands(card, torch.float32, case)
        before = build.launches("flash", path="simt", dtype="float32")
        staged = build.launches("flash", dtype="float32", tag="staged")
        got = kfa.flash_attention(q, k, v, causal=case[6])
        torch.cuda.synchronize()
        assert build.launches("flash", path="simt", dtype="float32") == \
            before + 1, case
        assert build.launches("flash", dtype="float32", tag="staged") == \
            staged, case
        want = flash_attention_ref(q, k, v, causal=case[6])
        err = float((got - want).abs().max())
        assert err <= FLASH_TOL[torch.float32], (case, err)


# Zamba2-2.7B's prefill attention (D 80) and SeamlessM4T's encoder
# (non-causal D 64), then D 80's hazards
FAMILY_FLASH = [(1, 1024, 1024, 32, 32, 80, True),
                (1, 1024, 1024, 16, 16, 64, False),
                (2, 130, 130, 4, 2, 80, True), (1, 100, 65, 4, 2, 80, False),
                (1, 1, 200, 4, 2, 80, False), (1, 300, 170, 4, 2, 80, True)]


@pytest.mark.parametrize("dtype", list(FLASH_TOL), ids=str)
@pytest.mark.parametrize("case", FAMILY_FLASH, ids=str)
def test_flash_kernel_at_head_dim_80_and_full_attention(card, dtype, case):
    """The kernel at head dim 80 (both paths) and non-causal D 64 against
    its plain version, each launch counted under its shape key."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    causal, d = case[6], case[5]
    q, k, v = _flash_operands(card, dtype, case)
    key = kfa.shape_key(d, causal)
    before = build.launches("flash", tag=key)
    got = kfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launches("flash", tag=key) == before + 1
    _flash_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v3_671b",
                                  "mamba2_780m", "zamba2_2_7b",
                                  "seamless_m4t_medium"])
def test_reduced_family_on_the_card_matches_the_cpu_port(card, arch,
                                                         monkeypatch):
    """One reduced model of each family on the card (f32: the flash
    kernel's simt path at prefill) against the same weights on the CPU
    (the kernel's plain version): train and prefill logits and two decode
    steps within 2e-4, and the prefill's flash launches by shape."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    cpu = model.init(0, device="cpu")

    def on(tree, dev):
        return {k: on(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    gpu = on(cpu, card)
    rng = np.random.default_rng(0)
    B, S = 2, 12
    kw = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    kw_p = dict(kw, tokens=kw["tokens"][:, :10])
    close = lambda a, b: np.testing.assert_allclose(
        a.cpu().numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    monkeypatch.setattr(build, "LAUNCHES", {})
    with torch.no_grad():
        close(model.train_logits(gpu, **on(kw, card))[0],
              model.train_logits(cpu, **kw)[0])
        build.reset()
        lg, cg = model.prefill(gpu, **on(kw_p, card))
        torch.cuda.synchronize()
        flash = build.launches("flash")
        shapes = {t: build.launches("flash", tag=t) for t in (
            f"d{cfg.resolved_head_dim},causal",
            f"d{cfg.resolved_head_dim},full")}
        lc, cc = model.prefill(cpu, **kw_p)
        close(lg, lc)
        cg, cc = model.pad_cache(cg, S), model.pad_cache(cc, S)
        for t in (10, 11):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, cg = model.decode(gpu, cg, kw["tokens"][:, t].to(card),
                                  pos.to(card))
            lc, cc = model.decode(cpu, cc, kw["tokens"][:, t], pos)
            close(lg, lc)
    hd = cfg.resolved_head_dim
    want = {"olmoe_1b_7b": {f"d{hd},causal": 2}, "deepseek_v3_671b": {},
            "mamba2_780m": {}, "zamba2_2_7b": {f"d{hd},causal": 2},
            "seamless_m4t_medium": {f"d{hd},full": 2, f"d{hd},causal": 2}}
    # every launch carries one shape tag: none of another shape
    assert {t: n for t, n in shapes.items() if n} == want[arch]
    assert flash == sum(want[arch].values())


@pytest.mark.parametrize("case", [(1, 1024, 1024, 16, 8, 128, True),
                                  (2, 200, 300, 4, 2, 64, True),
                                  (1, 65, 65, 2, 1, 8, True),
                                  (3, 1, 40, 2, 2, 32, True)], ids=str)
def test_f32_simt_split_and_whole_tiles_agree(card, case):
    """The f32 kernel with whole q-tiles and with each tile's keys split
    over two blocks (the second to finish combining them; a tile of one
    k-block has an empty first half), both through the C entry on the
    same inputs, each within 2e-5 of the plain version; the finish
    counts are back at 0 after each launch, so a second launch on the
    same workspace agrees too."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    b, sq, sk, h, hkv, d, causal = case
    q, k, v = _flash_operands(card, torch.float32, case)
    want = flash_attention_ref(q, k, v, causal=causal)
    bq = kfa.BLOCKS["simt"][0]
    tiles = b * h * -(-sq // bq)
    ws = torch.empty(2 * tiles * bq * (d + 2), device=card)
    counts = torch.zeros(tiles, device=card, dtype=torch.int32)
    st = [x.stride(i) if x.shape[i] > 1 else 0
          for x in (q, k, v, q) for i in range(3)]
    for split in (False, True, True):
        o = torch.full_like(q, float("nan"))
        ptrs = (ws.data_ptr(), counts.data_ptr()) if split else (None, None)
        build.launch(kfa._entry(), card, kfa.PATH_CODES["simt"], 1, d,
                     *kfa.BLOCKS["simt"], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), *ptrs, b, h, hkv, sq, sk,
                     d ** -0.5, int(causal), *st,
                     key=("flash", "simt", torch.float32,
                          (kfa.shape_key(d, causal),)),
                     details=lambda: f"split={split}")
        torch.cuda.synchronize()
        err = float((o - want).abs().max())
        assert err <= FLASH_TOL[torch.float32], (split, err)
        assert int(counts.abs().sum()) == 0


def _off_copies(card, dtype, shape, pad=0, offset=0):
    """A (B, S, H, D) view of ``dtype`` whose seq stride is H*D + pad and
    whose base sits ``offset`` elements into its allocation."""
    b, s, h, d = shape
    flat = torch.zeros(b * s * (h * d + pad) + offset, dtype=dtype,
                       device=card)[offset:]
    return flat.view(b, s, h * d + pad)[..., :h * d].unflatten(-1, (h, d))


@pytest.mark.parametrize("dtype", list(FLASH_TOL), ids=str)
def test_staged_routes_on_the_card(card, dtype):
    """Operands the 16-byte copies cannot read in place (a seq stride off
    the chunk, a base off 16 bytes), output included, are staged onto
    the dtype's path: f32 on simt, 16-bit on mma, each launch counted in
    the ledger with the "staged" tag; the result lands in the caller's
    output view, whose padding stays untouched."""
    from repro_torch.core.dtypes import dtype_name
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    name = dtype_name(dtype)
    path = kfa.flash_path(dtype)
    gen = torch.Generator(device=card).manual_seed(21)
    for b, s, sk, h, hkv, d, causal in [(1, 200, 200, 4, 2, 64, True),
                                        (2, 130, 97, 4, 1, 128, False),
                                        (1, 65, 65, 2, 2, 8, True)]:
        q = _off_copies(card, dtype, (b, s, h, d), pad=1)
        k = _off_copies(card, dtype, (b, sk, hkv, d), offset=1)
        v = _off_copies(card, dtype, (b, sk, hkv, d), pad=3, offset=1)
        out = _off_copies(card, dtype, (b, s, h, d), pad=5, offset=3)
        for x in (q, k, v):
            x.copy_(torch.randn(x.shape, generator=gen, device=card))
        out.as_strided((b, s, 5), out.stride()[:2] + (1,),
                       out.storage_offset() + h * d).fill_(7.0)
        assert kfa.operand_staging(q, k, v, out) == (True,) * 4
        before = build.launches("flash", path=path, dtype=name)
        staged = build.launches("flash", dtype=name, tag="staged")
        assert kfa._attend(q, k, v, out, causal, None) is out
        got = kfa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert build.launches("flash", path=path, dtype=name) == before + 2
        assert build.launches("flash", dtype=name, tag="staged") == \
            staged + 2
        want = flash_attention_ref(q, k, v, causal=causal)
        _flash_close(out, want, dtype)
        _flash_close(got, want, dtype)
        pad = out.as_strided((b, s, 5), out.stride()[:2] + (1,),
                             out.storage_offset() + h * d)
        assert bool((pad == 7.0).all())
    assert build.launches("flash", path="simt") == build.launches(
        "flash", path="simt", dtype="float32")


def test_flash_entry_refuses_16_bit_on_simt(card):
    """The C entry compiles simt for f32 alone: 16-bit operands on simt
    are refused (rc -2), as are f32 operands off its 16-byte copies; an
    unknown dtype is rc -1.  The shared launch call raises on each and
    counts only the launch that ran."""
    from repro_torch.kernels import flash_attention as kfa

    def call(q, kv, o, dtype=None):
        b, s, h, d = q.shape
        st = [x.stride(i) for x in (q, kv, kv, o) for i in range(3)]
        build.launch(kfa._entry(), card, kfa.PATH_CODES["simt"],
                     dtype or build._DTYPE_CODES[q.dtype], d,
                     *kfa.BLOCKS["simt"], q.data_ptr(), kv.data_ptr(),
                     kv.data_ptr(), o.data_ptr(), None, None, b, h,
                     kv.shape[2], s, kv.shape[1], 0.125, 1, *st,
                     key=("flash", "simt", q.dtype, ()),
                     details=lambda: f"{q.dtype} on simt")

    def refused(rc, *operands, dtype=None):
        with pytest.raises(RuntimeError, match="flash_attention_fwd launch "
                           f"failed: error {rc} "):
            call(*operands, dtype=dtype)
        return True
    f32 = torch.ones((1, 64, 2, 64), device=card)
    before = build.snapshot()
    ran = build.launches("flash", path="simt", dtype="float32")
    for half in (torch.bfloat16, torch.float16):
        x = f32.to(half)
        assert refused(-2, x, x, torch.empty_like(x))
    off = torch.ones(f32.numel() + 1, device=card)[1:].view(f32.shape)
    assert refused(-2, off, f32, torch.empty_like(f32))
    ragged = _off_copies(card, torch.float32, (1, 64, 2, 64), pad=2)
    assert refused(-2, ragged, f32, torch.empty_like(f32))
    assert refused(-1, f32, f32, torch.empty_like(f32), dtype=7)
    assert build.snapshot() == before
    call(f32, f32, torch.empty_like(f32))
    torch.cuda.synchronize()
    assert build.launches("flash", path="simt", dtype="float32") == ran + 1


def test_flash_entry_refuses_operands_the_path_cannot_read(card):
    """The wrapper picks the path; the C entry still refuses (rc -2) what
    the mma path cannot read: f32, and a 16-bit base off 16 bytes.  The
    shared launch call raises on each and counts none."""
    from repro_torch.kernels import flash_attention as kfa

    def call(q, kv, o):
        b, s, h, d = q.shape
        st = [x.stride(i) for x in (q, kv, kv, o) for i in range(3)]
        build.launch(kfa._entry(), card, kfa.PATH_CODES["mma"],
                     build._DTYPE_CODES[q.dtype], d, *kfa.BLOCKS["mma"],
                     q.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(),
                     None, None, b, h, kv.shape[2], s, kv.shape[1], 0.125, 1,
                     *st, key=("flash", "mma", q.dtype, ()),
                     details=lambda: f"{q.dtype} on mma")

    def refused(*operands):
        with pytest.raises(RuntimeError, match="flash_attention_fwd launch "
                           "failed: error -2 "):
            call(*operands)
        return True
    f32 = torch.ones((1, 64, 2, 64), device=card)
    before = build.snapshot()
    assert refused(f32, f32, torch.empty_like(f32))
    bf = f32.bfloat16()
    off = torch.ones(bf.numel() + 1, device=card,
                     dtype=torch.bfloat16)[1:].view(bf.shape)
    assert refused(off, bf, torch.empty_like(bf))
    assert build.snapshot() == before
    call(bf, bf, torch.empty_like(bf))
    torch.cuda.synchronize()


def test_serve_run_launches_flash_once_per_layer_and_prefill(card):
    from repro_torch.launch.serve import ServeConfig, run
    before = build.launches("flash")
    out = run(ServeConfig(smoke=True, device="cuda", requests=5,
                          batch_slots=2, max_new=4))
    assert out["requests"] == 5 and out["tokens"] == 20
    # 2 layers x 5 prefills
    assert build.launches("flash") - before == 2 * 5


def test_bf16_serve_run_puts_every_flash_launch_on_mma(card, monkeypatch):
    """The smoke config served in bf16 (head dim 8): every flash launch
    is a 16-bit one on the mma path."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.serve import ServeConfig, run
    reduced = ModelConfig.reduced
    monkeypatch.setattr(ModelConfig, "reduced", lambda self:
                        dataclasses.replace(reduced(self), dtype="bfloat16"))
    monkeypatch.setattr(build, "LAUNCHES", {})
    out = run(ServeConfig(smoke=True, device="cuda", requests=5,
                          batch_slots=2, max_new=4))
    assert out["requests"] == 5 and out["tokens"] == 20
    assert out["nonfinite_logits"] == 0
    assert build.launches("flash") == build.launches(
        "flash", path="mma", dtype="bfloat16") == 2 * 5


def test_cblas_padded_leading_dimensions_on_the_card(card):
    """cblas_dgemm/sgemm from col-major flat buffers with ld = m + 13
    into a context on the card: the caller's buffer gets the result,
    its padding stays untouched, f64 takes dmma and f32 simt."""
    from repro_torch.api import CblasColMajor, CblasNoTrans, CblasTrans
    from repro_torch.api import cblas_dgemm, cblas_sgemm
    rng = np.random.default_rng(4)
    m, n, k = 300, 260, 200
    ld = m + 13
    for fn, dt, tol, path in ((cblas_dgemm, np.float64, 1e-12, "dmma"),
                              (cblas_sgemm, np.float32, 1e-5, "simt")):
        A = rng.standard_normal((k, m)).astype(dt)      # op(A) = A^T
        B = rng.standard_normal((k, n)).astype(dt)
        C0 = rng.standard_normal((m, n)).astype(dt)
        store = np.full(n * ld, 7.0, dtype=dt)
        store.reshape(n, ld).T[:m, :] = C0
        before = build.launches("gemm", path=path, dtype=np.dtype(dt).name)
        with BlasxContext(RuntimeConfig(n_devices=2), tile=128) as ctx:
            fn(CblasColMajor, CblasTrans, CblasNoTrans, m, n, k, 0.5,
               np.asfortranarray(A), k, np.asfortranarray(B), k, -1.5,
               store, ld, ctx=ctx)
            launches = ctx.stats()["launch"]["kernel_launches"]
        got = store.reshape(n, ld).T[:m, :].astype(np.float64)
        want = 0.5 * A.T.astype(np.float64) @ B - 1.5 * C0
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= tol
        assert np.all(store.reshape(n, ld)[:, m:] == 7.0)
        assert build.launches("gemm", path=path,
                              dtype=np.dtype(dt).name) == before + launches


def test_two_tenant_server_on_the_card(card):
    """An interactive f32 tenant and a quota'd bf16 flood on a
    two-context pool on one card: every result right, the flood's own
    blocks evicted and the victim's none, bf16 launches on wgmma and
    f32 on simt."""
    from repro_torch.serve import BATCH, INTERACTIVE, BlasxServer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    big = rng.standard_normal((512, 512))
    build.reset()
    with BlasxServer(RuntimeConfig(n_devices=2, cache_bytes=64 << 20),
                     pool_size=2, tile=128,
                     quotas={"flood": 256 << 10}) as srv:
        floods = [srv.submit("flood", "gemm", big, big, dtype="bfloat16",
                             priority=BATCH) for _ in range(4)]
        serves = [srv.submit("app", "gemm", x, w, priority=INTERACTIVE)
                  for _ in range(4)]
        want = x.astype(np.float64) @ w
        for f in serves:
            got = f.result(timeout=120).array().astype(np.float64)
            assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
        ref = big @ big
        for f in floods:
            got = torch.as_tensor(f.result(timeout=120).array()).double()
            err = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
            assert err <= 2e-2
        st = srv.stats()["tenants"]
    assert st["app"]["completed"] == 4 and st["flood"]["completed"] == 4
    assert st["flood"]["quota_evictions"] > 0
    assert st["app"]["quota_evictions"] == 0
    assert {(k.path, k.dtype) for k in build.snapshot()
            if k.kernel == "gemm"} == {("wgmma", "bfloat16"),
                                       ("simt", "float32")}


# ---- work-centric (Stream-K) parity on the card: the fix-ups regroup
# each task's whole k-loop into groups of another size than owner mode
# launches, so bitwise equality holds only if every item of a launch is
# independent of the group's size (the twins of test_workcentric.py's
# parity tests, on the kernel paths)
WC_ROUTINES = ["gemm", "symm", "syrk", "syr2k", "trmm", "trsm"]


def _wc_run(routine, dtype, *, work_centric, time_model="lump",
            mode="sim"):
    from repro_torch.core import blas3

    n, tile = 320, 128   # ragged edge tiles included
    rng = np.random.default_rng(42)  # identical operands per config
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))
    C = rng.standard_normal((n, n))
    cfg = RuntimeConfig(n_devices=3, mode=mode, cache_bytes=32 << 20,
                        backend="cuda", device="cuda",
                        time_model=time_model, work_centric=work_centric)
    kw = dict(tile=tile, config=cfg, dtype=dtype)
    if routine == "gemm":
        return blas3.gemm(A, B, C, beta=0.5, **kw)
    if routine == "symm":
        return blas3.symm(A, B, **kw)
    if routine == "syrk":
        return blas3.syrk(A, C, beta=0.5, uplo="L", **kw)
    if routine == "syr2k":
        return blas3.syr2k(A, B, **kw)
    if routine == "trmm":
        return blas3.trmm(A, B, uplo="L", **kw)
    return blas3.trsm(A + n * np.eye(n), B, **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("routine", WC_ROUTINES)
def test_workcentric_bitwise_parity_on_card(card, routine, dtype):
    before = build.launches("gemm")
    owner = _wc_run(routine, dtype, work_centric=False)
    wc_lump = _wc_run(routine, dtype, work_centric=True)
    wc_events = _wc_run(routine, dtype, work_centric=True,
                        time_model="events")
    if routine in ("gemm", "syrk", "syr2k", "symm"):
        assert build.launches("gemm") > before  # full-fill groups took K4
    assert owner.dtype == wc_lump.dtype == wc_events.dtype
    assert np.isfinite(owner).all()
    assert np.array_equal(owner, wc_lump)
    assert np.array_equal(owner, wc_events)


def test_workcentric_threads_mode_bitwise_parity_on_card(card):
    owner = _wc_run("gemm", np.float64, work_centric=False)
    for _ in range(3):   # racy schedules differ run to run; results can't
        wc = _wc_run("gemm", np.float64, work_centric=True, mode="threads")
        assert np.array_equal(owner, wc)


def test_numpy_backend_refuses_the_card(card):
    """The numpy backend is a host engine: on the card it raises, naming
    the host device, and never copies tiles off the card."""
    from repro_torch.backends import create_backend
    from repro_torch.backends.base import StepGroupKey

    with pytest.raises(ValueError, match='device="cpu"'):
        RuntimeConfig(backend="numpy", device="cuda")
    with pytest.raises(ValueError, match='device="cpu"'):
        BlasxContext(RuntimeConfig(device="cuda"), backend="numpy")
    key = StepGroupKey("gemm", False, False, "full", "full", 4, 4, 4,
                       "float64")
    t = torch.ones((4, 4), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match='device="cpu"'):
        create_backend("numpy").run_group(key, [t], [t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(64, 128, 128), (64, 64, 128),
                                   (128, 128, 64), (128, 64, 128),
                                   (64, 128, 64), (1024, 1024, 1024),
                                   (512, 1024, 1024), (1024, 1024, 512),
                                   (512, 512, 512)])
@pytest.mark.parametrize("steps", [1, 3])
def test_torch_backend_item_independent_of_group_size(card, dtype, shape,
                                                      steps):
    """The library fallback gives an item the same bits in a group of any
    size (the tile shapes of the tile-128 parity twins and of tile 1024):
    cuBLAS's lone-GEMM path (a batch of one) splits small f32 products
    over k, which the backend keeps clear of."""
    from repro_torch.backends.base import StepGroupKey
    from repro_torch.backends.torch_backend import TorchBackend

    m, k, n = shape
    key = StepGroupKey("trmm", False, False, "tri_l", "full", m, k, n,
                       str(dtype).replace("torch.", ""), steps)
    gen = torch.Generator(device=card).manual_seed(1)
    a = [torch.randn((m, k), generator=gen, device=card).to(dtype)
         for _ in range(8 * steps)]
    b = [torch.randn((k, n), generator=gen, device=card).to(dtype)
         for _ in range(8 * steps)]
    be = TorchBackend()
    lone = be.run_group(key, a[:steps], b[:steps]).products[0]
    for g in range(2, 9):
        got = be.run_group(key, a[:g * steps], b[:g * steps]).products[0]
        assert torch.equal(got, lone), f"group of {g}"


# ----------------------------------------- the multi-device slice, training
def test_world_size_one_nccl_mesh(card, tmp_path):
    """An NCCL process group of one rank and its (1, 1) mesh: the ring
    and gspmd GEMMs and tp_matmul on the card against an f64 oracle (the
    reference's limits), and the ring makes no hop on one card."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import (init_process_group,
                                         make_mesh_for_devices)
    init_process_group("cuda", init_method=f"file://{tmp_path}/store",
                       rank=0, world_size=1)
    try:
        mesh = make_mesh_for_devices(1, 1, device="cuda")
        assert mesh.device_type == "cuda"
        gen = torch.Generator(device=card).manual_seed(0)
        a = torch.randn((61, 99), generator=gen, device=card)
        b = torch.randn((99, 96), generator=gen, device=card)
        want = a.double() @ b.double()
        for mode in ("ring", "gspmd"):
            D.reset_collectives()
            c = D.distributed_gemm(a, b, mesh, mode=mode)
            assert c.shape == (61, 96) and c.device.type == "cuda"
            assert float((c.double() - want).abs().max()) < 1e-3
            assert D.COLLECTIVES["p2p"] == 0
        x = torch.randn((2, 30, 128), generator=gen, device=card)
        w1 = torch.randn((128, 256), generator=gen, device=card)
        w2 = torch.randn((256, 128), generator=gen, device=card)
        want = (x.double() @ w1.double()) @ w2.double()
        for mode in ("ring", "gspmd"):
            y = D.tp_matmul(x, w1, mesh, kind="column", mode=mode)
            z = D.tp_matmul(y, w2, mesh, kind="row", mode=mode)
            assert float((z.double() - want).abs().max()) < 5e-3
    finally:
        dist.destroy_process_group()


def test_train_step_on_the_card_matches_the_cpu(card):
    """One train step of reduced Qwen3 (f32) on the card against the same
    step on the CPU from the same parameters and batch: the loss and
    gradient norm within 1e-5 / 1e-4 relative, the parameters within
    1e-5 (the first step's lr is 3e-6, so even a gradient whose sign the
    two sums disagree on moves its weight by at most 6e-6)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import NO_MESH
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten, tree_map
    cfg = get_config("qwen3_0_6b").reduced()
    step, model = make_train_step(cfg, NO_MESH)
    params = model.init(0, device="cpu")
    batch = batch_at_step(DataConfig(cfg.vocab_size, 32, 4, seed=1), 0)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        out[dev] = step(p, adamw.init_state(p), b)
    (pc, _, mc), (pg, _, mg) = out["cpu"], out["cuda"]
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-4)
    for a, b in zip(tree_flatten(pc)[1], tree_flatten(pg)[1]):
        assert float((a - b.cpu()).abs().max()) <= 1e-5
