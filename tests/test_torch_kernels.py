"""The port's matmul kernel wrappers against the reference's Pallas ones.

On the CPU the wrappers take their plain PyTorch versions, so these
tests hold the port's arithmetic, shapes, dtype rules and errors
against the reference's ``kernels/ops.py::matmul`` and
``backends/pallas_backend.py::_batched_pallas_contract``, run the way
the reference's own tests run them (Pallas in interpret mode).  The
same numpy inputs go to both.  The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends.pallas_backend import _batched_pallas_contract
from repro.kernels import ops as ref_ops
from repro_torch.kernels import build, ops
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels.ref import batched_contract_ref, matmul_ref
from torch_launch import cpu_launch, fake_entry  # noqa: F401

# one intra-op thread: the suite runs several worker processes at
# once, and this process's idle OpenMP threads would otherwise spin
# on cores the other workers' timing-sensitive threads-mode tests need
torch.set_num_threads(1)

# test_kernels.py's shapes and tolerances
SHAPES = [
    (8, 8, 8),            # tiny
    (128, 128, 128),      # exactly one block
    (256, 512, 384),      # multi-block, aligned
    (100, 70, 130),       # ragged everything
    (1, 200, 300),        # degenerate M
    (513, 129, 257),      # off-by-one over alignment
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np_pair(m, k, n, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, k)).astype(np.float32),
            r.standard_normal((k, n)).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_reference_pallas(m, k, n, dtype):
    a, b = _np_pair(m, k, n)
    want = np.asarray(ref_ops.matmul(_jax(a, dtype), _jax(b, dtype),
                                     interpret=True), np.float32)
    got = ops.matmul(_torch(a, dtype), _torch(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("g,s,m,k,n", [(2, 3, 32, 16, 24),
                                       (3, 2, 17, 9, 33)])
def test_batched_contract_matches_reference_pallas_backend(g, s, m, k, n):
    """G>1, S>1: the reference folds each item's k-chain into one long-K
    matmul and vmaps the Pallas kernel over the group."""
    r = np.random.default_rng(g * 100 + s)
    a = r.standard_normal((g, s, m, k)).astype(np.float32)
    b = r.standard_normal((g, s, k, n)).astype(np.float32)
    fn = _batched_pallas_contract(s, m, k, n, "float32", True)
    want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    got = kmm.batched_contract(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (g, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_batched_contract_float64_is_true_float64():
    """The reference's f64 through Pallas is f32 arithmetic; the port
    accumulates f64 in f64, so it meets a float64 oracle at 1e-12."""
    r = np.random.default_rng(5)
    a = r.standard_normal((2, 4, 33, 65))
    b = r.standard_normal((2, 4, 65, 17))
    got = kmm.batched_contract(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64
    want = np.einsum("gsmk,gskn->gmn", a, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_out_dtype_and_promotion(dtype):
    a, b = _np_pair(64, 64, 64, seed=6)
    out = ops.matmul(_torch(a, dtype), _torch(b, dtype),
                     out_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    # a half-precision product asked for f32 keeps the f32 sums
    if dtype != "float32":
        ta, tb = _torch(a, dtype), _torch(b, dtype)
        wide = ops.matmul(ta, tb, out_dtype=torch.float32)
        assert wide.dtype == torch.float32
        np.testing.assert_allclose(
            wide.numpy(), (ta.float() @ tb.float()).numpy(), rtol=1e-5,
            atol=1e-4)
    # mixed inputs promote like the reference (f32 x f64 -> f64)
    mixed = ops.matmul(torch.from_numpy(a), torch.from_numpy(b).double())
    assert mixed.dtype == torch.float64


ACTS = [None, "relu", "gelu", "silu", "tanh"]


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_fused_epilogue(activation, use_bias, dtype):
    """Twin of test_kernels.py::test_matmul_fused_epilogue: the bias row
    (f32, as there) is added to the sums and the activation applied
    before the cast, in f32 at 1e-4 and bf16 at 2e-2."""
    a, b = _np_pair(96, 64, 160, seed=3)
    bias = (np.random.default_rng(4).standard_normal(160).astype(np.float32)
            if use_bias else None)
    want = np.asarray(ref_ops.matmul(
        _jax(a, dtype), _jax(b, dtype),
        None if bias is None else jnp.asarray(bias),
        activation=activation, interpret=True), np.float32)
    got = ops.matmul(_torch(a, dtype), _torch(b, dtype),
                     None if bias is None else torch.from_numpy(bias),
                     activation=activation)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=TOL[dtype], atol=TOL[dtype])
    plain = matmul_ref(_torch(a, dtype), _torch(b, dtype),
                       None if bias is None else torch.from_numpy(bias),
                       activation)
    assert torch.equal(got, plain)


def test_matmul_epilogue_errors():
    """The reference's ValueError for a bias of another length than N;
    an unknown activation raises ValueError too (the reference's table
    lookup raises KeyError)."""
    a, b = _np_pair(32, 16, 32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError):
        ref_ops.matmul(jnp.asarray(a), jnp.asarray(b), bias=jnp.zeros((7,)),
                       interpret=True)
    with pytest.raises(ValueError, match="bias length 7 != N 32"):
        ops.matmul(ta, tb, torch.zeros(7))
    with pytest.raises(KeyError):
        ref_ops.matmul(jnp.asarray(a), jnp.asarray(b), activation="swish",
                       interpret=True)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.matmul(ta, tb, activation="swish")
    # the epilogue belongs to a plain matmul, not to a batched group
    with pytest.raises(ValueError, match="G = S = 1"):
        kmm.batched_contract(torch.zeros((2, 1, 4, 5)),
                             torch.zeros((2, 1, 5, 6)), activation="relu")


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's F.gelu
    defaults to the exact erf form, so the table must ask for tanh."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    from repro_torch.kernels.ref import ACTIVATIONS
    got = ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    assert set(kmm.ACTIVATION_CODES) == set(ACTIVATIONS)


def test_matmul_explicit_blocks():
    a, b = _np_pair(256, 256, 256, seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for bm, bn, bk in kmm.compiled_blocks("simt"):  # the f32 table
        out = ops.matmul(ta, tb, block_m=bm, block_n=bn, block_k=bk)
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_block_override_follows_the_path(dtype):
    """A 16-bit block override is checked against the wgmma table, the
    path of every 16-bit shape and alignment (those TMA cannot read in
    place are staged), and the sizes not given come from its default."""
    dt = getattr(torch, dtype)
    a, b = _np_pair(64, 64, 128, seed=6)
    ta, tb = torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)
    want = matmul_ref(ta, tb)
    assert kmm.operand_path(ta, tb) == "wgmma"
    for kw in ({"block_n": 128}, {"block_n": 256}, {"block_m": 128},
               {"block_m": 128, "block_n": 256, "block_k": 64}):
        assert torch.equal(ops.matmul(ta, tb, **kw), want)
    for kw in ({"block_k": 16}, {"block_m": 64}, {"block_n": 64}):
        with pytest.raises(ValueError, match="compiled table of the wgmma"):
            ops.matmul(ta, tb, **kw)
    # K off the 8 TMA needs: still wgmma's table and defaults (A staged)
    tk, tkb = ta[:, :60].contiguous(), tb[:60].contiguous()
    assert kmm.operand_path(tk, tkb) == "wgmma"
    assert kmm.operand_staging(tk, tkb) == (True, False)
    assert torch.equal(ops.matmul(tk, tkb, block_n=256), matmul_ref(tk, tkb))
    with pytest.raises(ValueError, match="compiled table of the wgmma"):
        ops.matmul(tk, tkb, block_k=16)
    # the same shape two bytes off a 16-byte boundary is wgmma's too
    base = torch.zeros(64 * 64 + 1, dtype=dt)
    off = base[1:].view(64, 64)
    off.copy_(ta)
    assert off.data_ptr() % 16 != 0
    assert kmm.operand_path(off, tb) == "wgmma"
    assert kmm.operand_staging(off, tb) == (True, False)
    assert torch.equal(ops.matmul(off, tb, block_m=128), want)
    with pytest.raises(ValueError, match="compiled table of the wgmma"):
        ops.matmul(off, tb, block_m=64)


def test_matmul_shape_errors():
    a, b = _np_pair(32, 16, 32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="inner dims"):
        ops.matmul(ta, torch.zeros((17, 32)))
    with pytest.raises(ValueError, match="2-D"):
        ops.matmul(ta[None], tb)
    with pytest.raises(ValueError, match="compiled table"):
        ops.matmul(ta, tb, block_m=96)
    with pytest.raises(ValueError, match="no common precision"):
        ops.matmul(ta.bfloat16(), tb.half())


def test_batched_contract_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((2, 3, 4, 5))
    b = torch.zeros((2, 3, 5, 6))
    with pytest.raises(ValueError, match="shape mismatch"):
        kmm.batched_contract(a, torch.zeros((2, 2, 5, 6)))
    with pytest.raises(ValueError, match="dtypes differ"):
        kmm.batched_contract(a, b.double())
    with pytest.raises(ValueError, match="unsupported dtype"):
        kmm.batched_contract(a.int(), b.int())
    with pytest.raises(ValueError, match="contiguous"):
        kmm.batched_contract(a.transpose(2, 3).contiguous().transpose(2, 3),
                             b)
    with pytest.raises(ValueError, match="expected a"):
        kmm.batched_contract(a[0], b[0])


def test_block_heuristic_respects_smem():
    """Twin of test_block_heuristic_respects_vmem: every block the
    chooser picks — and every block compiled into the library, on every
    path, the TMA ring's stages and barriers included — fits the shared
    memory one block may use on the card."""
    assert ops.SMEM_BUDGET == 232448  # 227 KB
    for m, n, k, isz in [(8192, 8192, 8192, 2), (4096, 11008, 4096, 4),
                         (33, 100000, 7, 4), (1024, 1024, 16384, 8),
                         (1, 1, 1, 8), (1024, 3072, 1024, 2),
                         (100, 130, 70, 2), (1, 8, 8, 2)]:
        path = kmm._path(isz)
        bm, bn, bk = ops.default_blocks(m, n, k, isz)
        assert (bm, bn, bk) in kmm.compiled_blocks(path)
        staged = {"simt": 4, "dmma": 8, "wgmma": 2}[path]
        assert ops.smem_bytes(bm, bn, bk, staged, path) <= ops.SMEM_BUDGET
    for (bm, bn, bk), stages in kmm.BLOCKS["simt"].items():
        # two k-major A slabs skewed by 4, a ring of B slabs, in f32
        need = ops.smem_bytes(bm, bn, bk, 4)
        assert need == (2 * bk * (bm + 4) + stages * bk * bn) * 4
        assert need <= ops.SMEM_BUDGET
    for bm, bn, bk in kmm.compiled_blocks("dmma"):
        assert ops.smem_bytes(bm, bn, bk, 8, "dmma") <= ops.SMEM_BUDGET
    for (bm, bn, bk), stages in kmm.BLOCKS["wgmma"].items():
        need = ops.smem_bytes(bm, bn, bk, 2, "wgmma")
        # the ring, a full and an empty mbarrier per stage, 1 KB of
        # alignment slack for the 128-byte swizzle
        assert need == stages * (bm * bk + bk * bn) * 2 + 16 * stages + 1024
        assert need <= ops.SMEM_BUDGET
    # 128 x 128 tiles leave room for two blocks on one SM (228 KB)
    assert 2 * (ops.smem_bytes(128, 128, 64, 2, "wgmma") + 1024) <= 233472


def test_simt_table_is_f32_with_a_ring_that_fits_two_blocks():
    """The simt path is f32 only: its table holds each block's B-ring
    stages, every block fits the budget with room for a second block on
    the SM (``__launch_bounds__(256, 2)``), 256 threads own 16 x 16
    positions of 4 x 4 sub-tiles, and the default picks from the table:
    128 x 128 x 16, 64 rows or columns where the output is that narrow."""
    assert kmm.kernel_path("float32") == "simt"
    for name in ("float64", "bfloat16", "float16"):
        assert kmm.kernel_path(name) != "simt"
    for (bm, bn, bk), stages in kmm.BLOCKS["simt"].items():
        assert stages >= 3
        need = ops.smem_bytes(bm, bn, bk, 4, "simt")
        assert 2 * (need + 1024) <= 233472  # 228 KB, 1 KB kept a block
        assert (bm // 16) % 4 == 0 and (bn // 16) % 4 == 0
        assert bm * bk % (256 * 4) == 0  # whole 16-byte A loads a thread
    for m, n, k, want in [(1024, 1024, 1024, (128, 128, 16)),
                          (64, 1024, 4096, (64, 128, 16)),
                          (1024, 33, 7, (128, 64, 16)),
                          (1, 1, 1, (64, 64, 16))]:
        assert ops.default_blocks(m, n, k, 4) == want
        assert want in kmm.compiled_blocks("simt")


@pytest.mark.parametrize("g,s,m,k,n", [(2, 3, 5, 7, 13), (1, 1, 4, 8, 8),
                                       (3, 2, 9, 33, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_staging_copy_pads_with_zeros_and_keeps_the_product(g, s, m, k, n,
                                                            dtype):
    """:func:`kmm.stage` makes one zero-padded copy whose rows are a
    multiple of 8 elements on a 16-byte aligned base; the plain version
    on the staged operands (their logical columns, or B padded with zero
    rows to A's padded K) equals the unstaged one."""
    dt = getattr(torch, dtype)
    r = np.random.default_rng(g * 100 + k)
    a = torch.from_numpy(r.standard_normal((g, s, m, k))).to(dt)
    b = torch.from_numpy(r.standard_normal((g, s, k, n))).to(dt)
    want = batched_contract_ref(a, b)
    ops_ = kmm.stage_operands(a, b)
    assert (ops_.k, ops_.n) == (k, n)
    assert ops_.staged == (k % 8 != 0 or n % 8 != 0)
    for x, st, width in ((a, ops_.a, k), (b, ops_.b, n)):
        staged = width % 8 != 0
        assert (st is not x) == staged
        assert st.shape[-1] == -(-width // 8) * 8
        assert st.data_ptr() % 16 == 0 and st.is_contiguous()
        assert torch.equal(st[..., :width], x)
        assert not st[..., width:].any()  # zeros in the pad
    got = batched_contract_ref(ops_.a[..., :k].contiguous(),
                               ops_.b[..., :n].contiguous())
    assert torch.equal(got, want)
    # the pad columns of A meet zero rows of B: the sums are exact
    kp = ops_.a.shape[-1]
    b_rows = torch.zeros((g, s, kp, n), dtype=dt)
    b_rows[:, :, :k] = b
    got = batched_contract_ref(ops_.a, b_rows)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=1e-2)
    # f32 and f64 are never staged, whatever their rows and bases
    for wide in (torch.float32, torch.float64):
        assert kmm.operand_staging(_shifted((g, s, m, k), wide),
                                   _shifted((g, s, k, n), wide)) == (
            False, False)


@pytest.mark.parametrize("dtype,m,k,n,path", [
    ("bfloat16", 1024, 1024, 1024, "wgmma"),
    ("float16", 1024, 1024, 3072, "wgmma"),
    ("bfloat16", 1, 8, 8, "wgmma"),
    ("float16", 1000, 64, 1000, "wgmma"),      # ragged M/N, aligned strides
    ("bfloat16", 100, 70, 130, "wgmma"),       # K % 8 != 0: A staged
    ("float16", 1000, 997, 1003, "wgmma"),     # both staged
    ("bfloat16", 64, 64, 60, "wgmma"),         # N % 8 != 0: B staged
    ("float64", 1024, 1024, 1024, "dmma"),
    ("float64", 1, 7, 5, "dmma"),              # odd K stays on dmma
    ("float64", 1000, 997, 1003, "dmma"),
    ("float32", 1024, 1024, 1024, "simt"),     # no TF32
    ("float32", 8, 8, 8, "simt"),
])
def test_kernel_path_by_dtype_and_alignment(dtype, m, k, n, path):
    """The path is a function of dtype alone: wgmma for every f16/bf16
    shape, dmma for every f64 shape, simt for every f32 one.  A 16-bit
    operand whose rows or base TMA cannot read is staged first: A for K
    off a multiple of 8, B for N, either for a base off 16 bytes."""
    dt = getattr(torch, dtype)
    assert kmm.kernel_path(dtype) == path
    assert kmm.kernel_path(dt) == path
    a, b = torch.zeros((m, k), dtype=dt), torch.zeros((k, n), dtype=dt)
    assert kmm.operand_path(a, b) == path
    half = path == "wgmma"
    assert kmm.operand_staging(a, b) == (half and k % 8 != 0,
                                         half and n % 8 != 0)
    assert kmm.operand_staging(_shifted((m, k), dt), b) == (
        half, half and n % 8 != 0)
    assert kmm.operand_staging(a, _shifted((k, n), dt)) == (
        half and k % 8 != 0, half)


@pytest.mark.parametrize("k,n,shift,vec", [
    (1024, 1024, None, 4),   # the runtime's tiles: 16-byte copies
    (96, 136, None, 4),
    (1020, 1024, None, 4),   # K off 8 but a multiple of 4: still 16-byte
    (1020, 1024, "a", 1),    # A 4 bytes past 16: 4-byte copies
    (64, 128, "b", 1),       # B 4 bytes past 16
    (33, 128, None, 1),      # K % 4
    (64, 130, None, 1),      # N % 4
])
def test_simt_copy_variant_follows_rows_and_bases(k, n, shift, vec):
    """The wrapper, not the C entry, picks f32 simt's copy variant: 16-byte
    where K and N are multiples of 4 and both bases 16-byte aligned, else
    4-byte; ``SIMT_COPIES`` names the variant a launch is counted under."""
    a = _shifted((3, k)) if shift == "a" else torch.zeros((3, k))
    b = _shifted((k, n)) if shift == "b" else torch.zeros((k, n))
    assert kmm.simt_vec(a, b) == vec
    assert kmm.SIMT_COPIES[vec] == ("16-byte" if vec == 4 else "4-byte")


def _shifted(shape, dtype=torch.float32):
    """A zero tensor of ``shape`` one element past an allocation's
    (16-byte aligned) base."""
    numel = int(np.prod(shape))
    x = torch.zeros(numel + 1, dtype=dtype)[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    return x


def test_simt_block_sweep_rewrites_only_the_table_and_bounds():
    """``tools/simt_block_sweep.py`` builds a copy of the GEMM source
    whose simt table is the compiled one plus its candidates, tiles
    past 128 x 128 at one block an SM; the rest of the source is the
    library's, and a moved table or bound is an error, not a silent
    sweep of the shipped blocks."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "simt_block_sweep.py"
    spec = importlib.util.spec_from_file_location("simt_block_sweep", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    blocks = sweep.sweep_blocks()
    assert blocks[:len(kmm.BLOCKS["simt"])] == [
        (*b, st) for b, st in kmm.BLOCKS["simt"].items()]
    assert (128, 256, 16, 3) in blocks
    src = (build.CSRC / "blasx_gemm.cu").read_text()
    out = sweep.with_blocks(src, blocks)
    table = re.search(r"#define BLASX_SIMT_BLOCKS\(X\)([^\n]*)\n", out)
    assert re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)",
                      table.group(1)) == [tuple(map(str, b)) for b in blocks]
    assert "BM * BN > 128 * 128 ? 1 : 2" in out
    # everything but the table and the bound is the library's source
    strip = [(r"#define BLASX_SIMT_BLOCKS\(X\)(?:[^\n]*\\\n)*[^\n]*\n", ""),
             (r"__launch_bounds__\(kSimtThreads, [^)]*\)", "")]
    a, b = src, out
    for pat, rep in strip:
        a, b = re.sub(pat, rep, a), re.sub(pat, rep, b)
    assert a == b
    with pytest.raises(ValueError, match="moved"):
        sweep.with_blocks(src.replace("__launch_bounds__(kSimtThreads, 2)",
                                      "__launch_bounds__(256, 2)"), blocks)


def test_blocks_outside_the_paths_table_raise():
    """``blocks=`` is checked against the table of the path the call
    takes, on every device: a simt block on a wgmma shape, a wgmma block
    on an f64 call and an f64 block on an f32 call all raise."""
    bf = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compiled table of the wgmma"):
        kmm.batched_contract(bf, bf, blocks=(128, 128, 16))
    f64 = torch.zeros((1, 1, 64, 64), dtype=torch.float64)
    with pytest.raises(ValueError, match="compiled table of the dmma"):
        kmm.batched_contract(f64, f64, blocks=(128, 128, 64))
    f32 = torch.zeros((1, 1, 64, 64))
    with pytest.raises(ValueError, match="compiled table of the simt"):
        kmm.batched_contract(f32, f32, blocks=(128, 256, 64))
    # a block of the right table is taken (the plain version runs here)
    out = kmm.batched_contract(bf, bf, blocks=(128, 256, 64))
    assert out.shape == (1, 64, 64)
    for path in kmm.PATHS:
        bm, bn, bk = kmm.compiled_blocks(path)[0]
        kmm.check_blocks(bm, bn, bk, path)
    with pytest.raises(ValueError, match="unknown path"):
        kmm.compiled_blocks("tf32")


def test_compiled_tables_match_the_source():
    """The wrapper's block and stage table (``kmm.BLOCKS``) is what
    ``csrc/blasx_gemm.cu`` instantiates, path by path: a block asked of
    the library that it did not compile would fail only on the card."""
    import re
    src = (build.CSRC / "blasx_gemm.cu").read_text()
    for path in kmm.PATHS:
        m = re.search(rf"#define BLASX_{path.upper()}_BLOCKS\(X\)((?:[^\n]*"
                      rf"\\\n)*[^\n]*)", src)
        assert m, path
        cases = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", m.group(1))
        compiled = {tuple(map(int, c[:3])): int(c[3]) for c in cases}
        assert len(compiled) == len(cases)
        assert compiled == kmm.BLOCKS[path], path
        assert re.search(rf"BLASX_{path.upper()}_BLOCKS\(BLASX_CASE\)", src)
    assert re.findall(r"kPath(\w+) = (\d)", src) and {
        name.lower(): int(code)
        for name, code in re.findall(r"kPath(\w+) = (\d)", src)} \
        == kmm.PATH_CODES


def test_wrapper_raises_instead_of_falling_back():
    """The kernel or its plain version is chosen by the tensors' device
    and nothing falls back: a device with no kernel raises, as do
    operands on two devices; the plain version never counts a launch."""
    meta_a = torch.empty((1, 1, 4, 4), device="meta")
    meta_b = torch.empty((1, 1, 4, 4), device="meta")
    before = build.snapshot()
    with pytest.raises(ValueError, match="no kernel"):
        kmm.batched_contract(meta_a, meta_b)
    with pytest.raises(ValueError, match="different devices"):
        kmm.batched_contract(torch.zeros((1, 1, 4, 4)), meta_b)
    out = kmm.batched_contract(torch.ones((1, 2, 4, 3)),
                               torch.ones((1, 2, 3, 5)))
    assert torch.equal(out, torch.full((1, 4, 5), 6.0))
    assert build.snapshot() == before


def test_plain_versions_accumulate_in_the_accumulator_type():
    a = torch.full((1, 1, 1, 4096), 1.0 / 3, dtype=torch.bfloat16)
    b = torch.ones((1, 1, 4096, 1), dtype=torch.bfloat16)
    # bf16 partial sums would stall far below 4096/3; f32 sums do not
    got = batched_contract_ref(a, b, torch.float32)
    assert abs(float(got) - 4096 * float(a[0, 0, 0, 0])) < 1e-2
    m = matmul_ref(a[0, 0], b[0, 0])
    assert m.dtype == torch.bfloat16


def test_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is
    never loaded; the build directory is inside the checkout."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// v1\n")
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    assert build.library_path("k") != first
    assert first.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


# each kernel's two paths and the tag some of its launches carry
LEDGER_KEYS = {"gemm": (("simt", "dmma"), "epilogue"),
               "flash": (("simt", "mma"), "d80,causal"),
               "mla_decode": (("simt", "wgmma"), None)}


@pytest.mark.parametrize("kernel", list(LEDGER_KEYS))
def test_launch_counts_are_exact_under_eight_threads(kernel, cpu_launch):
    """The shared launch call counts launches from every thread that
    launches (one worker per pooled context in a BlasxServer): eight
    threads launching at once, with a 1 us switch interval, lose no
    update by kernel, path, dtype or tag.  Ten rounds: without the lock
    a round loses updates about four times in ten here."""
    import sys
    import threading

    paths, tag = LEDGER_KEYS[kernel]
    dtypes = (torch.float32, torch.bfloat16)
    entry = lambda *args: 0  # noqa: E731  (160000 calls: keep none)

    def bump(i, k):
        tags = (tag,) if tag and i % 3 == 0 else ()
        build.launch(entry, None, i, k,
                     key=(kernel, paths[i % 2], dtypes[k % 2], tags),
                     details=str)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(10):
            build.reset()
            barrier = threading.Barrier(8)

            def worker(i):
                barrier.wait(30)
                for k in range(2000):
                    bump(i, k)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert {k.kernel for k in build.snapshot()} == {kernel}
            assert build.launches(kernel) == 16000
            for name in ("float32", "bfloat16"):
                assert build.launches(kernel, dtype=name) == 8000
                for p in paths:
                    assert build.launches(kernel, path=p, dtype=name) == 4000
            if tag:  # threads 0, 3, 6
                assert build.launches(kernel, tag=tag) == 3 * 2000
    finally:
        sys.setswitchinterval(old)


def test_reset_clears_every_kernel_at_once(cpu_launch):
    """One call clears the launches of all three kernels."""
    for kernel, (paths, tag) in LEDGER_KEYS.items():
        build.launch(fake_entry(kernel), None, key=(
            kernel, paths[0], torch.bfloat16, (tag,) if tag else ()),
            details=str)
    assert {k.kernel for k in build.snapshot()} == set(LEDGER_KEYS)
    build.reset()
    assert build.snapshot() == {}
    assert not any(build.launches(kernel) for kernel in LEDGER_KEYS)


def test_a_refused_launch_raises_naming_the_entry_and_counts_nothing(
        cpu_launch):
    """A nonzero return code raises with the entry's name, the code and
    the call's details; only a launch that returned 0 is counted."""
    key = ("gemm", "simt", torch.float32, ())
    with pytest.raises(RuntimeError, match=re.escape(
            "blasx_batched_gemm launch failed: error -2 (G=1 S=2)")):
        build.launch(fake_entry("blasx_batched_gemm", rc=-2), None, 7,
                     key=key, details=lambda: "G=1 S=2")
    assert build.snapshot() == {}
    entry = fake_entry("blasx_batched_gemm")
    build.launch(entry, None, 7, key=key, details=str)
    assert entry.calls == [(7, 0)]  # the arguments, then the stream
    assert build.snapshot() == {build.Launch("gemm", "simt", "float32"): 1}


@pytest.mark.parametrize("case", [
    # dtype, (M, K, N), A one element off its base, epilogue -> key
    (torch.float32, (8, 16, 8), False, False, ("simt", ("16-byte",))),
    (torch.float32, (8, 16, 8), True, False, ("simt", ("4-byte",))),
    (torch.bfloat16, (8, 12, 8), False, False, ("wgmma", ("staged",))),
    (torch.float64, (8, 16, 8), False, True, ("dmma", ("epilogue",))),
    (torch.float16, (8, 16, 8), False, True, ("wgmma", ("epilogue",)))],
    ids=["f32-16byte", "f32-4byte", "bf16-staged", "f64-epilogue",
         "f16-epilogue"])
def test_gemm_launch_records_its_path_dtype_and_tags(case, cpu_launch,
                                                     monkeypatch):
    """The GEMM wrapper's launch, on CPU operands through a stand-in
    entry: one ledger key naming its path, dtype and tags (simt's copy
    variant, a staged operand, an epilogue), and the path and dtype
    codes the entry is given."""
    dtype, (m, k, n), off, epilogue, (path, tags) = case
    entry = fake_entry("blasx_batched_gemm")
    monkeypatch.setattr(kmm, "_entry", lambda: entry)
    a = torch.ones(m * k + 1, dtype=dtype)[off:m * k + off].view(1, 1, m, k)
    b = torch.ones((1, 1, k, n), dtype=dtype)
    bias = torch.ones(n, dtype=dtype) if epilogue else None
    kmm._launch(kmm.stage_operands(a, b), bias=bias,
                activation="relu" if epilogue else None)
    name = str(dtype).removeprefix("torch.")
    assert build.snapshot() == {build.Launch("gemm", path, name, tags): 1}
    assert entry.calls[0][:2] == (kmm.PATH_CODES[path],
                                  build._DTYPE_CODES[dtype])
