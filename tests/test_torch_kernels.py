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
    for bm, bn, bk in [(128, 128, 16), (64, 128, 32), (128, 64, 8)]:
        out = ops.matmul(ta, tb, block_m=bm, block_n=bn, block_k=bk)
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_block_override_follows_the_path(dtype):
    """A 16-bit block override is checked against the table of the path
    the converted operands take, their alignment included, and the sizes
    not given come from that path's default."""
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
    # K off the 8 TMA needs: simt's table and defaults
    tk, tkb = ta[:, :60].contiguous(), tb[:60].contiguous()
    assert kmm.operand_path(tk, tkb) == "simt"
    assert torch.equal(ops.matmul(tk, tkb, block_k=16), matmul_ref(tk, tkb))
    with pytest.raises(ValueError, match="compiled table of the simt"):
        ops.matmul(tk, tkb, block_n=256)
    # the same shape two bytes off a 16-byte boundary is simt's too
    base = torch.zeros(64 * 64 + 1, dtype=dt)
    off = base[1:].view(64, 64)
    off.copy_(ta)
    assert off.data_ptr() % 16 != 0
    assert kmm.operand_path(off, tb) == "simt"
    assert torch.equal(ops.matmul(off, tb, block_m=64), want)
    with pytest.raises(ValueError, match="compiled table of the simt"):
        ops.matmul(off, tb, block_n=256)


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
        path = kmm._path(isz, k, n)
        bm, bn, bk = ops.default_blocks(m, n, k, isz)
        assert (bm, bn, bk) in kmm.compiled_blocks(path)
        staged = {"simt": 4, "dmma": 8, "wgmma": 2}[path]
        assert ops.smem_bytes(bm, bn, bk, staged, path) <= ops.SMEM_BUDGET
    for bm, bn, bk in kmm.compiled_blocks("simt"):
        assert ops.smem_bytes(bm, bn, bk, 4) <= ops.SMEM_BUDGET
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


@pytest.mark.parametrize("dtype,m,k,n,path", [
    ("bfloat16", 1024, 1024, 1024, "wgmma"),
    ("float16", 1024, 1024, 3072, "wgmma"),
    ("bfloat16", 1, 8, 8, "wgmma"),
    ("float16", 1000, 64, 1000, "wgmma"),      # ragged M/N, aligned strides
    ("bfloat16", 100, 70, 130, "simt"),        # K % 8 != 0
    ("float16", 1000, 997, 1003, "simt"),
    ("bfloat16", 64, 64, 60, "simt"),          # N % 8 != 0
    ("float64", 1024, 1024, 1024, "dmma"),
    ("float64", 1, 7, 5, "dmma"),              # odd K stays on dmma
    ("float64", 1000, 997, 1003, "dmma"),
    ("float32", 1024, 1024, 1024, "simt"),     # no TF32
    ("float32", 8, 8, 8, "simt"),
])
def test_kernel_path_by_dtype_and_alignment(dtype, m, k, n, path):
    """The path is a function of dtype and alignment alone: wgmma for
    f16/bf16 whose rows TMA can read, dmma for every f64 shape, simt for
    f32 and unaligned 16-bit shapes."""
    assert kmm.kernel_path(dtype, m, k, n) == path
    assert kmm.kernel_path(getattr(torch, dtype), m, k, n) == path
    # an operand base off 16 bytes takes the 16-bit shape off TMA
    want = "simt" if path == "wgmma" else path
    assert kmm.kernel_path(dtype, m, k, n, aligned=False) == want


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
    before = kmm.LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        kmm.batched_contract(meta_a, meta_b)
    with pytest.raises(ValueError, match="different devices"):
        kmm.batched_contract(torch.zeros((1, 1, 4, 4)), meta_b)
    out = kmm.batched_contract(torch.ones((1, 2, 4, 3)),
                               torch.ones((1, 2, 3, 5)))
    assert torch.equal(out, torch.full((1, 4, 5), 6.0))
    assert kmm.LAUNCHES == before


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


@pytest.mark.parametrize("module", ["matmul", "flash_attention"])
def test_launch_counts_are_exact_under_eight_threads(module, monkeypatch):
    """The GEMM and flash wrappers count launches from every thread
    that launches (one worker per pooled context in a BlasxServer):
    eight threads bumping at once, with a 1 us switch interval, lose no
    update in the total, by dtype or by path.  Ten rounds: without the
    lock a round loses updates about four times in ten here."""
    import sys
    import threading

    from repro_torch.kernels import flash_attention as kfa
    mod = kmm if module == "matmul" else kfa
    paths = ("simt", "dmma") if module == "matmul" else ("simt", "mma")
    dtypes = (torch.float32, torch.bfloat16)

    def bump(i, k):
        if module == "matmul":
            mod.count_launch(paths[i % 2], dtypes[k % 2], i % 3 == 0)
        else:
            mod.count_launch(paths[i % 2], dtypes[k % 2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(10):
            for name in ("LAUNCHES_BY_DTYPE", "LAUNCHES_BY_PATH"):
                monkeypatch.setattr(mod, name, {})
            monkeypatch.setattr(mod, "LAUNCHES", 0)
            if module == "matmul":
                monkeypatch.setattr(mod, "LAUNCHES_EPILOGUE", 0)
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
            assert mod.LAUNCHES == 16000
            assert mod.LAUNCHES_BY_DTYPE == {"float32": 8000,
                                             "bfloat16": 8000}
            assert mod.LAUNCHES_BY_PATH == {
                p: {"float32": 4000, "bfloat16": 4000} for p in paths}
            if module == "matmul":
                assert mod.LAUNCHES_EPILOGUE == 3 * 2000  # threads 0, 3, 6
    finally:
        sys.setswitchinterval(old)
