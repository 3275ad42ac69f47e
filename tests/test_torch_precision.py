"""The port's multi-precision surface against the reference's.

Twins of ``test_precision.py``: dtypes through every API layer (legacy
blas3 / ``BlasxContext`` / ``cblas_s*``), per-dtype byte accounting in
the ALRU/heap/ledger, the half precisions on the device backends, the
backend gating rules, and the regressions of the cache/threads-mode
bugfix sweep.  Reference backends map ``numpy/jax/pallas ->
numpy/torch/cuda`` on ``device="cpu"``.  Where the reference computes on
its numpy backend, the port's numpy backend must give its result
bitwise; elsewhere the reference's tolerances hold.

The reference's ``test_cblas_sgemm_rejects_f64_output_buffer`` has no
twin here: ``test_torch_cblas.py::test_cblas_refusals_match_the_reference``
already holds both of its refusals (``f32-output-for-d``,
``f64-output-for-s``) to the reference's exception and message.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import BlasxContext as RefContext
from repro.core import blas3 as ref_blas3
from repro.core.alru import Alru as RefAlru
from repro.core.heap import BlasxHeap as RefHeap
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.core.tiling import TileKey as RefKey
from repro_torch.api import (BlasxContext, CblasColMajor, CblasNonUnit,
                             CblasNoTrans, CblasRight, CblasRowMajor,
                             CblasUpper, cblas_dgemm, cblas_sgemm,
                             cblas_ssymm, cblas_ssyr2k, cblas_ssyrk,
                             cblas_strmm, cblas_strsm)
from repro_torch.core import blas3
from repro_torch.core.alru import Alru
from repro_torch.core.dtypes import (canonical_dtype, promote_dtypes,
                                     validate_backend_dtype)
from repro_torch.core.heap import BlasxHeap
from repro_torch.core.runtime import (BlasxRuntime, RuntimeConfig,
                                      config_from_reference)
from repro_torch.core.tiling import TileKey

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy too, while this module runs: several
    worker processes share the cores, and the threads-mode runtime calls
    ``np.dot`` from several threads at once, so a BLAS pool per call
    oversubscribes them many times over.  (A BLAS splits a product over
    rows and columns, never over k, so results do not depend on it.)"""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit is an economy, not a requirement
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


F32_TOL = dict(rtol=2e-3, atol=2e-3)
M, N, K, TILE = 48, 40, 56, 16    # ragged edges, same shapes as parity
BACKENDS = {"numpy": "numpy", "jax": "torch", "pallas": "cuda"}


def _ref_cfg(backend="numpy", **kw):
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    return RefConfig(backend=backend, **kw)


def _cfg(backend="numpy", **kw):
    """The port's config for the reference's ``_cfg(backend)``."""
    return config_from_reference(
        dataclasses.asdict(_ref_cfg(backend, **kw)), device="cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _as_f64(x):
    """A result as float64 numpy (bfloat16 results are CPU tensors)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, dtype=np.float64)


# ========================================================= dtype registry
def test_canonical_dtype_spellings():
    assert canonical_dtype("float32") == torch.float32
    assert canonical_dtype(np.float64) == torch.float64
    assert canonical_dtype(np.dtype("float16")) == torch.float16
    assert canonical_dtype("bfloat16") == torch.bfloat16
    assert canonical_dtype(torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="unsupported dtype"):
        canonical_dtype("int32")
    with pytest.raises(ValueError, match="unsupported dtype"):
        canonical_dtype("complex128")


def test_backend_dtype_matrix():
    from repro.core.dtypes import SUPPORTED_DTYPES as REF_SUPPORTED
    from repro_torch.core.dtypes import SUPPORTED_DTYPES
    for be in ("numpy", "torch", "cuda"):
        validate_backend_dtype("float64", be)
        validate_backend_dtype("float32", be)
    for half in ("float16", "bfloat16"):
        validate_backend_dtype(half, "torch")
        validate_backend_dtype(half, "cuda")
        with pytest.raises(ValueError, match="not supported"):
            validate_backend_dtype(half, "numpy")
    # the same matrix as the reference's, backends renamed
    assert {name: sorted(bes) for name, bes in SUPPORTED_DTYPES.items()} == {
        name: sorted(BACKENDS[b] for b in bes)
        for name, bes in REF_SUPPORTED.items()}


def test_promote_dtypes_handles_bfloat16():
    bf = canonical_dtype("bfloat16")
    assert promote_dtypes(bf, bf) == bf
    assert promote_dtypes(np.float32, np.float64) == torch.float64


def test_numpy_backend_routes_integer_operands_through_np_dot():
    """Integers are outside the registry but routines take them: on the
    numpy backend an int x int GEMM runs ``np.dot`` in int64, as the
    reference's numpy engine does, and gives the reference's result
    bitwise, ledgers included (exact while the alpha/beta epilogue,
    float64 in both packages, holds it: below 2**53)."""
    r = np.random.default_rng(4)
    A = r.integers(-2**20, 2**20, (M, K)).astype(np.int64)
    B = r.integers(-2**20, 2**20, (K, N)).astype(np.int64)
    ref_rt, rt = RefRuntime(_ref_cfg()), BlasxRuntime(_cfg())
    want = ref_blas3.gemm(A, B, tile=TILE, runtime=ref_rt)
    got = blas3.gemm(A, B, tile=TILE, runtime=rt)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, A @ B)
    assert rt.stats() == ref_rt.stats()
    with pytest.raises(ValueError, match="unsupported dtype"):
        blas3.gemm(A, B, tile=TILE, config=_cfg(), dtype="int64")


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("routine", ["gemm", "trmm"])
def test_numpy_backend_fills_tiles_row_major_like_the_reference(routine,
                                                                dtype):
    """Column-major operands in one tile: the reference's host fill is
    ``ndarray.copy()`` (row-major), and ``np.dot`` can round another last
    bit on another layout, so the port's fill copies row-major too."""
    for n in (37, 100, 127):
        r = np.random.default_rng(n)
        A = np.asfortranarray(r.standard_normal((n, n)).astype(dtype))
        B = np.asfortranarray(r.standard_normal((n, n)).astype(dtype))
        got = getattr(blas3, routine)(A, B, tile=128,
                                      config=_cfg(n_devices=1))
        want = getattr(ref_blas3, routine)(A, B, tile=128,
                                           config=_ref_cfg(n_devices=1))
        assert np.array_equal(got, want), n


# ============================================= dtype through the surfaces
@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_f32_gemm_matches_f32_oracle_all_backends(backend):
    A, B, C = _rand(1, M, K), _rand(2, K, N), _rand(3, M, N)
    kw = dict(alpha=1.3, beta=-0.7, tile=TILE, dtype=np.float32)
    got = blas3.gemm(A, B, C, config=_cfg(backend), **kw)
    assert got.dtype == np.float32
    want = blas3.ref_gemm(A.astype(np.float32), B.astype(np.float32),
                          C.astype(np.float32), alpha=1.3, beta=-0.7)
    np.testing.assert_allclose(got, want, **F32_TOL)
    ref = ref_blas3.gemm(A, B, C, config=_ref_cfg(backend), **kw)
    if backend == "numpy":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("routine", ["syrk", "syr2k", "symm", "trmm", "trsm"])
def test_f32_dtype_through_legacy_wrappers(routine):
    """The reference's default context runs its numpy backend on one
    device; the port's equivalent is given as ``config=``."""
    A = _rand(4, M, K)
    S = _rand(5, M, M) / M + np.eye(M)            # well-conditioned for trsm
    B = _rand(6, M, N)
    B2 = _rand(7, M, K)
    args = {"syrk": (A,), "syr2k": (A, B2), "symm": (S, B), "trmm": (S, B),
            "trsm": (S, B)}[routine]
    got = getattr(blas3, routine)(*args, tile=TILE, dtype="float32",
                                  config=_cfg(n_devices=1))
    want = getattr(blas3, f"ref_{routine}")(
        *(x.astype(np.float32) for x in args))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    ref = getattr(ref_blas3, routine)(*args, tile=TILE, dtype="float32",
                                      config=_ref_cfg(n_devices=1))
    assert np.array_equal(got, ref)


def test_context_default_dtype_casts_and_propagates():
    A, B = _rand(8, M, K), _rand(9, K, N)
    with BlasxContext(_cfg(), tile=TILE, dtype=np.float32) as ctx:
        Ah = ctx.tile(A)
        assert Ah.dtype == torch.float32
        out = ctx.gemm(Ah, B)                 # raw B cast on coercion
        assert out.dtype == torch.float32
        out64 = ctx.gemm(A, B, dtype=np.float64)
        assert out64.dtype == torch.float64
        got, calls = out.array().copy(), ctx.calls
    np.testing.assert_allclose(
        got, A.astype(np.float32) @ B.astype(np.float32), **F32_TOL)
    with RefContext(_ref_cfg(), tile=TILE, dtype=np.float32) as rctx:
        want = rctx.gemm(rctx.tile(A), B).array().copy()
        rctx.gemm(A, B, dtype=np.float64)
        ref_calls = rctx.calls
    assert np.array_equal(got, want)
    assert [dataclasses.asdict(c) for c in calls] == \
        [dataclasses.asdict(c) for c in ref_calls]


def test_per_call_dtype_override_beats_context_default_on_inputs():
    """Raw-array coercion must not re-tile through the context default:
    a per-call dtype= override moves and computes its inputs at its own
    precision."""
    A, B = _rand(10, 64, 64), _rand(11, 64, 64)
    with BlasxContext(_cfg(n_devices=1), tile=32, dtype=np.float64) as ctx:
        out = ctx.gemm(A, B, dtype=np.float32)
        assert out.dtype == torch.float32
        assert ctx.last_call.h2d_bytes == (A.size + B.size) * 4
    with BlasxContext(_cfg("jax", n_devices=1), tile=32,
                      dtype="bfloat16") as ctx:
        E = np.eye(8) * 1.001
        out = ctx.gemm(E, np.eye(8), tile=8, dtype=np.float64)
        assert out.dtype == torch.float64
        # a bf16 default must not quantize the f64-requested inputs:
        # bf16(1.001) == 1.0 exactly (error 1e-3)
        assert abs(out.array()[0, 0] - 1.001) < 1e-4


def test_side_r_keeps_per_call_dtype_over_context_default():
    n, m = 40, 32
    S = _rand(12, n, n) / n + np.eye(n)
    B = _rand(13, m, n)
    with BlasxContext(_cfg(), tile=16, dtype=np.float64) as ctx:
        out = ctx.symm(S, B, side="R", dtype=np.float32)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(
            out.array(),
            blas3.ref_symm(S.astype(np.float32), B.astype(np.float32),
                           side="R"), **F32_TOL)
        sol = ctx.trsm(S, B, side="R", dtype=np.float32)
        assert sol.dtype == torch.float32
        got = (out.array().copy(), sol.array().copy())
    with RefContext(_ref_cfg(), tile=16, dtype=np.float64) as rctx:
        want = (rctx.symm(S, B, side="R", dtype=np.float32).array(),
                rctx.trsm(S, B, side="R", dtype=np.float32).array())
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_context_rejects_handle_dtype_mismatch():
    with BlasxContext(_cfg(), tile=TILE) as ctx:
        Ah = ctx.tile(_rand(14, 32, 32))      # float64 handle
        with pytest.raises(ValueError, match="re-tile"):
            ctx.gemm(Ah, Ah, dtype=np.float32)


def test_override_tiled_handle_usable_without_repeating_dtype():
    A = _rand(15, 32, 32)
    with BlasxContext(_cfg(n_devices=1), tile=16,
                      dtype=np.float64) as ctx:
        h = ctx.tile(A, dtype=np.float32)     # documented override
        assert h.dtype == torch.float32
        out = ctx.gemm(h, h)                  # must not raise
        assert out.dtype == torch.float64     # output follows the default
        np.testing.assert_allclose(
            out.array(),
            A.astype(np.float32) @ A.astype(np.float32), **F32_TOL)
        assert ctx.tile(h) is h


def test_half_precision_rejected_on_numpy_backend():
    with pytest.raises(ValueError, match="not supported"):
        BlasxContext(_cfg("numpy"), dtype="float16")
    with pytest.raises(ValueError, match="not supported"):
        blas3.gemm(_rand(16, 8, 8), _rand(17, 8, 8), tile=8,
                   dtype="bfloat16", config=_cfg("numpy", n_devices=1))
    with BlasxContext(_cfg("numpy"), tile=8) as ctx:
        with pytest.raises(ValueError, match="not supported"):
            ctx.tile(_rand(18, 8, 8), dtype="float16")


def test_numpy_backend_is_a_host_engine():
    """On the card the numpy backend raises, naming the host device —
    it never copies tiles off the card and carries on; its run_group
    refuses a tile that lives anywhere but the host."""
    with pytest.raises(ValueError, match='device="cpu"'):
        RuntimeConfig(backend="numpy")
    with pytest.raises(ValueError, match='device="cpu"'):
        BlasxContext(RuntimeConfig(device="cpu"), backend="numpy",
                     device="cuda")
    with pytest.raises(ValueError, match='device="cpu"'):
        config_from_reference(dataclasses.asdict(_ref_cfg()))
    from repro_torch.backends import create_backend
    from repro_torch.backends.base import StepGroupKey
    be = create_backend("numpy")
    key = StepGroupKey("gemm", False, False, "full", "full", 2, 2, 2,
                       "float64")
    meta = torch.ones((2, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match='device="cpu"'):
        be.run_group(key, [meta], [meta])


def test_half_precision_input_rejected_even_when_promotion_widens():
    """A bf16 operand mixed with a wider one must not slip past the
    numpy-backend gate (the promoted output is f64)."""
    A16 = torch.from_numpy(_rand(19, 16, 16)).to(torch.bfloat16)
    B64 = _rand(20, 16, 16)
    with BlasxContext(_cfg("numpy"), tile=8) as ctx:
        with pytest.raises(ValueError, match="not supported"):
            ctx.gemm(A16, B64)
        with pytest.raises(ValueError, match="not supported"):
            ctx.trmm(A16, B64)


def test_mixed_half_precisions_get_clear_error():
    A16 = torch.from_numpy(_rand(21, 16, 16)).to(torch.bfloat16)
    B16 = _rand(22, 16, 16).astype(np.float16)
    with pytest.raises(ValueError, match="no common precision"):
        promote_dtypes(torch.bfloat16, np.float16)
    with BlasxContext(_cfg("jax"), tile=8) as ctx:
        with pytest.raises(ValueError, match="no common precision"):
            ctx.gemm(A16, B16)


def test_side_r_rejects_handle_dtype_mismatch_like_side_l():
    n, m = 32, 24
    with BlasxContext(_cfg(), tile=16) as ctx:
        Ah = ctx.tile(_rand(23, n, n))        # float64 handle
        B = _rand(24, m, n)
        with pytest.raises(ValueError, match="re-tile"):
            ctx.symm(Ah, B, side="R", dtype=np.float32)
        with pytest.raises(ValueError, match="re-tile"):
            ctx.trsm(Ah, B, side="R", dtype=np.float32)


def test_c_seed_handle_casts_freely_on_both_sides():
    n, m = 32, 24
    S32 = _rand(25, n, n).astype(np.float32)
    B32 = _rand(26, m, n).astype(np.float32)
    L32 = _rand(27, m, m).astype(np.float32)
    C64 = _rand(28, m, n)
    got, want = [], []
    for pkg_ctx, out in ((BlasxContext(_cfg(), tile=16), got),
                         (RefContext(_ref_cfg(), tile=16), want)):
        with pkg_ctx as ctx:
            Ch = ctx.tile(C64)                # float64 seed handle
            for side, A_ in (("L", L32), ("R", S32)):
                res = ctx.symm(A_, B32, Ch, beta=0.5, side=side,
                               dtype=np.float32)
                assert str(res.dtype).endswith("float32")
                oracle = blas3.ref_symm(A_, B32, C64.astype(np.float32),
                                        beta=0.5, side=side)
                np.testing.assert_allclose(res.array(), oracle, **F32_TOL)
                out.append(res.array().copy())
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_half_precision_c_rejected_on_numpy_backend():
    A = _rand(29, 16, 16).astype(np.float32)
    C16 = torch.from_numpy(_rand(30, 16, 16)).to(torch.bfloat16)
    with BlasxContext(_cfg("numpy"), tile=8) as ctx:
        with pytest.raises(ValueError, match="not supported"):
            ctx.gemm(A, A, C16, beta=1.0)
    with BlasxContext(_cfg("jax"), tile=8) as ctx:
        out = ctx.gemm(A, A, C16, beta=1.0)
        assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_gemm_on_torch_backend(dtype):
    A, B = _rand(31, M, K), _rand(32, K, N)
    got = blas3.gemm(A, B, tile=TILE, dtype=dtype, config=_cfg("jax"))
    assert str(got.dtype).endswith(dtype)
    # f32 accumulation: error is dominated by the input rounding
    np.testing.assert_allclose(_as_f64(got), A @ B, rtol=0.06, atol=0.3)


def test_half_precision_gemm_on_cuda_backend():
    n = 32
    A, B = _rand(33, n, n), _rand(34, n, n)
    got = blas3.gemm(A, B, tile=16, dtype="bfloat16", config=_cfg("pallas"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_as_f64(got), A @ B, rtol=0.06, atol=0.3)


def test_step_groups_key_on_dtype():
    """A mixed-precision session: f32 and f64 calls through one runtime
    never share a dispatch group, and group as the reference's do."""
    A = _rand(35, 64, 64)
    counts = []
    for mod, rt in ((blas3, BlasxRuntime(_cfg("jax", n_devices=1))),
                    (ref_blas3, RefRuntime(_ref_cfg("jax", n_devices=1)))):
        mod.gemm(A, A, tile=32, runtime=rt, dtype=np.float32)
        mod.gemm(A, A, tile=32, runtime=rt, dtype=np.float64)
        counts.append(rt.launch_stats()["groups"])
    assert counts[0] >= 2
    assert counts[0] == counts[1]


# ===================================== precision-aware byte accounting
def test_tile_nbytes_track_storage_dtype():
    """The same workload in f32 moves and caches exactly half the bytes
    of f64 (bf16 a quarter) — the reference's numbers exactly."""
    A = _rand(36, 256, 256)

    def run(ctx_cls, cfg, dtype):
        ctx = ctx_cls(cfg, tile=64)
        try:
            ctx.gemm(A, A, dtype=dtype)
            rec = ctx.last_call
            return rec.h2d_bytes, rec.d2h_bytes, \
                ctx.runtime.devices[0].heap.used
        finally:
            ctx.close()

    got = {dt: run(BlasxContext, _cfg(be, n_devices=1), dt)
           for dt, be in ((np.float64, "numpy"), (np.float32, "numpy"),
                          ("bfloat16", "jax"))}
    h64, w64, u64 = got[np.float64]
    h32, w32, u32 = got[np.float32]
    h16, w16, u16 = got["bfloat16"]
    assert h64 == 2 * h32 and w64 == 2 * w32 and u64 == 2 * u32
    assert h64 == 4 * h16 and w64 == 4 * w16 and u64 == 4 * u16
    assert got[np.float64] == run(RefContext, _ref_cfg(n_devices=1),
                                  np.float64)


def test_shadow_run_models_precision():
    rts = {}
    for dt in ("float64", "float32"):
        rt = BlasxRuntime(_cfg(execute=False))
        blas3.shadow_run("gemm", 2048, tile=256, runtime=rt, dtype=dt)
        ref = RefRuntime(_ref_cfg(execute=False))
        ref_blas3.shadow_run("gemm", 2048, tile=256, runtime=ref, dtype=dt)
        assert rt.total_comm_bytes() == ref.total_comm_bytes()
        assert rt.makespan() == ref.makespan()
        rts[dt] = rt
    assert rts["float64"].total_comm_bytes()["h2d"] == \
        2 * rts["float32"].total_comm_bytes()["h2d"]
    assert rts["float32"].makespan() < rts["float64"].makespan()


# ================================================== cblas single precision
def test_cblas_sgemm_matches_f32_oracle_all_backends():
    m, n, k = 48, 40, 32
    A = _rand(37, m, k).astype(np.float32)
    B = _rand(38, k, n).astype(np.float32)
    C0 = _rand(39, m, n).astype(np.float32)
    want = blas3.ref_gemm(A, B, C0, alpha=1.2, beta=0.8)
    for backend in ("numpy", "jax", "pallas"):
        C = C0.copy()
        with BlasxContext(_cfg(backend), tile=16) as ctx:
            cblas_sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, m, n, k,
                        1.2, A, k, B, n, 0.8, C, n, ctx=ctx,
                        backend=BACKENDS[backend])
        np.testing.assert_allclose(C, want, **F32_TOL)
        if backend == "numpy":
            C_ref = C0.copy()
            with RefContext(_ref_cfg(), tile=16) as rctx:
                from repro.api import cblas_sgemm as ref_sgemm
                ref_sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, m, n,
                          k, 1.2, A, k, B, n, 0.8, C_ref, n, ctx=rctx)
            assert np.array_equal(C, C_ref)


def test_cblas_single_precision_surface_all_six():
    n, k, m = 40, 24, 32
    A = _rand(40, n, k).astype(np.float32)
    B = _rand(41, n, k).astype(np.float32)
    S = (_rand(42, n, n) / n + np.eye(n)).astype(np.float32)
    X = _rand(43, m, n).astype(np.float32)
    with BlasxContext(_cfg(), tile=16) as ctx:
        C = np.zeros((n, n), np.float32)
        cblas_ssyrk(CblasRowMajor, CblasUpper, CblasNoTrans, n, k, 1.0,
                    A, k, 0.0, C, n, ctx=ctx)
        np.testing.assert_allclose(np.triu(C), np.triu(A @ A.T), **F32_TOL)

        C = np.zeros((n, n), np.float32)
        cblas_ssyr2k(CblasRowMajor, CblasUpper, CblasNoTrans, n, k, 0.5,
                     A, k, B, k, 0.0, C, n, ctx=ctx)
        np.testing.assert_allclose(
            np.triu(C), np.triu(0.5 * (A @ B.T + B @ A.T)), **F32_TOL)

        C = np.zeros((m, n), np.float32)
        cblas_ssymm(CblasRowMajor, CblasRight, CblasUpper, m, n, 1.0,
                    S, n, X, n, 0.0, C, n, ctx=ctx)
        want = blas3.ref_symm(S, X, side="R", uplo="U")
        np.testing.assert_allclose(C, want, **F32_TOL)

        Bb = X.copy()
        cblas_strmm(CblasRowMajor, CblasRight, CblasUpper, CblasNoTrans,
                    CblasNonUnit, m, n, 0.9, S, n, Bb, n, ctx=ctx)
        np.testing.assert_allclose(
            Bb, blas3.ref_trmm(S, X, alpha=0.9, side="R"), **F32_TOL)

        Bb = X.copy()
        cblas_strsm(CblasRowMajor, CblasRight, CblasUpper, CblasNoTrans,
                    CblasNonUnit, m, n, 1.1, S, n, Bb, n, ctx=ctx)
        np.testing.assert_allclose(
            Bb, blas3.ref_trsm(S, X, alpha=1.1, side="R"),
            rtol=5e-3, atol=5e-3)

        # every tile the f32 surface cached is 4 bytes/element
        assert all(c.h2d_bytes % 4 == 0 for c in ctx.calls)


# ================================= bugfix: _view padded 2-D leading dims
@pytest.mark.parametrize("dtype,fn", [(np.float64, cblas_dgemm),
                                      (np.float32, cblas_sgemm)])
def test_cblas_padded_ld_row_major_round_trip(dtype, fn):
    """2-D operands that are strided views into padded storage: ld is
    honoured, the padding untouched."""
    m, n, k = 20, 14, 12
    lda, ldb, ldc = k + 5, n + 3, n + 7
    A = _rand(44, m, k).astype(dtype)
    B = _rand(45, k, n).astype(dtype)
    C = _rand(46, m, n).astype(dtype)
    want = blas3.ref_gemm(A, B, C, alpha=1.1, beta=0.4)
    Abuf = np.zeros((m, lda), dtype)
    Abuf[:, :k] = A
    Bbuf = np.zeros((k, ldb), dtype)
    Bbuf[:, :n] = B
    Cbuf = np.zeros((m, ldc), dtype)
    Cbuf[:, :n] = C
    with BlasxContext(_cfg(n_devices=1), tile=TILE) as ctx:
        fn(CblasRowMajor, CblasNoTrans, CblasNoTrans, m, n, k, 1.1,
           Abuf[:, :k], lda, Bbuf[:, :n], ldb, 0.4, Cbuf[:, :n], ldc,
           ctx=ctx)
    np.testing.assert_allclose(Cbuf[:, :n], want,
                               **(F32_TOL if dtype == np.float32
                                  else dict(rtol=1e-10, atol=1e-10)))
    assert not Cbuf[:, n:].any()


@pytest.mark.parametrize("dtype,fn", [(np.float64, cblas_dgemm),
                                      (np.float32, cblas_sgemm)])
def test_cblas_padded_ld_col_major_round_trip(dtype, fn):
    m, n, k = 18, 16, 10
    lda, ldb, ldc = m + 4, k + 2, m + 6
    A = _rand(47, m, k).astype(dtype)
    B = _rand(48, k, n).astype(dtype)
    want = blas3.ref_gemm(A, B)
    Abuf = np.zeros((lda, k), dtype, order="F")
    Abuf[:m, :] = A
    Bbuf = np.zeros((ldb, n), dtype, order="F")
    Bbuf[:k, :] = B
    Cbuf = np.zeros((ldc, n), dtype, order="F")
    with BlasxContext(_cfg(n_devices=1), tile=TILE) as ctx:
        fn(CblasColMajor, CblasNoTrans, CblasNoTrans, m, n, k, 1.0,
           Abuf[:m, :], lda, Bbuf[:k, :], ldb, 0.0, Cbuf[:m, :], ldc,
           ctx=ctx)
    np.testing.assert_allclose(Cbuf[:m, :], want,
                               **(F32_TOL if dtype == np.float32
                                  else dict(rtol=1e-10, atol=1e-10)))
    assert not Cbuf[m:, :].any()


def test_cblas_padded_ld_input_of_other_dtype_is_cast_not_rejected():
    m, n, k = 10, 8, 6
    lda = k + 4
    A = _rand(49, m, k)                       # float64 into cblas_sgemm
    B = _rand(50, k, n).astype(np.float32)
    Abuf = np.zeros((m, lda))
    Abuf[:, :k] = A
    C = np.zeros((m, n), np.float32)
    with BlasxContext(_cfg(n_devices=1), tile=TILE) as ctx:
        cblas_sgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, m, n, k, 1.0,
                    Abuf[:, :k], lda, B, n, 0.0, C, n, ctx=ctx)
    np.testing.assert_allclose(C, A.astype(np.float32) @ B, **F32_TOL)


def test_cblas_single_row_accepts_any_ld():
    k, n = 4, 5
    A = _rand(51, 1, k)
    B = _rand(52, k, n)
    C = np.zeros((1, n))
    with BlasxContext(_cfg(n_devices=1), tile=TILE) as ctx:
        cblas_dgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, 1, n, k,
                    1.0, A, k + 4, B, n, 0.0, C, n + 7, ctx=ctx)
    np.testing.assert_allclose(C, A @ B, rtol=1e-10, atol=1e-10)


def test_cblas_dense_buffer_with_padded_ld_raises():
    m, n, k = 8, 6, 4
    A = np.zeros((m, k))
    B = np.zeros((k, n))
    C = np.zeros((m, n))
    with BlasxContext(_cfg(n_devices=1), tile=TILE) as ctx:
        with pytest.raises(ValueError, match="memory layout"):
            cblas_dgemm(CblasRowMajor, CblasNoTrans, CblasNoTrans, m, n, k,
                        1.0, A, k + 3, B, n, 0.0, C, n, ctx=ctx)
        with pytest.raises(ValueError, match="memory layout"):
            cblas_dgemm(CblasColMajor, CblasNoTrans, CblasNoTrans, m, n, k,
                        1.0, np.asfortranarray(A), m, np.asfortranarray(B),
                        k, 0.0, np.asfortranarray(C), m + 2, ctx=ctx)


# ============================ bugfix: ALRU over-eviction + evict ordering
def test_alru_unattainable_translate_evicts_nothing():
    """A request that can never fit (pinned blocks fence the heap) must
    evict nothing before failing; an attainable one evicts only the LRU
    block — the reference's victims, in its order."""
    heap = BlasxHeap(300)
    a = Alru(0, heap)
    k1, k2, k3 = (TileKey("A", 0, i) for i in range(3))
    assert a.translate(k1, 100)[1] == []
    a.release(k1)
    a.translate(k2, 100)                      # pinned: reader stays 1
    a.translate(k3, 100)
    a.release(k3)
    assert a.translate(TileKey("A", 0, 9), 250) == (None, [])
    assert k1 in a and k2 in a and k3 in a
    a.check_invariants()
    heap.check_invariants()
    blk, evicted = a.translate(TileKey("A", 0, 10), 100)
    assert blk is not None
    assert k2 in a
    assert evicted == [k1]                    # exactly one victim, the LRU
    ref_evicted = []
    ref = RefAlru(0, RefHeap(300))
    ref.on_evict = lambda dev, key: ref_evicted.append(key)
    rk = [RefKey("A", 0, i) for i in range(3)]
    ref.translate(rk[0], 100)
    ref.release(rk[0])
    ref.translate(rk[1], 100)
    ref.translate(rk[2], 100)
    ref.release(rk[2])
    ref.translate(RefKey("A", 0, 9), 250)
    ref.translate(RefKey("A", 0, 10), 100)
    assert [(k.i, k.j) for k in ref_evicted] == [(k.i, k.j) for k in evicted]


def test_alru_evictions_reported_after_heap_free():
    """The reference fires ``on_evict`` only after ``heap.free``; the
    port reports its victims from ``translate`` once they are freed, so
    whoever drops them from the directory sees their bytes free."""
    heap = BlasxHeap(200)
    a = Alru(0, heap)
    keys = [TileKey("A", 0, j) for j in range(2)]
    for k in keys:
        a.translate(k, 100)
        a.release(k)
    blk, evicted = a.translate(TileKey("A", 0, 7), 150)
    assert blk is not None and evicted == keys
    assert heap.used == 150                   # both victims freed, then 150
    ref_heap = RefHeap(200)
    ref = RefAlru(0, ref_heap)
    used_at_evict = []
    ref.on_evict = lambda dev, key: used_at_evict.append(ref_heap.used)
    for j in range(2):
        ref.translate(RefKey("A", 0, j), 100)
        ref.release(RefKey("A", 0, j))
    ref.translate(RefKey("A", 0, 7), 150)
    assert used_at_evict == [100, 0]
    assert ref_heap.used == heap.used


def test_heap_largest_attainable_run():
    for h in (BlasxHeap(100), RefHeap(100)):
        a = h.malloc(30)
        b = h.malloc(30)
        h.malloc(30)
        assert h.largest_free_run() == 10
        assert h.largest_attainable_run({a}) == 30
        assert h.largest_attainable_run({a, b}) == 60
        h.free(b)
        assert h.largest_free_run() == 30
        assert h.largest_attainable_run({a}) == 60


# =========================== bugfix: threads-mode wakeup + crash recovery
def _threads_cfg(n_devices, **kw):
    return _cfg(n_devices=n_devices, mode="threads", **kw)


def test_threads_crash_leaves_no_stranded_tasks():
    """A crashed worker must not strand its RS-resident (incl. stolen)
    tasks: survivors drain every RS back to the global queue and the
    injected error surfaces as raised."""
    A = _rand(53, 256, 256)
    rt = BlasxRuntime(_threads_cfg(2, cache_bytes=32 << 20))
    orig = rt._execute_batch

    def boom(d, batch):
        if d.id == 1:
            raise RuntimeError("injected-crash")
        time.sleep(0.005)   # keep the healthy device slow enough that
        return orig(d, batch)  # the crash lands with work still queued

    rt._execute_batch = boom
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="injected-crash"):
        blas3.gemm(A, A, tile=32, runtime=rt)
    assert time.perf_counter() - t0 < 30      # survivors exit promptly
    assert all(len(d.rs) == 0 for d in rt.devices)
    assert rt._queue.has_ready()              # drained tasks were requeued
    executed = sum(d.ledger.tasks for d in rt.devices)
    assert executed + len(rt._queue) == 64    # 8x8 tiles at tile=32


def test_failed_batch_releases_acquired_readers():
    """A batch failing after gather (backend error) must release the
    tiles it acquired.  The ordering is explicit, not timed: device 0
    holds its first dispatch until device 1 has gathered a batch and
    failed, so the failing device always holds acquired tiles."""
    A = _rand(54, 128, 128)
    rt = BlasxRuntime(_threads_cfg(2, cache_bytes=32 << 20))
    orig = rt._dispatch_steps
    crashed = threading.Event()

    def boom(d, recs):
        if d.id == 1:
            crashed.set()
            raise RuntimeError("dispatch-crash")   # after gather
        assert crashed.wait(timeout=60), "device 1 never took a batch"
        return orig(d, recs)

    rt._dispatch_steps = boom
    with pytest.raises(RuntimeError, match="dispatch-crash"):
        blas3.gemm(A, A, tile=32, runtime=rt)
    assert crashed.is_set()
    for d in rt.devices:
        for k in d.alru.keys():
            assert d.alru.peek(k).reader == 0, (d.id, k)


def test_threads_workers_never_sleep_poll(monkeypatch):
    """Starved workers park on a condition variable; they never
    busy-wait on ``time.sleep``."""
    import repro_torch.core.runtime as rtmod

    calls = []
    real_sleep = time.sleep

    class TimeProxy:
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def sleep(s):
            calls.append(s)
            return real_sleep(s)

    monkeypatch.setattr(rtmod, "time", TimeProxy)
    A = _rand(55, 192, 192)
    # more devices than work at the tail -> a poll loop would sleep()
    out = blas3.gemm(A, A, tile=64, config=_threads_cfg(4))
    np.testing.assert_allclose(out, A @ A, rtol=1e-10, atol=1e-10)
    assert np.array_equal(out, ref_blas3.gemm(
        A, A, tile=64, config=_ref_cfg(n_devices=4, mode="sim")))
    assert calls == []


def test_threads_condition_variable_wakes_on_completion():
    """A worker parked on the CV (deps pending) is woken by a peer's
    completion: TRSM's intra-column chains complete in threads mode, to
    the sim-mode reference's result bit for bit."""
    n = 128
    A = _rand(56, n, n) / n + np.eye(n)
    B = _rand(57, n, n)
    out = blas3.trsm(A, B, tile=32, config=_threads_cfg(3))
    np.testing.assert_allclose(out, blas3.ref_trsm(A, B),
                               rtol=1e-8, atol=1e-8)
    assert np.array_equal(out, ref_blas3.trsm(
        A, B, tile=32, config=_ref_cfg(n_devices=3, mode="sim")))
