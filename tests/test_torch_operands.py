"""Operands the reference takes and the port once refused.

Twins on the CPU: the same numpy operands go through the reference
(``backend="numpy"``, and ``"jax"`` for the integer cases) and through
the port (``backend="cuda"`` and ``"torch"`` with ``device="cpu"``, so
the GEMM kernel's plain version runs).

* Layouts torch cannot share — a negative stride, a non-native byte
  order — through ``ctx.gemm``, ``blas3.gemm`` and ``cblas_dgemm``: the
  port makes one native copy and computes what the reference computes
  (1e-10 relative, the reference's oracle limit; float64 results, which
  the port returns in native byte order where the reference keeps two
  big-endian operands' order).  A read-only input
  registers without a warning, as in the reference, and is still
  shared.  A reversed CBLAS output buffer is written in place in both;
  a byte-swapped one is refused by both with the same error.
* Integer operands: mixed pairs promote as ``np.promote_types`` (the
  reference's ``promote_dtypes``) and int x int stays int64.  Held
  against the reference's numpy backend (bit-equal for small integers,
  1e-10 relative otherwise) and its jax backend (the same dtype; integer
  results bit-equal; float results at 2e-3 relative, since its "float64"
  runs in float32 without x64).
"""
import warnings

import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import BlasxContext as RefContext
from repro.core import blas3 as ref_blas3
from repro.core.runtime import RuntimeConfig as RefConfig
import repro_torch.api as api
from repro_torch.api import BlasxContext
from repro_torch.core import blas3
from repro_torch.core.dtypes import promote_dtypes
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.core.tiling import host_tensor

torch.set_num_threads(1)

KW = dict(n_devices=2, mode="sim", cache_bytes=64 << 20)
TILE = 16


def _ref(backend="numpy"):
    return RefContext(RefConfig(backend=backend, **KW), tile=TILE)


def _port(backend="cuda"):
    return BlasxContext(RuntimeConfig(backend=backend, device="cpu", **KW),
                        tile=TILE)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _layouts(rng):
    """(name, A, B) with A and B of one odd layout each."""
    A = rng.standard_normal((40, 30))
    B = rng.standard_normal((30, 20))
    return [
        ("rows reversed", A[::-1], B),
        ("columns reversed", A, B[:, ::-1]),
        ("both reversed", A[::-1, ::-1], B[::-1]),
        ("big-endian", A.astype(">f8"), B),
        ("big-endian, reversed", A.astype(">f8")[::-1], B.astype(">f8")),
        ("read-only broadcast", np.broadcast_to(A[:1], A.shape), B),
    ]


# ------------------------------------------------------------- layouts
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", range(6))
def test_odd_layouts_through_ctx_and_blas3_gemm(case, backend):
    name, A, B = _layouts(np.random.default_rng(case))[case]
    want = _ref().gemm(A, B).array()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the reference is silent
        got = _port(backend).gemm(A, B).array()
        got3 = blas3.gemm(A, B, tile=TILE,
                          config=RuntimeConfig(backend=backend,
                                               device="cpu", **KW))
    ref3 = ref_blas3.gemm(A, B, tile=TILE, config=RefConfig(**KW))
    for g, w in ((got, want), (np.asarray(got3), ref3)):
        # float64 both; the reference keeps big-endian operands' byte
        # order in its result, the port's results are native (a torch
        # tensor has no byte order)
        assert g.dtype.name == w.dtype.name == "float64", name
        assert g.dtype.isnative
        assert _rel(g, w) <= 1e-10, name
    assert _rel(got, np.asarray(A, np.float64) @ B) <= 1e-10


def test_host_tensor_shares_what_it_can_and_copies_the_rest():
    """Memory is shared wherever ``torch.from_numpy`` can share it; a
    reversed or byte-swapped array becomes one native C-contiguous
    copy; a read-only one is shared without a warning."""
    A = np.arange(12.0).reshape(3, 4)
    assert host_tensor(A).data_ptr() == A.ctypes.data
    strided = A[:, ::2]
    assert host_tensor(strided).data_ptr() == strided.ctypes.data
    for odd in (A[::-1], A[:, ::-1], A.astype(">f8")):
        t = host_tensor(odd)
        assert t.is_contiguous() and t.dtype == torch.float64
        assert np.array_equal(t.numpy(), odd)
    ro = np.broadcast_to(A[:1], A.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = host_tensor(ro)
    assert t.data_ptr() == ro.ctypes.data and t.stride() == (0, 1)


def test_read_only_input_registers_silently_and_stays_shared():
    A = np.random.default_rng(3).standard_normal((20, 20))
    A.setflags(write=False)
    ctx = _port()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        h = ctx.tile(A)
        out = ctx.gemm(h, A)
    assert np.shares_memory(h.array(), A)
    assert _rel(out.array(), _ref().gemm(A, A).array()) <= 1e-10


@pytest.mark.parametrize("order", ["row", "col"])
def test_cblas_dgemm_reads_reversed_and_byte_swapped_buffers(order):
    """2-D reversed views at the dense ``ld``, a flat buffer read
    backwards and a big-endian flat buffer, in both packages."""
    rng = np.random.default_rng(7)
    m, n, k = 33, 21, 17
    o_ref = ref_api.CblasRowMajor if order == "row" else ref_api.CblasColMajor
    o = api.CblasRowMajor if order == "row" else api.CblasColMajor
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C0 = rng.standard_normal((m, n))
    flat = lambda M: (M if order == "row" else M.T).ravel().copy()
    lda, ldb = (k, n) if order == "row" else (m, k)
    cases = [(A[::-1].copy()[::-1], B[::-1].copy()[::-1]),
             (flat(A)[::-1].copy()[::-1], flat(B)),
             (flat(A).astype(">f8"), flat(B).astype(">f8"))]
    for a, b in cases:
        outs = []
        for mod, oo, ctx in ((ref_api, o_ref, _ref()), (api, o, _port())):
            C = C0.copy()
            mod.cblas_dgemm(oo, mod.CblasNoTrans, mod.CblasNoTrans, m, n, k,
                            1.5, a, lda, b, ldb, 0.5, C, n if order == "row"
                            else m, ctx=ctx)
            outs.append(C)
        assert _rel(outs[1], outs[0]) <= 1e-10
        assert _rel(outs[1], 1.5 * A @ B + 0.5 * C0) <= 1e-10


def test_cblas_output_buffers_reversed_or_byte_swapped_as_the_reference():
    """A reversed 2-D output view is updated in place by both packages;
    a byte-swapped one is refused by both, with the same error."""
    rng = np.random.default_rng(9)
    m = n = k = 24
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    C0 = rng.standard_normal((m, n))
    results = []
    for mod, ctx in ((ref_api, _ref()), (api, _port())):
        store = C0[::-1].copy()
        C = store[::-1]  # the caller's view, negative row stride
        mod.cblas_dgemm(mod.CblasRowMajor, mod.CblasNoTrans,
                        mod.CblasNoTrans, m, n, k, 1.0, A, k, B, n, 0.5, C,
                        n, ctx=ctx)
        results.append(store[::-1].copy())
    assert _rel(results[1], results[0]) <= 1e-10
    assert _rel(results[1], A @ B + 0.5 * C0) <= 1e-10
    errors = []
    for mod, ctx in ((ref_api, _ref()), (api, _port())):
        C = C0.astype(">f8")
        with pytest.raises(TypeError) as info:
            mod.cblas_dgemm(mod.CblasRowMajor, mod.CblasNoTrans,
                            mod.CblasNoTrans, m, n, k, 1.0, A, k, B, n, 0.5,
                            C, n, ctx=ctx)
        errors.append(str(info.value))
        assert np.array_equal(C, C0)  # untouched
    assert errors[0] == errors[1]


# ------------------------------------------------------------ integers
PAIRS = [("int64", "float64"), ("float32", "int32"), ("int64", "float32"),
         ("int8", "float16"), ("int64", "int64"), ("int32", "int64"),
         ("uint8", "int8"), ("int16", "float32")]


@pytest.mark.parametrize("a,b", PAIRS)
def test_promotion_is_numpys(a, b):
    import repro.core.dtypes as ref_dtypes
    want = ref_dtypes.promote_dtypes(a, b)
    got = promote_dtypes(a, b)
    assert str(got).replace("torch.", "") == want.name
    assert promote_dtypes(getattr(torch, a), getattr(torch, b)) == got


def test_no_common_precision_raises_as_in_the_reference():
    for a, b in [("bfloat16", "float16"), ("bfloat16", "int64"),
                 ("int32", "bfloat16")]:
        with pytest.raises(ValueError, match="no common precision"):
            promote_dtypes(a, b)
    assert promote_dtypes("bfloat16", "int8") == torch.bfloat16
    assert promote_dtypes("float32", "bfloat16") == torch.float32


def _int_operands(a_dt, b_dt, seed):
    """Small integers (exact in f32 sums too) or normal floats."""
    rng = np.random.default_rng(seed)

    def one(shape, dt):
        if np.dtype(dt).kind in "iu":
            lo = 0 if np.dtype(dt).kind == "u" else -9
            return rng.integers(lo, 10, shape).astype(dt)
        return rng.standard_normal(shape).astype(dt)
    return one((40, 30), a_dt), one((30, 36), b_dt), one((40, 40), a_dt)


ROUTINES = {
    "gemm": lambda c, A, B, S: c.gemm(A, B, alpha=2.0),
    "symm": lambda c, A, B, S: c.symm(S + S.T, A),
    "syrk": lambda c, A, B, S: c.syrk(A),
}


@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("routine", list(ROUTINES))
@pytest.mark.parametrize("a,b", [p for p in PAIRS[:6] if "float16" not in p])
def test_integer_operands_match_the_reference(a, b, routine, backend,
                                              ref_backend):
    A, B, S = _int_operands(a, b, seed=len(a) + len(b))
    want = ROUTINES[routine](_ref(ref_backend), A, B, S).array()
    got = ROUTINES[routine](_port(backend), A, B, S).array()
    assert got.dtype == want.dtype
    if want.dtype.kind in "iu":
        assert np.array_equal(got, want)
    else:
        tol = 1e-10 if ref_backend == "numpy" else 2e-3
        assert _rel(got, want) <= tol


def test_int64_products_are_exact_past_float32():
    """Sums between 2**24 and 2**53 stay exact (the f64 staging); the
    reference's numpy engine agrees bit for bit."""
    A = np.full((8, 64), 3_000_001, dtype=np.int64)
    B = np.full((64, 8), 1_000_003, dtype=np.int64)
    want = _ref().gemm(A, B).array()
    for backend in ("cuda", "torch"):
        got = _port(backend).gemm(A, B).array()
        assert got.dtype == np.int64 and np.array_equal(got, want)
    assert int(want[0, 0]) == 64 * 3_000_001 * 1_000_003


def test_integer_dtype_argument_is_refused_as_in_the_reference():
    A = np.ones((4, 4), dtype=np.int64)
    with pytest.raises(ValueError, match="unsupported dtype"):
        _ref().gemm(A, A, dtype="int64")
    with pytest.raises(ValueError, match="unsupported dtype"):
        _port().gemm(A, A, dtype="int64")
