"""The port's CBLAS layer against the reference's.

Twins of the CBLAS tests of ``test_api.py``: the same seeded numpy
buffers go through ``repro.api.cblas_*`` (numpy backend) and
``repro_torch.api.cblas_*`` (the ``cuda`` and ``torch`` backends on the
CPU, so the GEMM kernel's plain version runs).  Both must update the
caller's buffer in place to within the reference's tolerances (1e-10;
1e-8 for TRSM; 2e-3 for the single-precision family, the reference's
f32 limit), leave the padding between rows or columns untouched, and
leave equal per-call ledgers behind.  The refusals (bad ``ld``, bad
flags, output buffers that are lists, read-only or of the wrong dtype)
must raise the same exception with the same message.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.api import BlasxContext as RefContext
from repro.core.runtime import RuntimeConfig as RefConfig
import repro_torch.api as api
from repro_torch.api import BlasxContext
from repro_torch.core.runtime import RuntimeConfig, config_from_reference

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

PAD = 7.0            # what padding holds, and must still hold after
FAMILY_DTYPE = {"d": np.float64, "s": np.float32}
TOL = {"d": 1e-10, "s": 2e-3}
ORDERS = {"row": api.CblasRowMajor, "col": api.CblasColMajor}


def _contexts(backend="cuda", tile=48, **kw):
    """A reference context (numpy backend) and a port context on the
    CPU with the same modeled machine."""
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 64 << 20)
    return (RefContext(RefConfig(**kw), tile=tile),
            BlasxContext(RuntimeConfig(backend=backend, device="cpu", **kw),
                         tile=tile))


def _ledger(ctx):
    return [dataclasses.asdict(c) for c in ctx.calls]


def _spd(rng, n):
    """Well-conditioned triangular-solve operand."""
    return rng.standard_normal((n, n)) / n + np.eye(n)


def _store(M, order, layout, dtype, pad):
    """Lay ``M`` out as a CBLAS caller would: a flat buffer or a 2-D
    strided view into padded storage, ``pad`` extra elements per
    leading-dimension run.  Returns ``(buffer, ld, storage)``."""
    rows, cols = M.shape
    if order == "row":
        ld = cols + pad
        storage = np.full(rows * ld, PAD, dtype=dtype)
        grid = storage.reshape(rows, ld)
        grid[:, :cols] = M
        view = grid[:, :cols]
    else:
        ld = rows + pad
        storage = np.full(cols * ld, PAD, dtype=dtype)
        grid = storage.reshape(cols, ld).T
        grid[:rows, :] = M
        view = grid[:rows, :]
    return (storage if layout == "flat" else view), ld, storage


def _load(storage, rows, cols, ld, order):
    if order == "row":
        return storage.reshape(-1, ld)[:rows, :cols]
    return storage.reshape(-1, ld).T[:rows, :cols]


def _padding_mask(rows, cols, ld, order, size):
    mask = np.ones(size, dtype=bool)
    _load(mask, rows, cols, ld, order)[...] = False
    return mask


# ------------------------------------------------------------- the cases
# Each case: operands (by name, the last one updated in place), the
# routine's scalar arguments, and how to call it given ((buf, ld) by
# operand name).  beta != 0 wherever a beta exists; side='R' for
# symm/trmm/trsm, as the reference's three-surface parity cases.
def _case(routine, rng):
    if routine == "gemm":
        m, n, k = 54, 45, 35
        ops = {"A": rng.standard_normal((m, k)),
               "B": rng.standard_normal((k, n)),
               "C": rng.standard_normal((m, n))}
        call = lambda f, o, b: f(o, api.CblasNoTrans, api.CblasNoTrans,
                                 m, n, k, 1.3, *b["A"], *b["B"], -0.7,
                                 *b["C"])
    elif routine == "syrk":
        n, k = 48, 30
        ops = {"A": rng.standard_normal((n, k)),
               "C": rng.standard_normal((n, n))}
        call = lambda f, o, b: f(o, api.CblasLower, api.CblasNoTrans, n, k,
                                 0.8, *b["A"], 1.4, *b["C"])
    elif routine == "syr2k":
        n, k = 44, 25
        ops = {"A": rng.standard_normal((n, k)),
               "B": rng.standard_normal((n, k)),
               "C": rng.standard_normal((n, n))}
        call = lambda f, o, b: f(o, api.CblasUpper, api.CblasNoTrans, n, k,
                                 0.5, *b["A"], *b["B"], 0.9, *b["C"])
    elif routine == "symm":
        m, n = 36, 50
        ops = {"A": rng.standard_normal((n, n)),
               "B": rng.standard_normal((m, n)),
               "C": rng.standard_normal((m, n))}
        call = lambda f, o, b: f(o, api.CblasRight, api.CblasLower, m, n,
                                 1.1, *b["A"], *b["B"], 0.6, *b["C"])
    elif routine == "trmm":
        m, n = 48, 42
        ops = {"A": rng.standard_normal((n, n)),
               "B": rng.standard_normal((m, n))}
        call = lambda f, o, b: f(o, api.CblasRight, api.CblasUpper,
                                 api.CblasTrans, api.CblasUnit, m, n, 0.9,
                                 *b["A"], *b["B"])
    else:
        m, n = 32, 40
        ops = {"A": _spd(rng, n), "B": rng.standard_normal((m, n))}
        call = lambda f, o, b: f(o, api.CblasRight, api.CblasLower,
                                 api.CblasNoTrans, api.CblasNonUnit, m, n,
                                 1.2, *b["A"], *b["B"])
    return ops, call


ROUTINES = ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm")


@pytest.mark.parametrize("layout", ["flat", "strided2d"])
@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("family", ["d", "s"])
@pytest.mark.parametrize("routine", ROUTINES)
def test_cblas_matches_reference_in_place(routine, family, order, layout):
    """Every routine in both families, flat buffers and 2-D strided
    views, padded leading dimensions in both orders: the caller's
    buffer gets the reference's result, its padding stays untouched,
    and the two ledgers are equal."""
    rng = np.random.default_rng(ROUTINES.index(routine))
    ops, call = _case(routine, rng)
    dt = FAMILY_DTYPE[family]
    out_name = list(ops)[-1]
    results = {}
    ref_ctx, ctx = _contexts()
    with ref_ctx, ctx:
        for pkg, c in ((ref_api, ref_ctx), (api, ctx)):
            bufs, stores = {}, {}
            for i, (name, M) in enumerate(ops.items()):
                buf, ld, storage = _store(M.astype(dt), order, layout, dt,
                                          pad=3 + i)
                bufs[name] = (buf, ld)
                stores[name] = (storage, ld)
            fn = getattr(pkg, f"cblas_{family}{routine}")
            assert call(lambda *a: fn(*a, ctx=c), ORDERS[order], bufs) \
                is None
            storage, ld = stores[out_name]
            rows, cols = ops[out_name].shape
            pad = _padding_mask(rows, cols, ld, order, storage.size)
            assert np.all(storage[pad] == PAD), "padding was written"
            results[pkg.__name__] = _load(storage, rows, cols, ld,
                                          order).copy()
        assert _ledger(ctx) == _ledger(ref_ctx)
    tol = 1e-8 if routine == "trsm" and family == "d" else TOL[family]
    np.testing.assert_allclose(results["repro_torch.api"],
                               results["repro.api"], rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("transb", ["N", "T"])
@pytest.mark.parametrize("transa", ["N", "T", "C"])
def test_cblas_gemm_transposes_and_flag_spellings(transa, transb, backend):
    """op(A)/op(B) through enum and string flags (ConjTrans == Trans
    for real matrices), on both of the port's backends."""
    rng = np.random.default_rng(5)
    m, n, k = 26, 22, 34
    A = rng.standard_normal((m, k) if transa == "N" else (k, m))
    B = rng.standard_normal((k, n) if transb == "N" else (n, k))
    flags = {"N": api.CblasNoTrans, "T": api.CblasTrans,
             "C": api.CblasConjTrans}
    C_ref, C = np.zeros((m, n)), np.zeros((m, n))
    ref_ctx, ctx = _contexts(backend)
    with ref_ctx, ctx:
        ref_api.cblas_dgemm(api.CblasRowMajor, transa, transb.lower(), m, n,
                            k, 1.0, A, A.shape[1], B, B.shape[1], 0.0,
                            C_ref, n, ctx=ref_ctx)
        api.cblas_dgemm(api.CblasRowMajor, flags[transa], transb.lower(),
                        m, n, k, 1.0, A, A.shape[1], B, B.shape[1], 0.0, C,
                        n, ctx=ctx)
        assert _ledger(ctx) == _ledger(ref_ctx)
    opa = A if transa == "N" else A.T
    opb = B if transb == "N" else B.T
    np.testing.assert_allclose(C, opa @ opb, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(C, C_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("family", ["d", "s"])
@pytest.mark.parametrize("uplo", ["U", "L"])
def test_cblas_syrk_beta_zero_keeps_the_other_triangle(uplo, family):
    rng = np.random.default_rng(9)
    dt = FAMILY_DTYPE[family]
    n, k = 40, 16
    A = rng.standard_normal((n, k)).astype(dt)
    C0 = rng.standard_normal((n, n)).astype(dt)
    C, C_ref = C0.copy(), C0.copy()
    flag = api.CblasUpper if uplo == "U" else api.CblasLower
    ref_ctx, ctx = _contexts()
    with ref_ctx, ctx:
        getattr(ref_api, f"cblas_{family}syrk")(
            api.CblasRowMajor, flag, api.CblasNoTrans, n, k, 1.0, A, k, 0.0,
            C_ref, n, ctx=ref_ctx)
        getattr(api, f"cblas_{family}syrk")(
            api.CblasRowMajor, flag, api.CblasNoTrans, n, k, 1.0, A, k, 0.0,
            C, n, ctx=ctx)
    keep = np.tril_indices(n, -1) if uplo == "U" else np.triu_indices(n, 1)
    np.testing.assert_array_equal(C[keep], C0[keep])
    tri = np.triu if uplo == "U" else np.tril
    full = A.astype(np.float64) @ A.T.astype(np.float64)
    np.testing.assert_allclose(tri(C), tri(full), rtol=TOL[family],
                               atol=TOL[family])
    np.testing.assert_allclose(C, C_ref, rtol=TOL[family], atol=TOL[family])


def _refusals():
    """(id, call(pkg, ctx)) pairs that both packages must refuse."""
    E4 = lambda: np.eye(4)
    RM, NT = api.CblasRowMajor, api.CblasNoTrans

    def gemm(A, lda, C, ldc, order=RM, ta=NT, fam="d"):
        return lambda pkg, ctx: getattr(pkg, f"cblas_{fam}gemm")(
            order, ta, NT, 4, 4, 4, 1.0, A, lda, E4(), 4, 0.0, C, ldc,
            ctx=ctx)

    ro = np.zeros((4, 4))
    ro.flags.writeable = False
    dense = np.zeros((4, 4))
    return [
        ("f32-output-for-d", gemm(E4(), 4, np.zeros((4, 4), np.float32), 4)),
        ("f64-output-for-s", gemm(E4(), 4, np.zeros((4, 4)), 4, fam="s")),
        ("ld-below-cols", gemm(np.zeros(16), 2, np.zeros((4, 4)), 4)),
        ("bogus-trans", gemm(E4(), 4, np.zeros((4, 4)), 4, ta=999)),
        ("bogus-order", gemm(np.zeros(16), 4, np.zeros((4, 4)), 4,
                             order=7)),
        ("list-output", gemm(E4(), 4, [0.0] * 16, 4)),
        ("read-only-output", gemm(E4(), 4, ro, 4)),
        ("dense-2d-with-padded-ld", gemm(E4(), 4, dense, 6)),
        ("buffer-too-small", gemm(np.zeros(15), 4, np.zeros((4, 4)), 4)),
        ("wrong-2d-shape", gemm(np.eye(5), 5, np.zeros((4, 4)), 4)),
        ("3d-buffer", gemm(np.zeros((2, 2, 4)), 4, np.zeros((4, 4)), 4)),
        ("bogus-uplo", lambda pkg, ctx: pkg.cblas_dsyrk(
            RM, 5, NT, 4, 4, 1.0, E4(), 4, 0.0, np.zeros((4, 4)), 4,
            ctx=ctx)),
        ("bogus-side", lambda pkg, ctx: pkg.cblas_dtrsm(
            RM, "X", api.CblasUpper, NT, api.CblasNonUnit, 4, 4, 1.0, E4(),
            4, np.zeros((4, 4)), 4, ctx=ctx)),
        ("bogus-diag", lambda pkg, ctx: pkg.cblas_strmm(
            RM, api.CblasLeft, api.CblasUpper, NT, 0, 4, 4, 1.0,
            np.eye(4, dtype=np.float32), 4, np.zeros((4, 4), np.float32), 4,
            ctx=ctx)),
    ]


@pytest.mark.parametrize("case", _refusals(), ids=lambda c: c[0])
def test_cblas_refusals_match_the_reference(case):
    _, call = case
    ref_ctx, ctx = _contexts()
    with ref_ctx, ctx:
        with pytest.raises((TypeError, ValueError)) as want:
            call(ref_api, ref_ctx)
        with pytest.raises((TypeError, ValueError)) as got:
            call(api, ctx)
    assert got.type is want.type
    assert str(got.value) == str(want.value)


def test_cblas_strided_view_with_matching_ld_reads_the_right_elements():
    """A 2-D view into padded storage is read through its strides, not
    as if it were dense (the reference's regression)."""
    rng = np.random.default_rng(4)
    store = rng.standard_normal((30, 40))
    A = store[:, :24]                     # strides (40*8, 8): lda = 40
    B = rng.standard_normal((24, 20))
    C = np.zeros((30, 20))
    _, ctx = _contexts()
    with ctx:
        api.cblas_dgemm(api.CblasRowMajor, api.CblasNoTrans,
                        api.CblasNoTrans, 30, 20, 24, 1.0, A, 40, B, 20, 0.0,
                        C, 20, ctx=ctx)
    np.testing.assert_allclose(C, A @ B, rtol=1e-10, atol=1e-10)


def test_cblas_context_conflicts_and_the_default_context():
    """``backend=``/``mesh=`` that contradict ``ctx`` are refused as in
    the reference; without ``ctx`` the routines run on the module's
    default context, which is on the card (so it raises here when no
    card is present)."""
    _, ctx = _contexts()
    args = (api.CblasRowMajor, api.CblasNoTrans, api.CblasNoTrans, 4, 4, 4,
            1.0, np.eye(4), 4, np.eye(4), 4, 0.0, np.zeros((4, 4)), 4)
    with ctx:
        with pytest.raises(ValueError, match="conflicts with ctx backend"):
            api.cblas_dgemm(*args, ctx=ctx, backend="torch")
        with pytest.raises(ValueError, match="conflicts with ctx mesh"):
            api.cblas_dgemm(*args, ctx=ctx, mesh=4)
        with pytest.raises(ValueError, match="conflicts with ctx device"):
            api.cblas_dgemm(*args, ctx=ctx, device_class="mesh_shard")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context runs there")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        api.cblas_dgemm(*args)


def test_cblas_sgemm_matches_the_pallas_reference():
    """The single-precision family on the port's kernel route against
    the reference's Pallas backend (interpret mode) at the reference's
    2e-3, with equal ledgers."""
    rng = np.random.default_rng(6)
    m, n, k = 64, 48, 80
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((k, n)).astype(np.float32)
    C0 = rng.standard_normal((m, n)).astype(np.float32)
    ref_cfg = RefConfig(n_devices=2, mode="sim", backend="pallas")
    ref_ctx = RefContext(ref_cfg, tile=32)
    ctx = BlasxContext(config_from_reference(dataclasses.asdict(ref_cfg),
                                             device="cpu"), tile=32)
    C_ref, C = C0.copy(), C0.copy()
    with ref_ctx, ctx:
        for pkg, c, out in ((ref_api, ref_ctx, C_ref), (api, ctx, C)):
            # column-major: A stored k x m (op(A) = A^T), B k x n, C m x n
            Af = np.asfortranarray(A.T)
            Bf = np.asfortranarray(B)
            Cf = np.asfortranarray(out)
            pkg.cblas_sgemm(api.CblasColMajor, api.CblasTrans,
                            api.CblasNoTrans, m, n, k, 0.5, Af, k, Bf, k,
                            2.0, Cf, m, ctx=c)
            out[...] = Cf
        assert _ledger(ctx) == _ledger(ref_ctx)
    want = 0.5 * A.astype(np.float64) @ B + 2.0 * C0
    np.testing.assert_allclose(C, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(C, C_ref, rtol=2e-3, atol=2e-3)
