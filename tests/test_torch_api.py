"""The port's BlasxContext / legacy wrappers against the reference's oracles.

Twins of ``test_api.py`` for the surfaces this slice ports: the six L3
routines in float64 against the reference's numpy ``ref_*`` oracles
(1e-10; 1e-8 for TRSM), the warm-cache contract, ``ctx.tile`` sharing
the caller's memory, handle and context lifecycle, and the rule that
entry points compute on the card unless the caller passes
``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core.runtime import RuntimeConfig as RefConfig
from repro_torch.api import BlasxContext, default_context
from repro_torch.core import blas3
from repro_torch.core.runtime import (BlasxRuntime, RuntimeConfig,
                                      config_from_reference)

# one intra-op thread: the suite runs several worker processes at
# once, and this process's idle OpenMP threads would otherwise spin
# on cores the other workers' timing-sensitive threads-mode tests need
torch.set_num_threads(1)

RNG = np.random.default_rng(21)


def _cfg(backend="cuda", **kw):
    kw.setdefault("n_devices", 2)
    return RuntimeConfig(backend=backend, device="cpu", **kw)


def _operands(routine):
    m, n = 70, 45
    A = RNG.standard_normal((m, m))
    B = RNG.standard_normal((m, n))
    C = RNG.standard_normal((m, n))
    if routine == "trsm":
        A = A + m * np.eye(m)
    if routine in ("syrk", "syr2k"):
        A = RNG.standard_normal((m, 33))
        B = RNG.standard_normal((m, 33))
        C = RNG.standard_normal((m, m))
    return A, B, C


CALLS = {
    "gemm": (lambda ctx, A, B, C: ctx.gemm(A, B.T.copy(), C, alpha=-1.5,
                                           beta=0.5, transb="T"),
             lambda A, B, C: ref_blas3.ref_gemm(A, B.T, C, alpha=-1.5,
                                                beta=0.5, transb="T")),
    "syrk": (lambda ctx, A, B, C: ctx.syrk(A, C, beta=0.5, uplo="L"),
             lambda A, B, C: ref_blas3.ref_syrk(A, C, beta=0.5, uplo="L")),
    "syr2k": (lambda ctx, A, B, C: ctx.syr2k(A, B, C, alpha=0.5, beta=2.0),
              lambda A, B, C: ref_blas3.ref_syr2k(A, B, C, alpha=0.5,
                                                  beta=2.0)),
    "symm": (lambda ctx, A, B, C: ctx.symm(A, B, C, beta=-1.0, uplo="L"),
             lambda A, B, C: ref_blas3.ref_symm(A, B, C, beta=-1.0,
                                                uplo="L")),
    "trmm": (lambda ctx, A, B, C: ctx.trmm(A, B, alpha=2.0, transa="T",
                                           diag="U"),
             lambda A, B, C: ref_blas3.ref_trmm(A, B, alpha=2.0, transa="T",
                                                diag="U")),
    "trsm": (lambda ctx, A, B, C: ctx.trsm(A, B, uplo="L", side="L"),
             lambda A, B, C: ref_blas3.ref_trsm(A, B, uplo="L", side="L")),
}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("routine", sorted(CALLS))
def test_context_routines_match_reference_oracles_f64(routine, backend):
    A, B, C = _operands(routine)
    run, oracle = CALLS[routine]
    with BlasxContext(_cfg(backend), tile=16) as ctx:
        got = run(ctx, A, B, C).array()
    want = oracle(A, B, C)
    tol = 1e-8 if routine == "trsm" else 1e-10
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("routine", ["gemm", "syrk", "syr2k", "symm",
                                     "trmm", "trsm"])
def test_port_oracles_equal_reference_oracles(routine):
    A, B, C = _operands(routine)
    kw = {"trsm": dict(uplo="L"), "trmm": dict(diag="U")}.get(routine, {})
    if routine in ("gemm", "symm"):
        args = (A, B, C)
        kw["beta"] = 0.5
    elif routine == "syrk":
        args = (A, C)
        kw["beta"] = 0.5
    elif routine == "syr2k":
        args = (A, B, C)
    else:
        args = (A, B)
    got = getattr(blas3, f"ref_{routine}")(*args, **kw)
    want = getattr(ref_blas3, f"ref_{routine}")(*args, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("side", ["L", "R"])
def test_legacy_wrappers_sides(side):
    A = RNG.standard_normal((40, 40)) + 40 * np.eye(40)
    B = RNG.standard_normal((40, 40))
    cfg = _cfg()
    for name in ("symm", "trmm", "trsm"):
        got = getattr(blas3, name)(A, B, side=side, tile=16, config=cfg)
        want = getattr(ref_blas3, f"ref_{name}")(A, B, side=side)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


# ==================================================== warm-cache contract
def test_chained_calls_reuse_cached_tiles():
    A = RNG.standard_normal((64, 64))
    B = RNG.standard_normal((64, 64))
    with BlasxContext(_cfg(n_devices=1), tile=16) as ctx:
        Ah, Bh = ctx.tile(A), ctx.tile(B)
        ctx.gemm(Ah, Bh)
        cold = ctx.last_call
        out = ctx.gemm(Ah, Bh)
        warm = ctx.last_call
        assert warm.h2d_bytes < cold.h2d_bytes
        assert warm.h2d_bytes == 0          # single device: all L1 hits
        assert warm.l1_hits > 0 and warm.l1_misses == 0
        np.testing.assert_allclose(out.array(), A @ B, rtol=1e-12)
        assert ctx.n_calls == 2 and len(ctx.calls) == 2
        ctx.reset_stats()
        ctx.gemm(Ah, Bh)
        assert ctx.last_call.h2d_bytes == 0   # still warm after reset_stats
        ctx.reset()
        ctx.gemm(Ah, Bh)
        assert ctx.last_call.h2d_bytes == cold.h2d_bytes   # cold again


def test_output_handle_feeds_next_call_and_mutation_invalidate():
    A = RNG.standard_normal((48, 48))
    with BlasxContext(_cfg(), tile=16) as ctx:
        Ah = ctx.tile(A)
        C1 = ctx.gemm(Ah, Ah)
        C2 = ctx.gemm(C1, Ah)
        np.testing.assert_allclose(C2.array(), A @ A @ A, rtol=1e-10)
        # in-place mutation + invalidate serves the new values
        A[:] *= 2.0
        Ah.invalidate()
        np.testing.assert_allclose(ctx.gemm(Ah, Ah).array(), A @ A,
                                   rtol=1e-12)


def test_tile_does_not_copy():
    """The reference gotcha: ctx.tile(A) shares the caller's memory."""
    A = RNG.standard_normal((32, 24))
    with BlasxContext(_cfg(), tile=16) as ctx:
        h = ctx.tile(A)
        assert np.shares_memory(h.array(), A)
        A[0, 0] = 123.0
        assert h.array()[0, 0] == 123.0
        # an explicit dtype casts, and then it is a copy
        h32 = ctx.tile(A, dtype="float32")
        assert h32.dtype == torch.float32
        assert not np.shares_memory(h32.array(), A)


def test_handle_arrays_by_dtype():
    A = RNG.standard_normal((32, 32)).astype(np.float32)
    with BlasxContext(_cfg(), tile=16) as ctx:
        for dt, kind in (("float16", np.ndarray),
                         ("bfloat16", torch.Tensor)):
            out = ctx.gemm(A, A, dtype=dt)
            arr = out.array()
            assert isinstance(arr, kind)
            got = torch.as_tensor(arr).float().numpy()
            np.testing.assert_allclose(got, A @ A, rtol=3e-2, atol=3e-1)
        with pytest.raises(ValueError, match="no common precision"):
            ctx.gemm(ctx.tile(A, dtype="bfloat16"),
                     ctx.tile(A, dtype="float16"))


def test_legacy_output_dtype_and_tile_mismatch():
    A = RNG.standard_normal((32, 32)).astype(np.float32)
    C = np.zeros((32, 32), dtype=np.float64)
    with BlasxContext(_cfg(), tile=16) as ctx:
        out = ctx.gemm(A, A, C, beta=1.0)
        assert out.dtype == torch.float64       # C's dtype wins
        a16, a8 = ctx.tile(A, tile=16), ctx.tile(A, tile=8)
        with pytest.raises(ValueError, match="tile mismatch"):
            ctx.gemm(a16, a8)
        with pytest.raises(ValueError, match="beta != 0 requires C"):
            ctx.gemm(A, A, beta=1.0)
        with pytest.raises(ValueError, match="auto_tile"):
            ctx.tile(A, tile="auto")


def test_cross_context_handles_rejected_and_close():
    A = RNG.standard_normal((16, 16))
    c1, c2 = BlasxContext(_cfg()), BlasxContext(_cfg())
    h = c1.tile(A)
    with pytest.raises(ValueError, match="different context"):
        c2.gemm(h, A)
    c1.close()
    c1.close()                                  # idempotent
    assert c1.closed
    with pytest.raises(RuntimeError, match="closed"):
        c1.gemm(A, A)
    c2.close()


def test_adopted_runtime_survives_context_close():
    A = RNG.standard_normal((32, 32))
    rt = BlasxRuntime(_cfg(n_devices=1))
    with BlasxContext(runtime=rt, tile=16) as ctx:
        h = ctx.tile(A)
        ctx.gemm(h, h)
    assert rt.runs == 1 and rt.total_comm_bytes()["h2d"] > 0
    with pytest.raises(ValueError, match="device"):
        BlasxContext(runtime=rt, device="cuda")


def test_device_class_and_mesh_knobs():
    with BlasxContext(_cfg(), mesh=4) as ctx:
        assert ctx.cfg.device_class == "mesh_shard"
        assert ctx.cfg.mesh_devices == 4
        A = RNG.standard_normal((64, 64))
        np.testing.assert_allclose(ctx.gemm(A, A, tile=16).array(), A @ A,
                                   rtol=1e-12)
    got = blas3.gemm(A, A, tile=16, config=_cfg(), mesh=2)
    np.testing.assert_allclose(got, A @ A, rtol=1e-12)


# ================================================ card unless asked for CPU
def test_default_device_needs_a_card():
    """With no card, the default device raises rather than quietly
    computing on the host; device="cpu" is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlasxContext()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlasxRuntime(RuntimeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        blas3.gemm(np.eye(4), np.eye(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        default_context()
    assert RuntimeConfig().device == "cuda"
    assert RuntimeConfig().backend == "cuda"
    ctx = BlasxContext(device="cpu")
    assert ctx.cfg.device == "cpu"
    ctx.close()


def test_config_from_reference_maps_backends_and_keeps_the_machine():
    ref = RefConfig(n_devices=3, backend="pallas", policy="parsec",
                    speeds=[1.0, 2.0, 0.5], cache_bytes=1 << 20,
                    work_centric=True)
    cfg = config_from_reference(dataclasses.asdict(ref), device="cpu")
    assert cfg.backend == "cuda" and cfg.device == "cpu"
    assert cfg.topology() == ref.topology()
    assert cfg.policy == "parsec" and cfg.work_centric
    cfg = config_from_reference(
        dataclasses.asdict(RefConfig(kernel="jax")), device="cpu")
    assert cfg.backend == "torch"
    with pytest.raises(ValueError, match="unknown device"):
        RuntimeConfig(device="tpu")
