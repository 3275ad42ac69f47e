"""The port's execution backends against the reference's.

Twins of ``test_backends.py``: the same routines, variants, shapes and
numpy inputs run through the reference (``jax``/``pallas`` backends,
Pallas in interpret mode) and through the port (``torch``/``cuda``
backends on ``device="cpu"``, where the CUDA backend's kernel wrapper
takes its plain version).  Results agree at the reference suite's TOL,
and the launch accounting agrees exactly, with the engines renamed
``jax -> torch`` and ``pallas -> cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro_torch.backends import available_backends, create_backend
from repro_torch.backends.base import StepGroupKey
from repro_torch.core import blas3
from repro_torch.core.runtime import BlasxRuntime, config_from_reference

# one intra-op thread: the suite runs several worker processes at
# once, and this process's idle OpenMP threads would otherwise spin
# on cores the other workers' timing-sensitive threads-mode tests need
torch.set_num_threads(1)

M, N, K, TILE = 48, 40, 56, 16   # 40/56 leave ragged edge tiles
TOL = dict(rtol=2e-3, atol=2e-3)
ENGINE = {"jax": "torch", "pallas": "cuda"}


def ref_cfg(backend, **kw):
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    return RefConfig(backend=backend, **kw)


def port_cfg(ref):
    return config_from_reference(dataclasses.asdict(ref), device="cpu")


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _run_case(case, ref_backend):
    """(port result, reference result, oracle) for one routine/variant."""
    rng = np.random.default_rng(11)
    r = dict(case)
    routine = r.pop("routine")
    rc = ref_cfg(ref_backend)
    pc = port_cfg(rc)
    if routine == "gemm":
        ta, tb = r["transa"], r["transb"]
        A = _f32(rng, *((M, K) if ta == "N" else (K, M)))
        B = _f32(rng, *((K, N) if tb == "N" else (N, K)))
        C = _f32(rng, M, N) if r.get("beta") else None
        args = (A, B, C)
        want = ref_blas3.ref_gemm(A, B, C, **r)
    elif routine == "syrk":
        tr = r["trans"]
        A = _f32(rng, *((M, K) if tr == "N" else (K, M)))
        C = _f32(rng, M, M) if r.get("beta") else None
        args = (A, C)
        want = ref_blas3.ref_syrk(A, C, **r)
    elif routine == "syr2k":
        tr = r["trans"]
        shape = (M, K) if tr == "N" else (K, M)
        A, B = _f32(rng, *shape), _f32(rng, *shape)
        C = _f32(rng, M, M) if r.get("beta") else None
        args = (A, B, C)
        want = ref_blas3.ref_syr2k(A, B, C, **r)
    elif routine == "symm":
        d = M if r["side"] == "L" else N
        A, B = _f32(rng, d, d), _f32(rng, M, N)
        C = _f32(rng, M, N) if r.get("beta") else None
        args = (A, B, C)
        want = ref_blas3.ref_symm(A, B, C, **r)
    else:  # trmm / trsm
        d = M if r["side"] == "L" else N
        A = _f32(rng, d, d)
        if routine == "trsm":  # keep the solve well-conditioned in f32
            A = A + d * np.eye(d, dtype=np.float32)
        B = _f32(rng, M, N)
        args = (A, B)
        want = getattr(ref_blas3, f"ref_{routine}")(A, B, **r)
    ref_out = getattr(ref_blas3, routine)(*args, tile=TILE, config=rc, **r)
    got = getattr(blas3, routine)(*args, tile=TILE, config=pc, **r)
    return got, ref_out, want


CASES = [
    dict(routine="gemm", transa="N", transb="N"),
    dict(routine="gemm", transa="N", transb="T", beta=0.5),
    dict(routine="gemm", transa="T", transb="N", alpha=-0.5),
    dict(routine="gemm", transa="T", transb="T"),
    dict(routine="syrk", uplo="U", trans="N"),
    dict(routine="syrk", uplo="U", trans="T", beta=0.3),
    dict(routine="syrk", uplo="L", trans="N", alpha=0.7),
    dict(routine="syrk", uplo="L", trans="T"),
    dict(routine="syr2k", uplo="U", trans="N"),
    dict(routine="syr2k", uplo="U", trans="T"),
    dict(routine="syr2k", uplo="L", trans="N", beta=1.5),
    dict(routine="syr2k", uplo="L", trans="T"),
    dict(routine="symm", side="L", uplo="U"),
    dict(routine="symm", side="L", uplo="L", beta=0.5),
    dict(routine="symm", side="R", uplo="U"),
    dict(routine="symm", side="R", uplo="L"),
    dict(routine="trmm", side="L", uplo="U", transa="N"),
    dict(routine="trmm", side="L", uplo="L", transa="T", diag="U"),
    dict(routine="trmm", side="R", uplo="U", transa="T"),
    dict(routine="trmm", side="R", uplo="L", transa="N"),
    dict(routine="trsm", side="L", uplo="U", transa="N"),
    dict(routine="trsm", side="L", uplo="L", transa="T", diag="U"),
    dict(routine="trsm", side="R", uplo="U", transa="T"),
    dict(routine="trsm", side="R", uplo="L", transa="N"),
]


def _case_id(case):
    return "-".join(str(v) for v in case.values())


# the reference's fast pallas lane: the first case of each routine
_PALLAS_FAST = [c for i, c in enumerate(CASES)
                if c["routine"] not in {x["routine"] for x in CASES[:i]}]


@pytest.mark.parametrize("case", _PALLAS_FAST, ids=_case_id)
def test_cuda_backend_parity_with_reference_pallas(case):
    got, ref_out, want = _run_case(case, "pallas")
    np.testing.assert_allclose(got, ref_out, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_torch_backend_parity_with_reference_jax(case):
    got, ref_out, want = _run_case(case, "jax")
    np.testing.assert_allclose(got, ref_out, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


# ===================================================== launch accounting
def test_batched_dispatch_fewer_launches_than_tasks():
    """Twin of the reference's acceptance property: the batched torch
    backend issues strictly fewer launches than tasks (and far fewer
    than k-steps) — with the reference jax backend's exact counts."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((256, 256)).astype(np.float32)
    B = rng.standard_normal((256, 256)).astype(np.float32)
    rc = ref_cfg("jax", n_devices=1)
    ref_rt, rt = RefRuntime(rc), BlasxRuntime(port_cfg(rc))
    want = ref_blas3.gemm(A, B, tile=32, runtime=ref_rt)
    out = blas3.gemm(A, B, tile=32, runtime=rt)
    np.testing.assert_allclose(out, A @ B, **TOL)
    np.testing.assert_allclose(out, want, **TOL)
    ls = rt.launch_stats()
    assert ls["tasks"] == 64 and ls["steps"] == 512
    assert ls["kernel_launches"] < ls["tasks"] < ls["steps"]
    assert ls["launches_saved"] == ls["steps"] - ls["kernel_launches"]
    ref_ls = ref_rt.launch_stats()
    for key in ("tasks", "steps", "groups", "kernel_launches",
                "launches_saved"):
        assert ls[key] == ref_ls[key], key
    assert ls["engine_flops"] == {"torch": ref_ls["engine_flops"]["jax"]}


def test_ledger_attributes_engines_cuda_fallback():
    """Twin of test_ledger_attributes_engines_pallas_fallback: full-fill
    groups go to the kernel (``cuda``), sym-fill diagonal steps to the
    torch fallback, split exactly as the reference splits pallas/jax."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((96, 96)).astype(np.float32)
    B = rng.standard_normal((96, 64)).astype(np.float32)
    rc = ref_cfg("pallas", n_devices=1)
    ref_rt, rt = RefRuntime(rc), BlasxRuntime(port_cfg(rc))
    want = ref_blas3.symm(A, B, tile=32, runtime=ref_rt)
    out = blas3.symm(A, B, tile=32, runtime=rt)
    np.testing.assert_allclose(out, ref_blas3.ref_symm(A, B), **TOL)
    np.testing.assert_allclose(out, want, **TOL)
    ls = rt.launch_stats()
    assert ls["engine_flops"].get("cuda", 0) > 0    # full-fill rows
    assert ls["engine_flops"].get("torch", 0) > 0   # sym-fill diagonal
    total = sum(d.ledger.flops for d in rt.devices)
    assert sum(ls["engine_flops"].values()) == total
    assert ls["steps"] == 18   # 3x2 output tiles x 3 k-steps each
    ref_ls = ref_rt.launch_stats()
    assert ls["engine_flops"] == {ENGINE[e]: f for e, f in
                                  ref_ls["engine_flops"].items()}
    assert ls["kernel_launches"] == ref_ls["kernel_launches"]


def test_launch_stats_reset():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((64, 64))
    rt = BlasxRuntime(port_cfg(ref_cfg("jax", n_devices=1)))
    blas3.gemm(A, A, tile=32, runtime=rt)
    assert rt.launch_stats()["kernel_launches"] > 0
    rt.reset_stats()
    ls = rt.launch_stats()
    assert ls["kernel_launches"] == 0 and ls["steps"] == 0
    assert ls["engine_flops"] == {}


def test_threads_mode_parity():
    """Batched dispatch composes with the faithful threaded engine."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((96, 80)).astype(np.float32)
    B = rng.standard_normal((80, 96)).astype(np.float32)
    for backend in ("jax", "pallas"):
        cfg = port_cfg(ref_cfg(backend, n_devices=2, mode="threads"))
        out = blas3.gemm(A, B, tile=32, config=cfg)
        np.testing.assert_allclose(out, A @ B, **TOL)


# ================================================== backend unit behaviour
@pytest.mark.parametrize("name", ["torch", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16",
                                   "float16"])
def test_run_group_folds_each_items_k_chain(name, dtype):
    """One group = one launch; each item is its own k-chain, computed in
    the accumulator type and returned in the group's dtype."""
    rng = np.random.default_rng(4)
    g, s, m, k, n = 3, 4, 8, 5, 6
    a = [torch.from_numpy(rng.standard_normal((m, k))) for _ in range(g * s)]
    b = [torch.from_numpy(rng.standard_normal((k, n))) for _ in range(g * s)]
    dt = getattr(torch, dtype)
    key = StepGroupKey("gemm", False, False, "full", "full", m, k, n, dtype,
                       steps=s)
    res = create_backend(name).run_group(key, [t.to(dt) for t in a],
                                         [t.to(dt) for t in b])
    assert res.launches == 1 and res.engine == name
    assert len(res.products) == g
    tol = 1e-12 if dtype == "float64" else (1e-5 if dtype == "float32"
                                            else 2e-2)
    for i, prod in enumerate(res.products):
        assert prod.dtype == dt and tuple(prod.shape) == (m, n)
        want = sum(a[i * s + j].to(dt).double() @ b[i * s + j].to(dt).double()
                   for j in range(s))
        np.testing.assert_allclose(prod.double().numpy(), want.numpy(),
                                   rtol=tol, atol=tol * 10)


def test_cuda_backend_routes_like_the_reference_pallas_backend():
    """Full-fill gemm/syrk/syr2k/symm groups of every dtype, f64
    included, go to the kernel; everything else to torch."""
    be = create_backend("cuda")
    for op in ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm"):
        for fill in ("full", "sym_u", "tri_l"):
            key = StepGroupKey(op, False, False, fill, "full", 4, 4, 4,
                               "float64")
            want = fill == "full" and op not in ("trmm", "trsm")
            assert be._route_to_kernel(key) is want


def test_backend_selection_and_rejections():
    from repro_torch.api import BlasxContext
    from repro_torch.core.runtime import RuntimeConfig

    assert set(available_backends()) == {"torch", "cuda", "numpy"}
    with pytest.raises(ValueError, match="unknown backend"):
        create_backend("pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        RuntimeConfig(backend="jax", device="cpu")
    rt = BlasxRuntime(RuntimeConfig(backend="torch", device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        BlasxContext(runtime=rt, backend="cuda")
    ref_fields = dataclasses.asdict(RefConfig())
    assert config_from_reference(ref_fields, device="cpu").backend == "numpy"
    with pytest.raises(ValueError, match="no counterpart"):
        config_from_reference(dict(ref_fields, backend="mosaic"),
                              device="cpu")
    rng = np.random.default_rng(6)
    A = rng.standard_normal((48, 32))
    B = rng.standard_normal((32, 40))
    with BlasxContext(backend="torch", device="cpu", tile=16) as ctx:
        out = ctx.gemm(A, B)
        st = ctx.stats()
        assert st["backend"] == "torch" and st["device"] == "cpu"
        assert st["launch"]["kernel_launches"] < st["launch"]["tasks"]
        np.testing.assert_allclose(out.array(), A @ B, rtol=1e-12)


def test_execute_false_skips_dispatch():
    """Metadata-only runs schedule and account but never launch."""
    rt = BlasxRuntime(port_cfg(ref_cfg("pallas", n_devices=2,
                                       execute=False)))
    blas3.shadow_run("gemm", 2048, tile=256, runtime=rt)
    ls = rt.launch_stats()
    assert ls["tasks"] > 0
    assert ls["kernel_launches"] == 0 and ls["steps"] == 0
