"""Scheduler-policy invariant matrix of the port, against the reference.

Twins of ``test_scheduler_matrix.py``: for every policy x execution mode
the knobs the policy claims to disable really stay off in the port's
runtime (no steals without stealing, no P2P traffic without the L2
cache, 2 streams under cublasxt), static splits cover every task exactly
once and as the reference splits them, and the traced schedules show
the stream caps.  Both packages run the numpy backend (the port's on the
host), so outputs are held bitwise and sim ledgers exactly.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core import task as ref_task
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.core.tiling import TileGrid as RefGrid
from repro_torch.core import blas3
from repro_torch.core import task as taskmod
from repro_torch.core.runtime import (BlasxRuntime, RuntimeConfig,
                                      config_from_reference)
from repro_torch.core.tiling import TileGrid

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy while this module runs (the reason is
    in ``test_torch_precision.py``)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit is an economy, not a requirement
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


POLICIES = ("blasx", "parsec", "cublasxt", "static", "supermatrix")
MODES = ("sim", "threads")
N, TILE = 768, 128


def _pair(**kw):
    rc = RefConfig(**kw)
    return RefRuntime(rc), BlasxRuntime(
        config_from_reference(dataclasses.asdict(rc), device="cpu"))


@pytest.mark.parametrize("policy,mode",
                         list(itertools.product(POLICIES, MODES)))
def test_policy_invariant_matrix(policy, mode):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((N, N))
    B = rng.standard_normal((N, N))
    ref_rt, rt = _pair(n_devices=3, mode=mode, policy=policy,
                       cache_bytes=32 << 20)
    out = blas3.gemm(A, B, tile=TILE, runtime=rt)
    want = ref_blas3.gemm(A, B, tile=TILE, runtime=ref_rt)
    assert np.array_equal(out, want)
    np.testing.assert_allclose(out, A @ B, rtol=1e-10, atol=1e-10)
    if mode == "sim":
        assert rt.stats() == ref_rt.stats()
        assert rt.makespan() == ref_rt.makespan()
    cfg = rt.cfg
    ledgers = [d.ledger for d in rt.devices]
    n_tiles = (N // TILE) ** 2
    assert sum(led.tasks for led in ledgers) == n_tiles
    assert cfg.use_stealing == ref_rt.cfg.use_stealing
    assert cfg.use_l2 == ref_rt.cfg.use_l2
    if not cfg.use_stealing:
        assert sum(led.steals for led in ledgers) == 0
    if not cfg.use_l2:
        assert sum(led.d2d_bytes for led in ledgers) == 0
        assert all(led.d2d_busy_s == 0.0 for led in ledgers)
    if policy == "cublasxt":
        assert cfg.effective_streams == 2
    else:
        assert cfg.effective_streams == cfg.n_streams
    assert cfg.overlap == (policy != "supermatrix")


@pytest.mark.parametrize("policy", ["cublasxt", "static"])
def test_static_assignment_buckets_cover_every_task_exactly_once(policy):
    def buckets(mod, grid, runtime):
        ga, gb, gc = (grid("A", N, N, TILE), grid("B", N, N, TILE),
                      grid("C", N, N, TILE))
        tasks = mod.taskize_gemm(ga, gb, gc, "N", "N", 1.0, 0.0)
        queues = runtime._static_split(tasks)
        return tasks, [set(q._tasks.keys()) for q in queues]

    speeds = dict(speeds=[1.0, 0.5, 2.0], nominal_speeds=[1.0, 0.5, 2.0])
    ref_rt, rt = _pair(n_devices=3, mode="sim", policy=policy, **speeds)
    tasks, got = buckets(taskmod, TileGrid, rt)
    assert got == buckets(ref_task, RefGrid, ref_rt)[1]
    assert len(got) == 3
    all_ids = {t.task_id for t in tasks}
    assert set().union(*got) == all_ids
    assert sum(len(b) for b in got) == len(all_ids)
    if policy == "static":
        sizes = [len(b) for b in got]
        assert sizes[2] == max(sizes) and sizes[1] == min(sizes)
    else:
        for dev, bucket in enumerate(got):
            assert all(tid % 3 == dev for tid in bucket)


def _traced_policy_run(policy):
    """Two passes over persistent handles: the warm second pass is
    where stream concurrency peaks (no fetch stagger)."""
    from repro_torch.api import BlasxContext

    A = np.random.default_rng(3).standard_normal((1024, 1024))
    with BlasxContext(RuntimeConfig(n_devices=2, mode="sim", policy=policy,
                                    backend="numpy", device="cpu"),
                      tile=128) as ctx:
        Ah = ctx.tile(A)
        ctx.gemm(Ah, Ah)
        ctx.gemm(Ah, Ah)
        return ctx.trace(), ctx.cfg


def _ref_traced_policy_run(policy):
    from repro.api import BlasxContext as RefContext

    A = np.random.default_rng(3).standard_normal((1024, 1024))
    with RefContext(RefConfig(n_devices=2, mode="sim", policy=policy),
                    tile=128) as ctx:
        Ah = ctx.tile(A)
        ctx.gemm(Ah, Ah)
        ctx.gemm(Ah, Ah)
        return ctx.trace()


def test_cublasxt_trace_shows_at_most_two_concurrent_computes():
    from repro.core.events import max_concurrent as ref_max_concurrent
    from repro_torch.core.events import max_concurrent, validate_trace

    tr, _ = _traced_policy_run("cublasxt")
    validate_trace(tr)
    ref_tr = _ref_traced_policy_run("cublasxt")
    for dev in range(2):
        assert max_concurrent(tr, device=dev) <= 2
        assert max_concurrent(tr, device=dev) == \
            ref_max_concurrent(ref_tr, device=dev)


def test_blasx_trace_reaches_full_stream_width():
    from repro.core.events import max_concurrent as ref_max_concurrent
    from repro_torch.core.events import max_concurrent, validate_trace

    tr, cfg = _traced_policy_run("blasx")
    validate_trace(tr)
    widths = [max_concurrent(tr, device=d) for d in range(2)]
    assert max(widths) >= cfg.n_streams
    ref_tr = _ref_traced_policy_run("blasx")
    assert widths == [ref_max_concurrent(ref_tr, device=d) for d in range(2)]
