"""The port's spans (``core/spans.py``) and its operand-prep counter.

Without a profiler a span is one shared null context and records
nothing; under a CPU ``torch.profiler`` the ring GEMM records its
phases, nested in the caller's span, on each of four gloo ranks
(``torch_ranks.run_ranks``), and a ``BlasxContext`` gemm records its
output, its planning and a gather / dispatch / finalize triple a batch
with the same ledger as without the profiler.  ``PREP_BYTES`` counts the
bytes of the new tensors the ring GEMM's operand prep makes.
"""
import contextlib
import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import BlasxContext
from repro_torch.core import spans
from repro_torch.core.runtime import RuntimeConfig
from torch_ranks import run_ranks

# prep twice: the GEMM pads and slices, then the ring pads and widens
RING_SPANS = {"blasx.gemm.prep": 2, "blasx.ring.block": 4,
              "blasx.ring.hop": 3, "blasx.ring.wait": 3,
              "blasx.ring.accumulate": 4, "blasx.gemm.gather": 1}

RANKS = """
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_mesh_for_devices
from torch.profiler import ProfilerActivity, profile, record_function

mesh = make_mesh_for_devices(4, 4, device="cpu")      # (data 1, model 4)
R = {}
gen = torch.Generator().manual_seed(5)
A = torch.randn((64, 128), generator=gen)
B = torch.randn((128, 96), generator=gen)

# no profiler: no record is made
made = []
real = torch._C._profiler._RecordFunctionFast


def counted(name, *args, **kw):
    made.append(name)
    return real(name, *args, **kw)


torch._C._profiler._RecordFunctionFast = counted
try:
    plain = D.distributed_gemm(A, B, mesh, mode="ring")
finally:
    torch._C._profiler._RecordFunctionFast = real
R["made_without_profiler"] = made

# under the profiler, inside the caller's span
with profile(activities=[ProfilerActivity.CPU]) as prof:
    with record_function("caller"):
        traced = D.distributed_gemm(A, B, mesh, mode="ring")
R["same_result"] = bool(torch.equal(plain, traced))
R["spans"] = [(e.name, e.time_range.start, e.time_range.end, e.thread)
              for e in prof.events()
              if e.name == "caller" or e.name.startswith("blasx.")]
# recorded as operators, not as user annotations
R["kinds"] = sorted({e.activity_type()
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("blasx.")})

# PREP_BYTES: an even shape, a ragged one, an operand handed on as it
# is, a widening, and the reset
D.reset_collectives()
D.distributed_gemm(A, B, mesh, mode="ring")
R["prep_even"] = D.PREP_BYTES
D.reset_collectives()
R["prep_reset"] = D.PREP_BYTES
D.distributed_gemm(A[:61, :99], B[:99], mesh, mode="ring")
R["prep_ragged"] = D.PREP_BYTES
group = mesh.get_group("model")
D.reset_collectives()
D.ring_reduce_scatter_matmul(A[:, :32], B[:32], group)
R["prep_unchanged"] = D.PREP_BYTES
D.reset_collectives()
D.ring_reduce_scatter_matmul(A[:, :32].bfloat16(), B[:32].bfloat16(),
                             group)
R["prep_widened"] = D.PREP_BYTES
with open(os.path.join(OUT, f"spans.{RANK}.json"), "w") as f:
    json.dump(R, f)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    run_ranks(d, 4, RANKS, name="spans")
    return [json.loads((d / f"spans.{r}.json").read_text())
            for r in range(4)]


def test_a_span_without_a_profiler_is_the_one_null_context():
    first, second = spans.span("blasx.ring.block"), spans.span("blasx.x")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans.span("blasx.ring.block")
    assert isinstance(on, torch._C._profiler._RecordFunctionFast)
    assert spans.span("blasx.ring.block") is first


def test_the_ring_records_nothing_without_a_profiler(ranks):
    for r in ranks:
        assert r["made_without_profiler"] == []
        assert r["same_result"]


def test_the_ring_records_each_phase_nested_in_the_caller(ranks):
    for rank, r in enumerate(ranks):
        (_, c0, c1, thread), = [s for s in r["spans"] if s[0] == "caller"]
        mine = [s for s in r["spans"] if s[0] != "caller"]
        counts = {}
        for name, start, end, th in mine:
            counts[name] = counts.get(name, 0) + 1
            assert th == thread and c0 <= start <= end <= c1, (rank, name)
        assert counts == RING_SPANS, rank
        # torch copies a user annotation onto the device as a range over
        # its kernels; an operator it does not
        assert r["kinds"] == ["cpu_op"], rank


def test_prep_bytes_count_the_new_operands(ranks):
    f32 = 4
    for r in ranks:
        # A is padded (by nothing) into a new tensor; B goes as it is
        assert r["prep_even"] == 64 * 128 * f32
        assert r["prep_reset"] == 0
        # (61, 99) @ (99, 96) on a ring of 4: K pads to 100, so A to
        # (61, 100) and B to (100, 96); each rank's (61, 25) block of A
        # then pads to the ring's 64 rows
        assert r["prep_ragged"] == (61 * 100 + 100 * 96 + 64 * 25) * f32
        assert r["prep_unchanged"] == 0
        # bf16 operands are widened to f32 once: (64, 32) and (32, 96)
        assert r["prep_widened"] == (64 * 32 + 32 * 96) * f32


def _context():
    return BlasxContext(RuntimeConfig(device="cpu", cache_bytes=1 << 26),
                        tile=32)


def _ids_by_order(text: str) -> str:
    """``text`` with each matrix id renamed by its first appearance, so
    two contexts' records compare."""
    names = {}
    return re.sub(r"\bM\d+\b",
                  lambda m: names.setdefault(m.group(0), f"M#{len(names)}"),
                  text)


def _run_gemm(ctx, a, b):
    batches = []
    inner = ctx.runtime._execute_batch

    def counted(*args, **kw):
        batches.append(1)
        return inner(*args, **kw)

    ctx.runtime._execute_batch = counted
    out = ctx.gemm(a, b)
    return out.tiled.data.clone(), len(batches)


def test_a_context_gemm_records_its_phases_and_the_same_ledger():
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((96, 80), generator=gen, dtype=torch.float64)
    b = torch.randn((80, 64), generator=gen, dtype=torch.float64)
    with _context() as plain_ctx:
        plain, plain_batches = _run_gemm(plain_ctx, a, b)
        plain_rec = plain_ctx.last_call
        plain_stats = plain_ctx.stats()
        plain_trace = plain_ctx.trace()
    with _context() as ctx:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out, batches = _run_gemm(ctx, a, b)
        counts = {}
        for e in prof.events():
            if e.name.startswith(spans.PREFIX):
                counts[e.name] = counts.get(e.name, 0) + 1
        assert batches > 1
        # taskization in the context and the runtime's planners
        assert counts == {"blasx.gemm.out": 1, "blasx.rt.plan": 2,
                          "blasx.rt.gather": batches,
                          "blasx.rt.dispatch": batches,
                          "blasx.rt.finalize": batches}
        assert torch.equal(out, plain)
        assert batches == plain_batches
        assert ctx.last_call == plain_rec
        assert ctx.stats() == plain_stats
        assert (_ids_by_order(json.dumps(ctx.trace(), sort_keys=True))
                == _ids_by_order(json.dumps(plain_trace, sort_keys=True)))
