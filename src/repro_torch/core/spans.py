"""Named spans at the layer boundaries of the port's GEMM paths and of
DeepSeek-V3's MLA and MoE layers.

``span(name)`` records ``name`` while a torch profiler runs and is one
shared ``contextlib.nullcontext()`` otherwise, so a call made with no
profiler pays one flag read a span.  Under a profiler the spans land in
the same Kineto trace as the kernels and copies they launch: they share
the device trace's clock, and each device activity is tied to the span
that launched it through the correlation id of its launch.

A span is recorded as an operator (``torch._C._profiler.
_RecordFunctionFast``), not as ``torch.profiler.record_function``'s user
annotation: torch copies a user annotation onto the device as a range
over the kernels launched inside it, and a trace reader that cannot
tell those ranges from kernels (a torch without ``activity_type`` on
its raw events) would count them as device work.

The module reads no clock, keeps nothing and writes nothing; any
``torch.profiler`` session reads the spans.  Every name starts with
:data:`PREFIX`:

  ``blasx.gemm.prep``        operand padding, slicing and widening
  ``blasx.gemm.gather``      the gathers of C and their slices
  ``blasx.gemm.out``         a fresh output matrix (``BlasxContext``)
  ``blasx.ring.block``       one local product of a ring
  ``blasx.ring.hop``         one posted ring hop (its send and receive)
  ``blasx.ring.wait``        the wait for a hop
  ``blasx.ring.accumulate``  a ring's running sum and its final cast
  ``blasx.rt.plan``          taskization and the runtime's planners
  ``blasx.rt.gather``        a batch's tile acquisition and copies in
  ``blasx.rt.dispatch``      a batch's backend group calls
  ``blasx.rt.finalize``      a batch's epilogues and write-back
  ``blasx.mla.prefill``      MLA's prefill attention: K and V expanded
                             from the latent, causal attention
  ``blasx.mla.decode``       MLA's absorbed decode attention: the cache
                             write and the attention over the latent
  ``blasx.moe.route``        DeepSeek-V3's router (``held_moe_block``)
  ``blasx.moe.experts``      the held experts on their routed tokens:
                             the slot layout on the device and the two
                             grouped products (no host read)
  ``blasx.moe.shared``       the shared expert
"""
from __future__ import annotations

import contextlib

import torch
# the module, not its flag: the profiler rebinds the flag on start and
# stop, so a name imported once would never change
from torch.autograd import profiler as _profiler

PREFIX = "blasx."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` under a running torch
    profiler and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
