"""Reduce the program's own spans in a ``torch.profiler`` trace.

The port names the phases of its GEMM paths by spans whose names start
with :data:`PREFIX` (``repro_torch/core/spans.py``).  Here every device
activity of the traced window (kernel, copy, set) is tied to the
innermost program span that launched it: the activity's correlation id
names its launch, a CUDA runtime or driver call on the host, and the
launch's start falls inside the spans of its thread.  The window is the
harness's, as in :mod:`trace`.  For each span name:

  ``count``       spans that start in the window
  ``self_s``      host time: each span's length less its child spans'
  ``device_s``    device time of the activities launched innermost in it
  ``alone_s``     the part of its activities' time that no activity
                  launched in another program span overlaps
  ``device_ops``  its activities' device time by name, the largest first
  ``by_call``     [self_s, device_s] of each call in turn (the harness
                  span that holds the span's start)

and for the window: ``outside_s``, the device time launched inside no
program span (or whose launch the trace lacks), and ``idle_gaps``, the
idle gaps put down to the innermost program span of the calling thread
at each gap's middle, by ``trace.attribute``.  Times are in seconds.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

from . import trace

PREFIX = "blasx."
NO_SPAN = "no program span"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
TOP = 5


@dataclasses.dataclass(frozen=True)
class SpanEv:
    name: str
    kind: str
    start: int  # ns
    end: int    # ns
    thread: int = 0
    corr: int = 0


def _kind_of(name: str, on_device: bool) -> str:
    """The activity kind where the profile does not say it."""
    if name.startswith(PREFIX) or name == trace.SPAN:
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device and name.startswith("cu"):
        return "cuda_runtime"
    return trace._kind_of(name, on_device)


def events_of(prof) -> List[SpanEv]:
    """The profile's raw Kineto events with their correlation ids (none
    where this torch keeps no raw results)."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return []
    out = []
    for e in raw.events():
        name = e.name()
        on_device = e.device_type() != DeviceType.CPU
        kind = (e.activity_type() if hasattr(e, "activity_type")
                else _kind_of(name, on_device))
        if hasattr(e, "start_ns"):
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else \
                start + e.duration_ns()
        else:
            start = int(e.start_us() * 1000)
            end = start + int(e.duration_us() * 1000)
        out.append(SpanEv(name, kind, int(start), int(end),
                          int(e.start_thread_id()), int(e.correlation_id())))
    return out


def innermost(spans: Sequence[SpanEv],
              points: Sequence[int]) -> List[Optional[SpanEv]]:
    """For each point, the innermost of the (nested) ``spans`` that
    holds it, [start, end), or None."""
    ordered = sorted(spans, key=lambda s: (s.start, -s.end))
    out: List[Optional[SpanEv]] = [None] * len(points)
    stack: List[SpanEv] = []
    j = 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(ordered) and ordered[j].start <= t:
            while stack and stack[-1].end <= ordered[j].start:
                stack.pop()
            stack.append(ordered[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def self_times(spans: Sequence[SpanEv]) -> Dict[SpanEv, int]:
    """Each (nested) span's length less the lengths of its children:
    the time in which it is the innermost span, summed over the
    stretches between the spans' ends, in each of which one span is
    innermost throughout."""
    own = {s: 0 for s in spans}
    edges = sorted({t for s in spans for t in (s.start, s.end)})
    for (t0, t1), s in zip(zip(edges, edges[1:]),
                           innermost(spans, edges[:-1])):
        if s is not None:
            own[s] += t1 - t0
    return own


def reduce(events: Sequence[SpanEv],
           window: str = trace.SPAN) -> Optional[dict]:
    """The program's spans over the window of the harness's ``window``
    spans, or None when the trace holds none."""
    calls = [e for e in events if e.name == window
             and e.kind not in trace.DEVICE_KINDS
             and e.kind != "gpu_user_annotation"]
    if not calls:
        return None
    w0 = min(e.start for e in calls)
    w1 = max(e.end for e in calls)
    caller = calls[0].thread
    host = [e for e in events if e.name.startswith(PREFIX)
            and e.kind not in trace.DEVICE_KINDS
            and e.kind != "gpu_user_annotation"]
    by_thread: Dict[int, List[SpanEv]] = {}
    for e in host:
        by_thread.setdefault(e.thread, []).append(e)
    launches = {e.corr: e for e in events if e.kind in LAUNCH_KINDS}
    device = [e for e in events if e.kind in trace.DEVICE_KINDS
              and e.end > w0 and e.start < w1]

    # each activity's span: that of its launch
    owner: List[Optional[SpanEv]] = [None] * len(device)
    asks: Dict[int, List[int]] = {}
    for i, e in enumerate(device):
        launch = launches.get(e.corr)
        if launch is not None:
            asks.setdefault(launch.thread, []).append(i)
    for thread, idx in asks.items():
        found = innermost(by_thread.get(thread, []),
                          [launches[device[i].corr].start for i in idx])
        for i, s in zip(idx, found):
            owner[i] = s

    call_starts = sorted(e.start for e in calls)
    names: Dict[str, dict] = {}

    def entry(span: SpanEv) -> tuple:
        """The span's row and its call's [self_s, device_s]."""
        row = names.setdefault(span.name, {
            "count": 0, "self_s": 0.0, "device_s": 0.0, "alone_s": 0.0,
            "device_ops": {}, "by_call": [[0.0, 0.0] for _ in calls]})
        call = max(0, bisect.bisect_right(call_starts, span.start) - 1)
        return row, row["by_call"][call]

    for thread_spans in by_thread.values():
        for s, own in self_times(thread_spans).items():
            if w0 <= s.start < w1:
                row, at = entry(s)
                row["count"] += 1
                row["self_s"] += own / 1e9
                at[0] += own / 1e9
    spans_of: Dict[str, List[tuple]] = {}
    outside = 0
    for e, span in zip(device, owner):
        s, t = max(e.start, w0), min(e.end, w1)
        if span is None:
            outside += t - s
            continue
        row, at = entry(span)
        row["device_s"] += (t - s) / 1e9
        at[1] += (t - s) / 1e9
        row["device_ops"][e.name] = row["device_ops"].get(e.name, 0) + t - s
        spans_of.setdefault(span.name, []).append((s, t))
    for name, intervals in spans_of.items():
        others = trace.union(iv for other, ivs in spans_of.items()
                             if other != name for iv in ivs)
        names[name]["alone_s"] = trace.minus(trace.union(intervals),
                                             others) / 1e9
    for row in names.values():
        row["device_ops"] = trace._top(row["device_ops"], TOP)

    busy = trace.union((max(e.start, w0), min(e.end, w1)) for e in device)
    # the harness's own rule, over the program's spans alone
    idle_at = {NO_SPAN if k == trace.NO_HOST_OP else k: v
               for k, v in trace.attribute(trace.gaps(busy, w0, w1),
                                           by_thread.get(caller, [])).items()}
    return {
        "calls": len(calls),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": trace.length(busy) / 1e9,
        "outside_s": outside / 1e9,
        "names": names,
        "idle_gaps": trace._top(idle_at, len(idle_at)),
    }


def per_call(spans: dict) -> Dict[str, float]:
    """The ring's phases a call, in ms, from one rank's reduction: the
    hops' device time that no other phase's work hides, the result
    gather's and the operand prep's device time; and the share of the
    busy time launched inside no program span, in percent."""
    calls = spans["calls"]
    names = spans["names"]

    def ms(name: str, key: str) -> float:
        return names.get(name, {}).get(key, 0.0) / calls * 1e3

    return {
        "hop_exposed_ms_per_call": ms("blasx.ring.hop", "alone_s"),
        "gather_ms_per_call": ms("blasx.gemm.gather", "device_s"),
        "prep_ms_per_call": ms("blasx.gemm.prep", "device_s"),
        "outside_share_pct": (100.0 * spans["outside_s"] / spans["busy_s"]
                              if spans["busy_s"] > 0 else 0.0),
    }


class SpanTracer(trace.Tracer):
    """:class:`trace.Tracer` whose summary also holds the program's
    spans under ``"spans"``; its profiler options are the Tracer's."""

    def summary(self) -> Optional[dict]:
        s = super().summary()
        if s is not None:
            s["spans"] = reduce(events_of(self._prof))
        return s
