"""Reduce a ``torch.profiler`` trace of a stretch of calls.

The harness wraps each call in a span named :data:`SPAN`; the traced
window runs from the first span's start to the last span's end.  From
the device's activities inside it (kernels, copies, sets) come the busy
time, the copy time by direction, the time of each kernel, the time in
which a collective kernel runs and no other kernel does, and the idle
gaps, each put down to the innermost host operation of the calling
thread at its middle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPAN = "chipbench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "host: Python between operations"
# device-side ranges torch records for a collective beside its kernels
ANNOTATIONS = ("nccl:",)
TOP = 10


@dataclasses.dataclass(frozen=True)
class Ev:
    name: str
    kind: str
    start: int  # ns
    end: int    # ns
    thread: int = 0


def _kind_of(name: str, on_device: bool) -> str:
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if name == SPAN or name.startswith(ANNOTATIONS):
            return "gpu_user_annotation"
        return "kernel"
    if name == SPAN:
        return "user_annotation"
    if name.startswith("cuda"):
        return "cuda_runtime"
    return "cpu_op"


def events_of(prof) -> List[Ev]:
    """The profile's events, from the raw Kineto results where this
    torch has them, else from its function events."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    out: List[Ev] = []
    if raw is not None:
        for e in raw.events():
            name = e.name()
            on_device = e.device_type() != DeviceType.CPU
            kind = (e.activity_type() if hasattr(e, "activity_type")
                    else _kind_of(name, on_device))
            if on_device and name.startswith(ANNOTATIONS):
                kind = "gpu_user_annotation"
            if hasattr(e, "start_ns"):
                start = e.start_ns()
                end = e.end_ns() if hasattr(e, "end_ns") else \
                    start + e.duration_ns()
            else:
                start = int(e.start_us() * 1000)
                end = start + int(e.duration_us() * 1000)
            out.append(Ev(name, kind, int(start), int(end),
                          int(e.start_thread_id())))
        return out
    for fe in prof.events():
        on_device = fe.device_type != DeviceType.CPU
        out.append(Ev(fe.name, _kind_of(fe.name, on_device),
                      int(fe.time_range.start * 1000),
                      int(fe.time_range.end * 1000), int(fe.thread)))
    return out


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals covering the same points."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: Sequence[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in intervals)


def minus(a: Sequence[Tuple[int, int]],
          b: Sequence[Tuple[int, int]]) -> int:
    """Length of the points of merged ``a`` that merged ``b`` leaves
    uncovered."""
    total = 0
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            if cur >= e:
                break
            k += 1
        if cur < e:
            total += e - cur
    return total


def gaps(busy: Sequence[Tuple[int, int]], w0: int,
         w1: int) -> List[Tuple[int, int]]:
    """The stretches of [w0, w1] that merged ``busy`` leaves idle."""
    out = []
    cur = w0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(s, e) for s, e in out if e > s]


def attribute(idle: Sequence[Tuple[int, int]],
              host: Sequence[Ev]) -> Dict[str, int]:
    """Idle ns by the innermost host event holding each gap's middle."""
    ordered = sorted(host, key=lambda ev: (ev.start, -ev.end))
    out: Dict[str, int] = {}
    stack: List[Ev] = []
    j = 0
    for mid, span in sorted(((s + e) // 2, e - s) for s, e in idle):
        while j < len(ordered) and ordered[j].start <= mid:
            ev = ordered[j]
            while stack and stack[-1].end < ev.start:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else NO_HOST_OP
        out[name] = out.get(name, 0) + span
    return out


def _copy_direction(name: str) -> str:
    for d in ("HtoD", "DtoH", "DtoD", "PtoP", "HtoH"):
        if d in name:
            return d
    return "other"


def _top(table: Dict[str, int], n: int = TOP) -> List[list]:
    return [[k, v / 1e9] for k, v in
            sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def reduce(events: Sequence[Ev], span: str = SPAN) -> Optional[dict]:
    """The traced window's summary in seconds, or None when the trace
    holds no span of the harness."""
    spans = [e for e in events if e.name == span
             and e.kind not in DEVICE_KINDS
             and e.kind != "gpu_user_annotation"]
    if not spans:
        return None
    w0 = min(e.start for e in spans)
    w1 = max(e.end for e in spans)
    thread = spans[0].thread
    device = [Ev(e.name, e.kind, max(e.start, w0), min(e.end, w1), e.thread)
              for e in events
              if e.kind in DEVICE_KINDS and e.end > w0 and e.start < w1]
    busy = union((e.start, e.end) for e in device)
    kernels: Dict[str, List[float]] = {}
    copies: Dict[str, int] = {}
    by_op: Dict[str, int] = {}
    for e in device:
        d = e.end - e.start
        by_op[e.name] = by_op.get(e.name, 0) + d
        if e.kind == "kernel":
            k = kernels.setdefault(e.name, [0, 0])
            k[0] += d
            k[1] += 1
        elif e.kind == "gpu_memcpy":
            c = _copy_direction(e.name)
            copies[c] = copies.get(c, 0) + d
    nccl = union((e.start, e.end) for e in device
                 if e.kind == "kernel" and "nccl" in e.name.lower())
    compute = union((e.start, e.end) for e in device
                    if e.kind == "kernel" and "nccl" not in e.name.lower())
    host = [e for e in events if e.thread == thread
            and e.kind in HOST_KINDS and e.end > w0 and e.start < w1]
    idle = attribute(gaps(busy, w0, w1), host)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": length(busy) / 1e9,
        "spans": len(spans),
        "kernels": {k: [v[0] / 1e9, v[1]] for k, v in kernels.items()},
        "copy_s": {k: v / 1e9 for k, v in copies.items()},
        "exposed_comm_s": minus(nccl, compute) / 1e9,
        "device_ops": _top(by_op),
        "idle_gaps": _top(idle),
    }


def kernel_seconds(summary: dict, pattern) -> float:
    """Total device seconds of the kernels whose name ``pattern`` (a
    compiled regular expression) finds."""
    return sum(s for name, (s, _) in summary["kernels"].items()
               if pattern.search(name))


class Tracer:
    """``torch.profiler`` over a stretch of calls, each inside
    :meth:`span`; :meth:`summary` reduces it."""

    def __init__(self, device: str):
        self.cuda = device.split(":")[0] == "cuda"
        self._prof = None

    def warm(self) -> None:
        """One short session first: a first session taken after much
        untraced work has come back empty on an H100."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        if not self.cuda:
            return
        x = torch.ones(1024, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            (x * 2).sum().item()

    def __enter__(self) -> "Tracer":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    @staticmethod
    def span():
        from torch.profiler import record_function
        return record_function(SPAN)

    def summary(self) -> Optional[dict]:
        return reduce(events_of(self._prof))

