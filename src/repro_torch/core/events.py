"""Discrete-event multi-stream timing engine (sim mode).

The seed engine modeled a device batch as a single lump —
``max(compute_s, comm_s)`` — so stream concurrency, H2D/P2P pipelining
and host-link contention were asserted by formula, never simulated.
This module replaces the lump with a deterministic discrete-event
schedule over explicit *resources*:

* **stream timelines** — each device owns ``effective_streams`` lanes;
  one task of a batch runs on one lane (fetch -> compute -> write-back
  in program order), so concurrent tasks overlap exactly where their
  per-lane chains allow it;
* **link timelines** — per-device H2D, D2D (P2P), D2H and (pod tier)
  ICI lanes.  With
  ``RuntimeConfig.shared_host_link`` every device's H2D (and D2H)
  transfers serialize on ONE host lane per direction at full link
  bandwidth — the paper's "cuBLAS-XT overloads the PCI-E" contention
  emerges from the schedule instead of a bandwidth divide.

Every tile fetch, compute span (one task's backend dispatch share) and
MESI-X write-back becomes a :class:`Span` on a ``(device, lane)``
timeline.  Overlap, stalls and the 2-stream-vs-4-stream policy gap are
*observed* properties of the resulting timeline; the numerics path is
untouched (the engine only assigns clocks — see the bitwise parity
suite in ``tests/test_events.py``).

Determinism: link requests are honored in scheduler issue order (the
sim loop's earliest-free-device order), i.e. deterministic list
scheduling.  ``Date``-free, RNG-free — the same run always produces
the same timeline.

The recorded timeline exports as Chrome-trace JSON
(``chrome://tracing`` / https://ui.perfetto.dev): one *process* per
device, one *thread* per stream/link lane, balanced ``B``/``E`` event
pairs.  :func:`validate_trace` is the schema gate used by tests and
the CI bench-smoke job (CLI:
``python -m benchmarks.overlap --validate trace.json``).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

# lane ids within one device's trace process: streams are 0..n-1, links
# get fixed high ids so stream count never collides with them
LANE_H2D = 100
LANE_D2D = 101
LANE_D2H = 102
LANE_ICI = 103  # pod tier: inter-chip ring hops of a mesh_shard device
LINK_LANES = {"h2d": LANE_H2D, "d2d": LANE_D2D, "d2h": LANE_D2H,
              "ici": LANE_ICI}

TRACE_SCHEMA = 1
# recording cap: a runaway metadata-scale session stops *recording*
# (never stops timing); the trace metadata flags the truncation
MAX_TRACE_SPANS = 1_000_000


@dataclasses.dataclass(frozen=True)
class TimedXfer:
    """One modeled transfer: direction, payload and link seconds.

    ``src`` names the *serving* device of a P2P (d2d) or neighbor-tier
    (ici) transfer; the engine then reserves the server's egress lane,
    so contention lands on the device actually being drained.  ``-1``
    (h2d/d2h, or legacy callers) keeps the transfer on the requester's
    own lane."""

    kind: str       # "h2d" | "d2d" | "d2h" | "ici"
    nbytes: int
    secs: float
    label: str = ""
    src: int = -1   # serving device of a d2d/ici transfer (-1 = requester)


@dataclasses.dataclass
class TimedTask:
    """Timing raw material for one task of a device batch: the gather
    phase's fetches, the task's compute share of the batch dispatch,
    and the finalize phase's write-back."""

    task_id: int
    name: str
    compute_s: float
    fetches: Sequence[TimedXfer]
    writeback: Optional[TimedXfer] = None
    routine: str = ""
    steps: int = 0
    flops: int = 0
    kind: str = "owner"  # owner | partial | fixup (work-centric mode)
    parent: Optional[int] = None  # partial's owner task (fix-up keeps it)


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed interval on a (device, lane) timeline (seconds)."""

    device: int
    lane: int
    cat: str        # "compute" | "h2d" | "d2d" | "d2h"
    name: str
    start: float
    dur: float
    nbytes: int = 0
    task_id: int = -1
    kind: str = ""  # task kind of a compute span ("" for transfers)
    parent: Optional[int] = None  # owner task of a partial's span


class LinkTimeline:
    """A serially-reusable transfer resource.  ``acquire`` grants the
    earliest idle slot at or after the request time — contending
    transfers serialize, and a short transfer requested at an earlier
    virtual time *backfills* idle gaps left by already-reserved later
    slots (the sim loop issues batches in earliest-free-device order,
    not global virtual-time order, so gaps are a scheduling artifact,
    not link idleness).  Reservations are kept as disjoint, coalesced
    intervals; back-to-back grants merge, so the list stays short."""

    __slots__ = ("_busy", "busy_s")

    def __init__(self) -> None:
        self._busy: List[List[float]] = []  # sorted disjoint [start, end)
        self.busy_s = 0.0

    def acquire(self, t_req: float, dur: float) -> float:
        self.busy_s += dur
        start = t_req
        iv = self._busy
        i = bisect.bisect_right(iv, [start, float("inf")])
        if i > 0 and iv[i - 1][1] > start:
            start = iv[i - 1][1]
        while i < len(iv) and iv[i][0] < start + dur:
            start = iv[i][1]
            i += 1
        end = start + dur
        # coalesce with exact-touching neighbours
        if i > 0 and iv[i - 1][1] == start:
            iv[i - 1][1] = end
            if i < len(iv) and iv[i][0] == end:
                iv[i - 1][1] = iv[i][1]
                del iv[i]
        elif i < len(iv) and iv[i][0] == end:
            iv[i][0] = start
        else:
            iv.insert(i, [start, end])
        return start


def _processor_sharing(arrivals: Sequence[float],
                       works: Sequence[float]) -> List[float]:
    """Finish times of compute jobs under egalitarian processor
    sharing: job ``i`` arrives at ``arrivals[i]`` with ``works[i]``
    seconds of solo work; ``k`` concurrently-active jobs each progress
    at rate ``1/k``.  Models ``n_streams`` kernels co-resident on one
    device: their spans genuinely overlap in time while aggregate
    throughput stays at the device rate (a same-arrival batch finishes
    exactly when the serial sum would)."""
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i])
    finish = [0.0] * len(arrivals)
    remaining: Dict[int, float] = {}
    t = 0.0
    idx = 0
    while idx < len(order) or remaining:
        if not remaining:
            t = arrivals[order[idx]]
        while idx < len(order) and arrivals[order[idx]] <= t:
            j = order[idx]
            if works[j] <= 0.0:
                finish[j] = arrivals[j]  # no compute: instant
            else:
                remaining[j] = works[j]
            idx += 1
        if not remaining:
            continue
        k = len(remaining)
        next_arrival = arrivals[order[idx]] if idx < len(order) else None
        m = min(remaining.values())
        t_done = t + m * k
        if next_arrival is not None and next_arrival < t_done:
            dt = (next_arrival - t) / k
            for j in remaining:
                remaining[j] = max(0.0, remaining[j] - dt)
            t = next_arrival
            continue
        # subtract in *work* units (not via t_done - t, which loses
        # precision and can leave the min job fractionally unfinished
        # forever): the min job(s) land on exactly zero and complete
        for j in list(remaining):
            rem = remaining[j] - m
            if rem <= 0.0:
                finish[j] = t_done
                del remaining[j]
            else:
                remaining[j] = rem
        t = t_done
    return finish


class EventEngine:
    """Owns every stream/link timeline of one runtime session plus the
    recorded span list.  One instance per :class:`BlasxRuntime` in sim
    mode with ``time_model="events"``."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        n = cfg.n_devices
        if cfg.shared_host_link:
            # one host lane per direction, shared by every device: H2D
            # transfers contend with each other (and D2H with D2H),
            # full duplex across directions — paper Table IV's
            # "bidirectional" measured link
            shared_h2d, shared_d2h = LinkTimeline(), LinkTimeline()
            self._h2d = [shared_h2d] * n
            self._d2h = [shared_d2h] * n
        else:
            self._h2d = [LinkTimeline() for _ in range(n)]
            self._d2h = [LinkTimeline() for _ in range(n)]
        # P2P rides dedicated switch lanes: per-device, no cross-device
        # contention (cfg comment in runtime.RuntimeConfig)
        self._d2d = [LinkTimeline() for _ in range(n)]
        # pod tier: per-device ICI links (a mesh_shard device's ring
        # hops and neighbor-tier fetches); dedicated point-to-point
        # fabric, so no cross-device contention either
        self._ici = [LinkTimeline() for _ in range(n)]
        self.spans: List[Span] = []
        self.truncated = False
        self.record = bool(getattr(cfg, "record_trace", True))

    # ------------------------------------------------------------- helpers
    def _link(self, kind: str, device: int) -> LinkTimeline:
        return {"h2d": self._h2d, "d2d": self._d2d,
                "d2h": self._d2h, "ici": self._ici}[kind][device]

    def _emit(self, device: int, lane: int, cat: str, name: str,
              start: float, dur: float, nbytes: int = 0,
              task_id: int = -1, kind: str = "",
              parent: Optional[int] = None) -> None:
        if not self.record:
            return
        if len(self.spans) >= MAX_TRACE_SPANS:
            self.truncated = True
            return
        self.spans.append(Span(device=device, lane=lane, cat=cat,
                               name=name, start=start, dur=dur,
                               nbytes=nbytes, task_id=task_id, kind=kind,
                               parent=parent))

    # ----------------------------------------------------------- schedule
    def schedule_batch(self, device: int, start: float,
                       items: Sequence[TimedTask], n_streams: int,
                       overlap: bool
                       ) -> Tuple[float, List[float], Dict[str, float]]:
        """Schedule one device batch starting at ``start``.

        With ``overlap`` each task runs on its own stream lane
        (``len(items) <= n_streams``, Alg. 1's ``take_top``): its
        fetches serialize on the link lanes, its compute span occupies
        the stream, its write-back rides the D2H lane.  Concurrent
        compute spans *share the device* — streams buy
        communication/computation overlap, not extra FLOPS — so
        compute progresses under egalitarian processor sharing: ``k``
        simultaneously-active tasks each run at ``1/k`` of the device
        rate (a warm 4-task batch shows 4 fully-overlapped compute
        spans whose common end equals the serial sum, exactly the lump
        model's compute-bound duration).  Without ``overlap`` (the
        fork-join supermatrix baseline) the whole batch chains on a
        single lane, so communication never hides behind compute.

        Returns ``(span, per-task finish times, per-kind link busy
        seconds charged by this batch)``.
        """
        busy = {"h2d": 0.0, "d2d": 0.0, "d2h": 0.0, "ici": 0.0}
        if not overlap:
            # fork-join: fetch -> compute -> write-back, task after
            # task, all on lane 0 — nothing ever hides behind compute
            finishes = []
            cursor = start
            for item in items:
                for x in item.fetches:
                    if x.secs <= 0.0:
                        continue
                    s = self._xfer(device, x, cursor, busy, item.task_id)
                    cursor = s + x.secs
                if item.compute_s > 0.0:
                    self._emit(device, 0, "compute", item.name, cursor,
                               item.compute_s, task_id=item.task_id,
                               kind=item.kind, parent=item.parent)
                    cursor += item.compute_s
                wb = item.writeback
                if wb is not None and wb.secs > 0.0:
                    s = self._xfer(device, wb, cursor, busy, item.task_id)
                    cursor = s + wb.secs
                finishes.append(cursor)
            span = max(finishes, default=start) - start
            return span, finishes, busy
        n_lanes = max(1, n_streams)
        arrivals: List[float] = []
        for item in items:
            cursor = start
            for x in item.fetches:
                if x.secs <= 0.0:
                    continue  # warm-cache hit: no transfer, no event
                s = self._xfer(device, x, cursor, busy, item.task_id)
                cursor = s + x.secs
            arrivals.append(cursor)
        compute_end = _processor_sharing(
            arrivals, [it.compute_s for it in items])
        finishes = []
        for idx, item in enumerate(items):
            if item.compute_s > 0.0:
                self._emit(device, idx % n_lanes, "compute", item.name,
                           arrivals[idx], compute_end[idx] - arrivals[idx],
                           task_id=item.task_id, kind=item.kind,
                           parent=item.parent)
            cursor = compute_end[idx]
            wb = item.writeback
            if wb is not None and wb.secs > 0.0:
                s = self._xfer(device, wb, cursor, busy, item.task_id)
                cursor = s + wb.secs
            finishes.append(cursor)
        span = max(finishes, default=start) - start
        return span, finishes, busy

    def _xfer(self, device: int, x: TimedXfer, cursor: float,
              busy: Dict[str, float], task_id: int) -> float:
        """Acquire the link for one transfer, charge busy seconds and
        emit its span; returns the granted start time.

        A d2d (or neighbor-tier ici) transfer with a known source rides
        the *serving* device's egress lane (and its span lands on that
        device's track in the trace): one over-popular holder now
        serializes its peers' fetches, which is exactly the drain the
        LRU peer rotation in ``MesixDirectory.peer_holder`` spreads
        out.  The busy-seconds charge stays with the requesting
        device's ledger — it is the one whose task waited on the
        wire."""
        lane_dev = (x.src if (x.kind in ("d2d", "ici") and x.src >= 0)
                    else device)
        s = self._link(x.kind, lane_dev).acquire(cursor, x.secs)
        busy[x.kind] += x.secs
        self._emit(lane_dev, LINK_LANES[x.kind], x.kind,
                   f"{x.kind} {x.label}", s, x.secs, x.nbytes, task_id)
        return s

    # -------------------------------------------------------------- trace
    def chrome_trace(self, extra: Optional[Dict[str, object]] = None) -> dict:
        """Chrome-trace (chrome://tracing / Perfetto) JSON of the
        recorded timeline: balanced B/E pairs, one process per device,
        one thread per stream/link lane, microsecond timestamps."""
        return build_chrome_trace(
            self.spans, self.cfg.n_devices, self.cfg.effective_streams,
            truncated=self.truncated, extra=extra)


def build_chrome_trace(spans: Sequence[Span], n_devices: int,
                       n_streams: int, truncated: bool = False,
                       extra: Optional[Dict[str, object]] = None) -> dict:
    lane_names = {i: f"stream{i}" for i in range(n_streams)}
    lane_names.update({v: k for k, v in LINK_LANES.items()})
    events: List[dict] = []
    for dev in range(n_devices):
        events.append({"ph": "M", "name": "process_name", "pid": dev,
                       "tid": 0, "args": {"name": f"device{dev}"}})
        for lane, lname in sorted(lane_names.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": dev,
                           "tid": lane, "args": {"name": lname}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": dev, "tid": lane,
                           "args": {"sort_index": lane}})
    # per-lane chronological emission keeps each (pid, tid) sequence
    # monotonic with properly nested B/E pairs (a lane never overlaps
    # itself: streams run one task chain, links are serially reusable)
    by_lane: Dict[Tuple[int, int], List[Span]] = {}
    for sp in spans:
        by_lane.setdefault((sp.device, sp.lane), []).append(sp)
    for (dev, lane), lane_spans in sorted(by_lane.items()):
        for sp in sorted(lane_spans, key=lambda s: s.start):
            args: Dict[str, object] = {"task_id": sp.task_id}
            if sp.nbytes:
                args["nbytes"] = sp.nbytes
            if sp.kind:
                args["kind"] = sp.kind
            if sp.parent is not None:
                args["parent"] = sp.parent
            events.append({"name": sp.name, "cat": sp.cat, "ph": "B",
                           "ts": sp.start * 1e6, "pid": dev, "tid": lane,
                           "args": args})
            events.append({"name": sp.name, "cat": sp.cat, "ph": "E",
                           "ts": (sp.start + sp.dur) * 1e6, "pid": dev,
                           "tid": lane})
    meta: Dict[str, object] = {"schema": TRACE_SCHEMA,
                               "n_devices": n_devices,
                               "n_streams": n_streams,
                               "truncated": truncated}
    if extra:
        meta.update(extra)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


# ------------------------------------------------------------ validation
def validate_trace(trace: dict) -> Dict[str, object]:
    """Structural schema gate for an exported Chrome trace.

    Checks: top-level shape, required event fields, per-(pid, tid)
    monotonically non-decreasing timestamps, balanced and properly
    nested B/E pairs with matching names, and non-negative durations.
    Raises ``ValueError`` listing every violation; returns a summary
    dict (span/event counts, end timestamp) when the trace is valid.
    """
    problems: List[str] = []
    if not isinstance(trace, dict):
        raise ValueError("trace must be a JSON object")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace.traceEvents must be a list")
    other = trace.get("otherData")
    if not isinstance(other, dict) or other.get("schema") != TRACE_SCHEMA:
        problems.append(f"otherData.schema != {TRACE_SCHEMA}")
    stacks: Dict[Tuple[int, int], List[dict]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    n_spans = 0
    end_ts = 0.0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("B", "E", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i}: missing pid/tid")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: missing/non-numeric ts")
            continue
        lane = (ev["pid"], ev["tid"])
        if ts < last_ts.get(lane, 0.0) - 1e-9:
            problems.append(
                f"event {i}: ts {ts} not monotonic on pid={lane[0]} "
                f"tid={lane[1]} (last {last_ts[lane]})")
        last_ts[lane] = max(last_ts.get(lane, 0.0), ts)
        end_ts = max(end_ts, ts)
        stack = stacks.setdefault(lane, [])
        if ph == "B":
            if not ev.get("name"):
                problems.append(f"event {i}: B event without a name")
            stack.append(ev)
        else:  # E
            if not stack:
                problems.append(
                    f"event {i}: E without matching B on pid={lane[0]} "
                    f"tid={lane[1]}")
                continue
            b = stack.pop()
            if ev.get("name") not in (None, b.get("name")):
                problems.append(
                    f"event {i}: E name {ev.get('name')!r} != B name "
                    f"{b.get('name')!r}")
            if ts < b["ts"] - 1e-9:
                problems.append(f"event {i}: negative duration "
                                f"({b['ts']} -> {ts})")
            n_spans += 1
    for lane, stack in stacks.items():
        if stack:
            problems.append(f"{len(stack)} unbalanced B event(s) on "
                            f"pid={lane[0]} tid={lane[1]}")
    if problems:
        raise ValueError("invalid trace:\n  " + "\n  ".join(problems))
    return {"events": len(events), "spans": n_spans,
            "end_ts_us": end_ts, "lanes": len(last_ts)}


def trace_spans(trace: dict) -> List[dict]:
    """Reassemble ``{pid, tid, cat, name, start, end}`` spans from a
    validated trace's B/E pairs (test/analysis helper)."""
    out: List[dict] = []
    stacks: Dict[Tuple[int, int], List[dict]] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        elif ev.get("ph") == "E":
            stack = stacks.get((ev["pid"], ev["tid"]))
            if stack:
                b = stack.pop()
                args = b.get("args") or {}
                out.append({"pid": ev["pid"], "tid": ev["tid"],
                            "cat": b.get("cat"), "name": b.get("name"),
                            "start": b["ts"], "end": ev["ts"],
                            "kind": args.get("kind", ""),
                            "task_id": args.get("task_id", -1),
                            "parent": args.get("parent")})
    return out


def max_concurrent(trace: dict, device: Optional[int] = None,
                   cat: str = "compute") -> int:
    """Peak number of simultaneously-open ``cat`` spans (optionally on
    one device) — the observable stream-concurrency of a run."""
    edges: List[Tuple[float, int]] = []
    for sp in trace_spans(trace):
        if sp["cat"] != cat:
            continue
        if device is not None and sp["pid"] != device:
            continue
        if sp["end"] <= sp["start"]:
            continue
        edges.append((sp["start"], 1))
        edges.append((sp["end"], -1))
    # close before open at identical timestamps: touching spans do not
    # count as concurrent
    edges.sort(key=lambda e: (e[0], e[1]))
    peak = cur = 0
    for _, delta in edges:
        cur += delta
        peak = max(peak, cur)
    return peak


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI schema gate, fronted by
    ``python -m benchmarks.overlap --validate trace.json`` (running
    this module with ``-m`` directly works too, but trips a cosmetic
    runpy warning because the package imports it)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="repro_torch.core.events",
        description="validate an exported Chrome trace against the "
                    "event-engine schema")
    ap.add_argument("trace", help="path to a trace JSON file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    try:
        summary = validate_trace(trace)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    concurrency = {dev: max_concurrent(trace, device=dev)
                   for dev in range(trace["otherData"].get("n_devices", 0))}
    print(f"trace OK: {summary['spans']} spans / {summary['events']} "
          f"events across {summary['lanes']} lanes, ends at "
          f"{summary['end_ts_us']:.1f} us; peak concurrent compute "
          f"spans per device: {concurrency}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised by CI
    import sys

    sys.exit(main())
