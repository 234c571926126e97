"""Low-overhead request-span tracer: a copy of
``swarmdb_tpu/obs/tracer.py``.

Closed spans with monotonic clocks go into per-thread ring buffers and
export as Chrome trace-event JSON (``GET /admin/trace/export``; load it in
https://ui.perfetto.dev). In this port the API routes, the runtime's
send / receive / broker publish, the serving service, the engine
(admission, prefill, decode chunks, host syncs), the lane supervisor and
the serving chaos harness record here.

- **Zero locks on record.** Each thread owns one ring; the only lock is
  taken once per thread lifetime, at ring registration. Readers take
  benign racy snapshots.
- **Bounded memory.** Rings are fixed-size (``SWARMDB_TRACE_RING``,
  default 4096 events per thread); old events are overwritten.
- **Monotonic time.** Spans carry ``time.monotonic_ns``; one (monotonic,
  epoch) anchor pair converts to wall time at export.
- **Two record APIs.** ``span(...)`` is a context manager for warm paths;
  hot paths use the allocation-free ``span_begin()`` / ``span_end()``.

``SWARMDB_TRACE=0`` disables recording (one attribute read and a branch).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple
from ..utils.sync import make_lock

__all__ = ["SpanTracer", "TRACER"]

# event tuple layout: (name, cat, rid, t0_ns, t1_ns, args-or-None)
_Event = Tuple[str, str, Optional[str], int, int, Optional[Dict[str, Any]]]


class _Ring:
    """Single-writer event ring owned by one thread."""

    __slots__ = ("events", "idx", "cap", "tid", "name")

    def __init__(self, cap: int, tid: int, name: str) -> None:
        self.events: List[Optional[_Event]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.tid = tid
        self.name = name

    def put(self, ev: _Event) -> None:
        self.events[self.idx % self.cap] = ev
        self.idx += 1

    def snapshot(self) -> List[_Event]:
        """Oldest-first copy (benign racy read from other threads)."""
        idx = self.idx
        events = list(self.events)  # one shot; writer may lap one slot
        if idx <= self.cap:
            out = events[:idx]
        else:
            cut = idx % self.cap
            out = events[cut:] + events[:cut]
        return [e for e in out if e is not None]


class _SpanCtx:
    """Tiny context manager for ``SpanTracer.span`` (warm paths only)."""

    __slots__ = ("_tracer", "_name", "_cat", "_rid", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 rid: Optional[str], args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._rid = rid
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.span_begin()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._tracer.span_end(self._t0, self._name, cat=self._cat,
                              rid=self._rid, args=self._args)


class SpanTracer:
    def __init__(self, capacity_per_thread: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        if capacity_per_thread is None:
            try:
                capacity_per_thread = int(
                    os.environ.get("SWARMDB_TRACE_RING", "4096"))
            except ValueError:
                capacity_per_thread = 4096
        if enabled is None:
            enabled = os.environ.get("SWARMDB_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        self.capacity = max(16, capacity_per_thread)
        # ring registry: (ring, weakref-to-owning-thread); mutated only
        # under _reg_lock (once per thread lifetime + resets)
        self._rings: List[Tuple[_Ring, "weakref.ref"]] = []
        self._reg_lock = make_lock("obs.tracer.SpanTracer._reg_lock")
        self._local = threading.local()
        # clock anchor: monotonic <-> epoch, captured together once
        self._anchor_mono_ns = time.monotonic_ns()
        self._anchor_epoch = time.time()

    # ------------------------------------------------------------ recording

    #: dead-thread rings retained (newest first): a short-lived thread's
    #: events (a retry timer, a one-shot chaos injector) survive into the
    #: next export; the cap bounds the registry under thread churn.
    _MAX_DEAD_RINGS = 32

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = _Ring(self.capacity, t.ident or 0, t.name)
            self._local.ring = ring
            with self._reg_lock:
                # bound the registry under thread churn WITHOUT dropping
                # recently dead threads' events: live rings always stay,
                # dead rings are kept newest-first up to the cap
                alive, dead = [], []
                for r, wr in self._rings:
                    owner = wr()
                    if owner is not None and owner.is_alive():
                        alive.append((r, wr))
                    else:
                        dead.append((r, wr))
                if len(dead) > self._MAX_DEAD_RINGS:
                    dead = dead[-self._MAX_DEAD_RINGS:]
                self._rings = alive + dead
                self._rings.append((ring, weakref.ref(t)))
        return ring

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = bool(enabled)

    def span_begin(self) -> int:
        """Monotonic-ns start stamp for ``span_end`` -- allocation-free,
        the hot-path half of the API."""
        return time.monotonic_ns() if self.enabled else 0

    def span_end(self, t0: int, name: str, cat: str = "span",
                 rid: Optional[str] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Record the closed span started at ``t0`` (one ring write)."""
        if not self.enabled or t0 == 0:
            return
        self._ring().put((name, cat, rid, t0, time.monotonic_ns(), args))

    def span_at(self, name: str, start_epoch: float, end_epoch: float,
                cat: str = "span", rid: Optional[str] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a span from WALL-clock endpoints (retro-spans for
        intervals whose start predates the tracer call site, e.g. queue
        wait measured from ``submitted_at``)."""
        if not self.enabled:
            return
        t0 = self.mono_of_epoch(start_epoch)
        t1 = max(t0, self.mono_of_epoch(end_epoch))
        self._ring().put((name, cat, rid, t0, t1, args))

    def instant(self, name: str, cat: str = "mark",
                rid: Optional[str] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        now = time.monotonic_ns()
        self._ring().put((name, cat, rid, now, now, args))

    def span(self, name: str, cat: str = "span", rid: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None) -> _SpanCtx:
        """Context-manager convenience (allocates: not for hot paths)."""
        return _SpanCtx(self, name, cat, rid, args)

    # -------------------------------------------------------------- reading

    def mono_of_epoch(self, epoch_s: float) -> int:
        return self._anchor_mono_ns + int(
            (epoch_s - self._anchor_epoch) * 1e9)

    def epoch_of_mono(self, mono_ns: int) -> float:
        return self._anchor_epoch + (mono_ns - self._anchor_mono_ns) / 1e9

    def snapshot(self) -> List[Dict[str, Any]]:
        """All buffered events as dicts (oldest-first per thread)."""
        with self._reg_lock:
            rings = [r for r, _ in self._rings]
        out: List[Dict[str, Any]] = []
        for ring in rings:
            for name, cat, rid, t0, t1, args in ring.snapshot():
                out.append({
                    "name": name, "cat": cat, "rid": rid,
                    "start_s": self.epoch_of_mono(t0),
                    "dur_us": (t1 - t0) / 1e3,
                    "tid": ring.tid, "thread": ring.name,
                    "args": args,
                })
        out.sort(key=lambda e: e["start_s"])
        return out

    def events_for(self, rid: str) -> List[Dict[str, Any]]:
        """One request's timeline (spans recorded with this rid)."""
        return [e for e in self.snapshot() if e["rid"] == rid]

    def to_chrome_trace(self, last_n: Optional[int] = None,
                        rid: Optional[str] = None,
                        max_events: Optional[int] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
        complete ("ph": "X") events, microsecond timestamps relative to
        the tracer's clock anchor, one named track per source thread.

        The export is bounded: a long-lived node's rings can hold
        ``threads x SWARMDB_TRACE_RING`` events. ``rid`` keeps only one trace's events
        (plus ``cat="ha"`` instants — promotions/fencing belong in
        every failover trace regardless of which request they cut
        across); ``last_n`` keeps the newest N span events; both are
        further capped at ``max_events`` (default
        ``SWARMDB_TRACE_EXPORT_MAX``, 50000). Truncation is by age —
        oldest dropped first — and is declared in the metadata."""
        if max_events is None:
            try:
                max_events = int(os.environ.get(
                    "SWARMDB_TRACE_EXPORT_MAX", "50000"))
            except ValueError:
                max_events = 50000
        pid = os.getpid()
        dead_rings: List[_Ring] = []
        with self._reg_lock:
            rings = [r for r, _ in self._rings]
            for r, wr in self._rings:
                owner = wr()
                if owner is None or not owner.is_alive():
                    dead_rings.append(r)
        spans: List[Dict[str, Any]] = []
        tracks: List[Dict[str, Any]] = []
        # dead-thread rings: count them and stamp the newest event's age,
        # so an evicted short-lived thread's spans read as evicted, not as
        # never recorded
        newest_end_ns = 0
        for ring in dead_rings:
            for ev in ring.snapshot():
                if ev[4] > newest_end_ns:
                    newest_end_ns = ev[4]
        dead_meta: Dict[str, Any] = {
            "count": len(dead_rings),
            "retain_cap": self._MAX_DEAD_RINGS,
            "newest_event_age_s": (
                round(max(0.0, (time.monotonic_ns() - newest_end_ns))
                      / 1e9, 3) if newest_end_ns else None),
        }
        for ring in rings:
            tracks.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": ring.tid, "args": {"name": ring.name},
            })
            for name, cat, ev_rid, t0, t1, args in ring.snapshot():
                if rid is not None and ev_rid != rid and cat != "ha":
                    continue
                ev: Dict[str, Any] = {
                    "name": name, "cat": cat, "ph": "X", "pid": pid,
                    "tid": ring.tid,
                    "ts": (t0 - self._anchor_mono_ns) / 1e3,
                    "dur": max(0.0, (t1 - t0) / 1e3),
                }
                if ev_rid is not None or args:
                    a: Dict[str, Any] = dict(args or {})
                    if ev_rid is not None:
                        a["rid"] = ev_rid
                    ev["args"] = a
                spans.append(ev)
        spans.sort(key=lambda e: e["ts"])
        total = len(spans)
        keep = total
        if last_n is not None:
            keep = min(keep, max(0, int(last_n)))
        if max_events and max_events > 0:
            keep = min(keep, max_events)
        if keep < total:
            spans = spans[total - keep:]
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "swarmdb_tpu_torch"},
        }]
        events.extend(tracks)
        events.extend(spans)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "anchor_epoch_s": self._anchor_epoch,
                "clock": "monotonic_ns relative to anchor",
                "span_events": len(spans),
                "total_span_events": total,
                "truncated": keep < total,
                "dead_thread_rings": dead_meta,
            },
        }

    def reset(self) -> None:
        """Drop every buffered event (tests / bench window isolation).
        Live threads lazily re-register their rings on the next record."""
        with self._reg_lock:
            self._rings.clear()
        # threads keep their old (now unregistered) ring until they next
        # record through _ring(); force re-registration for THIS thread
        self._local = threading.local()


# Process-global default tracer: every layer records here so one export
# holds the whole request path.
TRACER = SpanTracer()
