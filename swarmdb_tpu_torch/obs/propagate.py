"""Trace-context propagation: a copy of ``swarmdb_tpu/obs/propagate.py``.

One agent message is one trace. Its context names the trace (for a
message, the message id, the same join key every span's ``rid`` already
carries), the hop's span and the process that started it:

- ``TraceContext(trace_id, span_id, origin)``;
- a thread-local current context (``use()`` / ``current()``): the
  runtime activates it around a broker publish, and a wire client below
  it injects it without an argument threaded through the Broker ABC;
- ``inject()`` / ``extract()``: the wire form, a 3-key dict
  ``{"t": trace_id, "s": span_id, "o": origin}``. It rides every data
  plane envelope (``ha/dataplane.py``: ``RemoteBroker._call`` injects the
  current context as the ``tc`` key, the server extracts it and records
  ``dataplane.<op>`` under it) and an occasional replication ``G`` frame
  (``broker/replica.py``);
- ``merge_chrome_traces()``: per-node Chrome-trace exports merged into
  one Perfetto-loadable document on a shared wall-clock origin (each
  export carries its ``anchor_epoch_s``). ``GET /admin/cluster/trace``
  fans out to the cluster map's nodes and serves this merge.

Merged process rows are labelled ``swarmdb_tpu:<node>``, as the JAX
package labels them, so merges from both packages read alike.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["TraceContext", "current", "use", "inject", "extract",
           "node_id", "merge_chrome_traces"]

_local = threading.local()
_span_seq = itertools.count(1)  # C-level next(): thread-safe enough


def node_id() -> str:
    """This process's identity in exported traces: ``SWARMDB_NODE_ID``,
    else a pid-derived name, stable for the process's life."""
    return os.environ.get("SWARMDB_NODE_ID") or f"pid-{os.getpid()}"


class TraceContext:
    """One hop's view of a distributed trace (immutable once built)."""

    __slots__ = ("trace_id", "span_id", "origin")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 origin: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id or f"{os.getpid():x}.{next(_span_seq):x}"
        self.origin = origin or node_id()

    def child(self) -> "TraceContext":
        """Same trace, a fresh span id, this process as the hop's
        origin: what a server activates for work done for a caller."""
        return TraceContext(self.trace_id, origin=node_id())

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, span={self.span_id!r}, "
                f"origin={self.origin!r})")


def current() -> Optional[TraceContext]:
    return getattr(_local, "ctx", None)


@contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Activate ``ctx`` for the calling thread (None passes through, so
    call sites need no branch)."""
    if ctx is None:
        yield None
        return
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def inject(ctx: Optional[TraceContext] = None) -> Optional[Dict[str, str]]:
    """Wire form of ``ctx`` (or of the current context); None when there
    is nothing to propagate."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        return None
    return {"t": ctx.trace_id, "s": ctx.span_id, "o": ctx.origin}


def extract(wire: Any) -> Optional[TraceContext]:
    """Parse a wire dict back into a context; anything malformed gives
    None, never an exception."""
    if not isinstance(wire, dict):
        return None
    trace_id = wire.get("t")
    if not isinstance(trace_id, str) or not trace_id:
        return None
    span_id = wire.get("s")
    origin = wire.get("o")
    return TraceContext(trace_id,
                        span_id=span_id if isinstance(span_id, str) else None,
                        origin=origin if isinstance(origin, str) else None)


# ---------------------------------------------------------------- merging


def _anchor_of(trace: Dict[str, Any]) -> float:
    try:
        return float(trace.get("metadata", {}).get("anchor_epoch_s", 0.0))
    except (TypeError, ValueError):
        return 0.0


def merge_chrome_traces(
        sources: List[Tuple[str, Dict[str, Any]]]) -> Dict[str, Any]:
    """Merge per-node Chrome-trace exports into one document.

    ``sources`` is ``[(node_label, chrome_trace_dict), ...]``. Each
    export's ``ts`` values are microseconds from its own monotonic
    anchor; ``metadata.anchor_epoch_s`` maps them to wall time. Every
    event is re-based onto the earliest anchor. Events arriving from
    several sources (one process's tracer exported twice) are
    deduplicated on (pid, tid, ts, name, dur).
    """
    anchors = [a for a in (_anchor_of(t) for _, t in sources) if a > 0]
    base = min(anchors) if anchors else 0.0
    events: List[Dict[str, Any]] = []
    seen = set()
    nodes: List[str] = []
    for label, trace in sources:
        nodes.append(label)
        shift_us = (_anchor_of(trace) - base) * 1e6 if base else 0.0
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") == "M":
                # metadata rows need no shift, one copy per (pid, tid)
                key = ("M", ev.get("name"), ev.get("pid"), ev.get("tid"),
                       str(ev.get("args")))
                if key in seen:
                    continue
                seen.add(key)
                out = dict(ev)
                if ev.get("name") == "process_name":
                    out["args"] = {"name": f"swarmdb_tpu:{label}"}
                events.append(out)
                continue
            key = (ev.get("pid"), ev.get("tid"), ev.get("ts"),
                   ev.get("name"), ev.get("dur"))
            if key in seen:
                continue
            seen.add(key)
            out = dict(ev)
            out["ts"] = float(ev.get("ts", 0.0)) + shift_us
            events.append(out)
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "anchor_epoch_s": base,
            "clock": "monotonic_ns re-anchored to the earliest node anchor",
            "nodes": nodes,
        },
    }
