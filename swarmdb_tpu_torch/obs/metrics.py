"""Fixed-bucket latency histograms for ``/metrics``: a copy of
``swarmdb_tpu/obs/metrics.py``.

``utils/metrics.py``'s ``LatencyHistogram`` is a locked sample reservoir,
good for a run's percentiles; this module is the Prometheus-native
counterpart a scraper reads: **fixed bucket boundaries, cumulative
counts, no locks on the record path**.

Record-path contract (``observe`` runs in the engine loop and the
runtime's send path):

- ``observe()`` allocates nothing: a C-level ``bisect`` over a static
  boundary tuple and two integer adds into a preallocated list.
- Increments are unguarded. Under the GIL a ``counts[i] += 1`` race can
  lose one observation, never tear a bucket. Scrapes read a copy.
- Histograms are bound once (the module constants below) and hot paths
  call the bound object, never a registry lookup per observation.

Bucket boundaries are stable: dashboards key on ``le`` values. Two
ladders, the JAX package's service-objective buckets (not measured on
any card):

- ``LADDER_FAST`` (0.1 ms ... 2.5 s): decode-chunk latency, broker
  publish, data-plane round trips.
- ``LADDER_WIDE`` (1 ms ... 60 s): TTFT, queue wait, replication commit.

``SWARMDB_HISTOGRAMS=0`` disables recording (the chip check's overhead
A/B flips it together with the tracer and the sentinel).

**Exemplars**: each bucket keeps the trace id of the latest observation
that landed in it, in three preallocated parallel slot lists (no dict or
tuple built per observation), rendered in OpenMetrics exemplar syntax
(``... # {trace_id="..."} <value> <ts>``) on the ``_bucket`` lines and
listed with export links at ``GET /admin/slo``. ``SWARMDB_EXEMPLARS=0``
keeps the counts and drops the exemplars.

Six histograms are registered, as in the JAX package, so ``/metrics``
renders the same blocks: ``dataplane_rtt_seconds`` is observed by the HA
data plane's client (``ha/dataplane.py``) and
``replication_commit_seconds`` by the replicated broker
(``broker/replica.py``); in a process with neither, their blocks stay at
zero.
"""

from __future__ import annotations

import os
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

from ..utils.sync import make_lock

__all__ = ["Histogram", "HistogramRegistry", "HISTOGRAMS",
           "LADDER_FAST", "LADDER_WIDE",
           "HIST_TTFT", "HIST_DECODE_CHUNK", "HIST_QUEUE_WAIT",
           "HIST_DATAPLANE_RTT", "HIST_REPLICATION_COMMIT"]

#: seconds; upper bounds of each bucket (an implicit +Inf bucket follows)
LADDER_FAST: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5)
LADDER_WIDE: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0)


class Histogram:
    """One fixed-bucket histogram; single-object record path."""

    __slots__ = ("name", "help", "boundaries", "counts", "total", "sum_s",
                 "enabled", "exemplars_enabled",
                 "_ex_rids", "_ex_vals", "_ex_ts")

    def __init__(self, name: str, boundaries: Tuple[float, ...],
                 help_text: str = "") -> None:
        self.name = name
        self.help = help_text
        self.boundaries = tuple(float(b) for b in boundaries)
        if list(self.boundaries) != sorted(set(self.boundaries)):
            raise ValueError(f"histogram {name}: boundaries must be "
                             "strictly increasing")
        # per-bucket (non-cumulative) counts + the +Inf bucket at [-1]
        self.counts: List[int] = [0] * (len(self.boundaries) + 1)
        self.total = 0
        self.sum_s = 0.0
        self.enabled = True
        self.exemplars_enabled = (
            os.environ.get("SWARMDB_EXEMPLARS", "1") != "0")
        n = len(self.counts)
        self._ex_rids: List[Optional[str]] = [None] * n
        self._ex_vals: List[float] = [0.0] * n
        self._ex_ts: List[float] = [0.0] * n

    # swarmlint: hot
    def observe(self, seconds: float, rid: Optional[str] = None) -> None:
        """Record one latency (no lock; a lost count under a write race
        is the accepted failure). ``rid``, the observation's trace id,
        becomes that bucket's exemplar."""
        if not self.enabled:
            return
        i = bisect_left(self.boundaries, seconds)
        self.counts[i] += 1
        self.total += 1
        self.sum_s += seconds
        if rid is not None and self.exemplars_enabled:
            self._ex_rids[i] = rid
            self._ex_vals[i] = seconds
            self._ex_ts[i] = time.time()

    # -------------------------------------------------------------- reading

    def snapshot(self) -> Dict[str, object]:
        counts = list(self.counts)  # one-shot copy; benign race
        return {
            "name": self.name,
            "boundaries": list(self.boundaries),
            "counts": counts,
            "count": sum(counts),
            "sum_s": self.sum_s,
        }

    def exemplars(self) -> List[Dict[str, Any]]:
        """Retained bucket exemplars, tail first: each names the bucket's
        ``le`` bound, the trace id, the observed value and its age."""
        now = time.time()
        out: List[Dict[str, Any]] = []
        for i in range(len(self.counts) - 1, -1, -1):
            rid = self._ex_rids[i]
            if rid is None:
                continue
            le = ("+Inf" if i == len(self.boundaries)
                  else f"{self.boundaries[i]:g}")
            out.append({
                "le": le,
                "trace_id": rid,
                "value_s": round(self._ex_vals[i], 6),
                "age_s": round(max(0.0, now - self._ex_ts[i]), 3),
            })
        return out

    def render_prometheus(self, prefix: str = "swarmdb_",
                          exemplars: bool = False) -> List[str]:
        """Prometheus text-exposition histogram block (cumulative
        ``_bucket{le=...}`` counts, ``_sum``, ``_count``); with
        ``exemplars``, buckets that kept one carry the OpenMetrics
        exemplar suffix."""
        n = f"{prefix}{self.name}"
        lines = [f"# TYPE {n} histogram"]
        snap = self.snapshot()

        def _ex(i: int) -> str:
            if not exemplars or self._ex_rids[i] is None:
                return ""
            return (f' # {{trace_id="{self._ex_rids[i]}"}} '
                    f"{self._ex_vals[i]:.6g} {self._ex_ts[i]:.3f}")

        cum = 0
        for i, (bound, c) in enumerate(zip(self.boundaries,
                                           snap["counts"])):
            cum += c
            lines.append(f'{n}_bucket{{le="{bound:g}"}} {cum}{_ex(i)}')
        cum += snap["counts"][-1]
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum}'
                     f"{_ex(len(self.boundaries))}")
        lines.append(f"{n}_sum {snap['sum_s']:.6f}")
        lines.append(f"{n}_count {cum}")
        return lines

    def reset(self) -> None:
        self.counts = [0] * (len(self.boundaries) + 1)
        self.total = 0
        self.sum_s = 0.0
        n = len(self.counts)
        self._ex_rids = [None] * n
        self._ex_vals = [0.0] * n
        self._ex_ts = [0.0] * n


class HistogramRegistry:
    """Named histograms, registered once (the registration lock never
    sits on a record path: hot paths hold the returned object)."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("SWARMDB_HISTOGRAMS", "1") != "0"
        self._lock = make_lock("obs.metrics.HistogramRegistry._lock")
        # swarmlint: guarded-by[self._lock]: _hists
        self._hists: Dict[str, Histogram] = {}
        self.enabled = bool(enabled)

    def register(self, name: str, boundaries: Tuple[float, ...],
                 help_text: str = "") -> Histogram:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = Histogram(name, boundaries, help_text)
                hist.enabled = self.enabled
                self._hists[name] = hist
            return hist

    def get(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def all(self) -> List[Histogram]:
        with self._lock:
            return list(self._hists.values())

    def set_enabled(self, enabled: bool) -> None:
        """Flip recording everywhere (mirrors ``SpanTracer.set_enabled``)."""
        self.enabled = bool(enabled)
        for hist in self.all():
            hist.enabled = self.enabled

    def set_exemplars_enabled(self, enabled: bool) -> None:
        """Flip exemplar retention everywhere."""
        for hist in self.all():
            hist.exemplars_enabled = bool(enabled)

    def exemplars(self) -> Dict[str, List[Dict[str, Any]]]:
        """name -> tail-first exemplar list, empty histograms left out
        (the ``/admin/slo`` exemplar section)."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for hist in sorted(self.all(), key=lambda h: h.name):
            ex = hist.exemplars()
            if ex:
                out[hist.name] = ex
        return out

    def render_prometheus(self, prefix: str = "swarmdb_",
                          exemplars: bool = False) -> List[str]:
        lines: List[str] = []
        for hist in sorted(self.all(), key=lambda h: h.name):
            lines.extend(hist.render_prometheus(prefix,
                                                exemplars=exemplars))
        return lines

    def reset(self) -> None:
        for hist in self.all():
            hist.reset()


#: process-global registry, exported at /metrics next to the counters
HISTOGRAMS = HistogramRegistry()

# The serving-path histograms, with the JAX package's names, ladders and
# help texts (boundary changes are breaking):
HIST_TTFT = HISTOGRAMS.register(
    "ttft_seconds", LADDER_WIDE,
    "submit -> first emitted token, per engine request")
HIST_QUEUE_WAIT = HISTOGRAMS.register(
    "queue_wait_seconds", LADDER_WIDE,
    "submit -> admission into a decode slot")
HIST_DECODE_CHUNK = HISTOGRAMS.register(
    "decode_chunk_seconds", LADDER_FAST,
    "decode-chunk dispatch -> host-processed")
HIST_DATAPLANE_RTT = HISTOGRAMS.register(
    "dataplane_rtt_seconds", LADDER_FAST,
    "data-plane client op round-trip (excludes server-side blocking "
    "wait ops)")
HIST_REPLICATION_COMMIT = HISTOGRAMS.register(
    "replication_commit_seconds", LADDER_WIDE,
    "append -> acks=all durable watermark passed it (replication lag "
    "as writers experience it)")
HIST_PUBLISH = HISTOGRAMS.register(
    "broker_publish_seconds", LADDER_FAST,
    "runtime send -> broker accepted the produce (the echo-mode record "
    "path, so the bench A/B overhead budget covers histogram recording)")
