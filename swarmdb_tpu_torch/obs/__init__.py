"""Observability: request spans, the flight recorder, histograms, trace
propagation, the SLO sentinel and the offline analyzer.

Copies of the JAX package's ``obs/`` modules, with the JAX package's
names and exports for these:

- :mod:`.tracer`: per-thread ring-buffer span tracer, Chrome trace-event
  export (``GET /admin/trace/export``).
- :mod:`.flight`: rings of engine-step, request and event records
  (``GET /admin/flight``), dumped on restart and on an SLO alert.
- :mod:`.propagate`: the trace context and the trace merge behind
  ``GET /admin/cluster/trace``.
- :mod:`.metrics`: fixed-bucket latency histograms with trace-id
  exemplars, on ``/metrics``.
- :mod:`.analyze`: the offline trace / flight analyzer
  (``python -m swarmdb_tpu_torch.obs.analyze``).
- :mod:`.sentinel`: the online SLO monitor (``GET /admin/slo``).
- :mod:`.memprof`: the conversation-temperature ledger that tiering
  reads.

The device-time profiler and the rest of the memory accountant
(ROADMAP.md, queue 1 item 10b) and the sanitizers (item 10c) are not
ported yet.
"""

from . import propagate
from .flight import FlightRecorder
from .metrics import HISTOGRAMS, Histogram, HistogramRegistry
from .sentinel import SLOConfig, SLOSentinel
from .tracer import TRACER, SpanTracer

__all__ = ["FlightRecorder", "SpanTracer", "TRACER", "propagate",
           "HISTOGRAMS", "Histogram", "HistogramRegistry",
           "SLOConfig", "SLOSentinel"]
