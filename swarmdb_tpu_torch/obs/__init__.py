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
- :mod:`.profiler`: the device-time profiler: per-variant device time,
  MFU and roofline class, lane duty cycles, the dispatch-shape profile
  (``GET /admin/profile``).
- :mod:`.memprof`: the memory accountant: pool occupancy, conversation
  temperature, prefix reuse curve, the warm-tier model and its
  validation against the running tier (``GET /admin/mem``).
- :mod:`.cost`: the per-variant FLOP and byte prices the engine
  harvests into the profiler at warmup.
- :mod:`.lockcheck`, :mod:`.pagecheck`, :mod:`.kerncheck`: the three
  runtime sanitizers behind ``SWARMDB_LOCKCHECK``, ``SWARMDB_PAGECHECK``
  and ``SWARMDB_KERNCHECK`` (``GET /admin/lockcheck``, ``/admin/pagecheck``,
  ``/admin/kerncheck``). As in the JAX package they are not imported
  here: with its flag off none of them is imported at all.
"""

from . import propagate
from .flight import FlightRecorder
from .memprof import MemProfiler, memprof, memprof_enabled
from .metrics import HISTOGRAMS, Histogram, HistogramRegistry
from .profiler import KernelProfiler, profile_enabled, profiler
from .sentinel import SLOConfig, SLOSentinel
from .tracer import TRACER, SpanTracer

__all__ = ["FlightRecorder", "SpanTracer", "TRACER", "propagate",
           "HISTOGRAMS", "Histogram", "HistogramRegistry",
           "SLOConfig", "SLOSentinel",
           "KernelProfiler", "profile_enabled", "profiler",
           "MemProfiler", "memprof", "memprof_enabled"]
