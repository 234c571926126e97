"""Observability: the request-span tracer and the flight recorder.

Copies of ``swarmdb_tpu/obs/tracer.py`` and ``flight.py``. The rest of
the JAX package's ``obs/`` (cluster trace propagation, histograms, the
SLO sentinel, the profilers and the sanitizers) is ROADMAP.md queue 1
item 10.
"""

from .flight import FlightRecorder
from .tracer import TRACER, SpanTracer

__all__ = ["FlightRecorder", "SpanTracer", "TRACER"]
