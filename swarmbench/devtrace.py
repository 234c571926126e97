"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` (CUDA activity only) is prepared while the engine is
idle: CUPTI is set up and its recording turned on then, never while the
engine launches work. ``begin`` marks the start of the profiled interval
(kineto keeps only what follows), ``end`` closes it on the host clock (the
trace's timestamps are on the same epoch clock), and ``finish``, once the
engine is idle again, stops the recording. One cycle per process, with
CUPTI's teardown off: re-initialising CUPTI after a teardown under CUDA
graphs (the engine replays its decode as graphs) crashes, as
``torch.profiler`` itself notes. The reduction reads the raw results
(building the profiler's Python event tree takes seconds):

- ``busy_s``: the union of every device operation's interval inside the
  interval, and ``window_s`` its length;
- ``kernel_seconds(names)``: device time of the kernels so named;
- ``device_ops``: the ten kernels that took most device time;
- ``idle_gaps``: the device's idle time, summed by what the engine's host
  thread was doing (the engine span of the program's tracer overlapping
  each gap most, or ``engine loop outside spans``), the ten largest.
"""

from __future__ import annotations

import bisect
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

#: idle gaps shorter than this (between the kernels of one graph or one
#: stream of launches) are summed under one label, not looked up
SHORT_GAP_US = 20.0
SHORT_GAPS = "gaps under 20 us (launch to launch)"
OUTSIDE = "engine loop outside spans"
#: the program's spans that say what the engine's host thread was doing;
#: ``engine.admit`` spans a request's queue wait, not host work
HOST_SPANS = ("engine.prefill", "engine.decode_chunk", "engine.host_sync")


def base_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list (its namespace stays)."""
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip()


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    host: Tuple[float, float]                  # the interval, epoch s
    kernels: Dict[str, float] = field(default_factory=dict)   # base name
    device_ops: List[List] = field(default_factory=list)
    idle_gaps: List[List] = field(default_factory=list)
    read_s: float = 0.0                        # stopping and reading

    def kernel_seconds(self, names: Iterable[str]) -> float:
        return sum(self.kernels.get(n, 0.0) for n in set(names))


class DeviceTrace:
    """``prepare`` while the engine is idle, ``begin`` / ``end`` around
    the interval (with the program's spans read at ``end``), ``finish``
    once the engine is idle again."""

    def __init__(self) -> None:
        self._prof = None
        self._host: List[float] = []
        self._spans: List[Tuple[float, float, str]] = []

    def prepare(self) -> None:
        if not torch.cuda.is_available():
            return
        from torch.profiler import ProfilerActivity
        from torch.profiler.profiler import _KinetoProfile

        os.environ["TEARDOWN_CUPTI"] = "0"
        torch.cuda.synchronize()
        self._prof = _KinetoProfile(activities=[ProfilerActivity.CUDA])
        self._prof.prepare_trace()

    def begin(self) -> None:
        if self._prof is not None:
            self._prof.start_trace()
        self._host = [time.time()]

    def end(self, spans: List[Dict]) -> None:
        """Close the interval; ``spans`` is the program tracer's snapshot
        (its rings are bounded: read them now, not after the drain)."""
        self._host.append(time.time())
        lo, hi = self._host
        self._spans = sorted(
            (s["start_s"], s["start_s"] + s["dur_us"] / 1e6, s["name"])
            for s in spans
            if s["name"] in HOST_SPANS
            and s["start_s"] < hi and s["start_s"] + s["dur_us"] / 1e6 > lo)

    def finish(self) -> Optional[TraceSummary]:
        """Stop and reduce; None without a card, an interval or any
        device activity in it."""
        if self._prof is None:
            return None
        t_stop = time.time()
        if not self._host:
            self._prof.start_trace()     # prepared, never begun
        self._prof.stop_trace()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        if len(self._host) != 2:
            return None
        lo, hi = (t * 1e6 for t in self._host)          # epoch us
        dev_type = torch.autograd.DeviceType.CUDA
        clipped: List[Tuple[float, float, str]] = []
        for e in events:
            if e.device_type() != dev_type:
                continue
            s = e.start_ns() / 1e3
            t = s + e.duration_ns() / 1e3
            if t > lo and s < hi:
                clipped.append((max(s, lo), min(t, hi), e.name()))
        if not clipped:
            return None
        busy = union((s, e) for s, e, _ in clipped if e > s)
        kernels: Dict[str, float] = {}
        for s, e, n in clipped:
            b = base_name(n)
            kernels[b] = kernels.get(b, 0.0) + (e - s) / 1e6
        ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
        spans = [(s * 1e6, e * 1e6, n) for s, e, n in self._spans]
        return TraceSummary(
            window_s=(hi - lo) / 1e6,
            busy_s=sum(e - s for s, e in busy) / 1e6,
            host=(self._host[0], self._host[1]), kernels=kernels,
            device_ops=[[n, s] for n, s in ops],
            idle_gaps=_label_gaps(_gaps(busy, lo, hi), spans),
            read_s=time.time() - t_stop)


def _gaps(busy: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def _label_gaps(gaps: List[Tuple[float, float]],
                spans: List[Tuple[float, float, str]]) -> List[List]:
    """Each gap's seconds under the span overlapping it most."""
    starts = [s for s, _, _ in spans]
    longest = max((e - s for s, e, _ in spans), default=0.0)
    by_label: Dict[str, float] = {}
    for g0, g1 in gaps:
        label = SHORT_GAPS
        if g1 - g0 >= SHORT_GAP_US:
            label, best = OUTSIDE, 0.0
            i = bisect.bisect_left(starts, g0 - longest)
            while i < len(spans) and spans[i][0] < g1:
                s, e, n = spans[i]
                ov = min(e, g1) - max(s, g0)
                if ov > best:
                    label, best = n, ov
                i += 1
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return [[n, s] for n, s in top]
