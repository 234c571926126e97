"""Incremental metrics: counters, gauges, and latency histograms.

The reference computes every statistic with O(total messages) full scans
(`get_stats` ` main.py:973-1024`, `get_agent_load` `:1049-1094`). Here the
hot-path counters are maintained incrementally so `/stats` is O(1), and the
north-star gauges (completed msgs/sec, p50 send→first-token) are first-class.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Deque, Dict, Optional
from .sync import make_lock


class Counter:
    """A monotonically increasing counter, thread-safe."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = make_lock("utils.metrics.Counter._lock")

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class RateGauge:
    """Events/sec over a trailing window (default 60 s, like the reference's
    per-agent msgs/sec at ` main.py:1075-1090`, but O(window) not O(history))."""

    def __init__(self, window_s: float = 60.0) -> None:
        self.window_s = window_s
        self._events: Deque[float] = deque()
        self._lock = make_lock("utils.metrics.RateGauge._lock")

    def mark(self, ts: Optional[float] = None) -> None:
        now = ts if ts is not None else time.time()
        with self._lock:
            self._events.append(now)
            self._evict(now)

    def rate(self) -> float:
        now = time.time()
        with self._lock:
            self._evict(now)
            return len(self._events) / self.window_s

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0] < cutoff:
            self._events.popleft()


class LatencyHistogram:
    """Sorted reservoir of recent latencies with percentile queries.

    Keeps the most recent ``capacity`` samples; p50/p95/p99 are exact over
    that window. Used for the north-star p50 send→first-token gauge.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._ring: Deque[float] = deque(maxlen=capacity)
        self._lock = make_lock("utils.metrics.LatencyHistogram._lock")

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._ring.append(seconds)

    def values(self) -> list:
        """Sorted copy of the current sample window (bench reporting)."""
        with self._lock:
            return sorted(self._ring)

    def count(self) -> int:
        """O(1) sample count (len() of a deque is constant-time)."""
        with self._lock:
            return len(self._ring)

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._ring:
                return None
            data = sorted(self._ring)
        idx = min(len(data) - 1, max(0, int(round(q / 100.0 * (len(data) - 1)))))
        return data[idx]

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "count": float(self.count()),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms, one per process."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = defaultdict(Counter)
        self.rates: Dict[str, RateGauge] = defaultdict(RateGauge)
        self.latencies: Dict[str, LatencyHistogram] = defaultdict(LatencyHistogram)

    def snapshot(self) -> Dict[str, object]:
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "rates": {k: g.rate() for k, g in self.rates.items()},
            "latencies": {k: h.summary() for k, h in self.latencies.items()},
        }


GLOBAL_METRICS = MetricsRegistry()
