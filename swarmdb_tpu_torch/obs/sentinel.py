"""Online SLO sentinel: a copy of ``swarmdb_tpu/obs/sentinel.py``.

The offline analyzer (``obs/analyze.py``) explains a regression after
someone exports traces. The sentinel runs the same per-completion cost
decomposition (queue_wait / prefill / decode / host_sync) continuously:

- It reads what the hot paths already feed: the engine's ``phase_us_*``
  counters, the admission-wave counters and the TTFT / queue-wait
  histograms. Nothing new is written per request, chunk or token.
- ``maybe_tick()`` (one monotonic read and a compare) runs from the
  engine loop (``Engine._flight_step``) and the runtime's send path.
  When a window (``SWARMDB_SLO_WINDOW_S``, default 10 s) has elapsed it
  closes: the counter and histogram deltas since the previous close
  become a window summary.
- The first ``SWARMDB_SLO_WARMUP`` busy windows are averaged into a
  baseline. Every later window is checked against the SLOs (p95 TTFT,
  p95 queue wait, retry rate, per-completion cost growth over the
  baseline, the fleet's p95 handoff); on a breach the analyzer's
  attributor (``analyze.diagnose``) runs baseline against window, and
  the alert names the dominant contributor with shares summing to 1.
- Alerts land in a bounded ring, each with a flight dump and a trace
  export tagged with the alert id (``SWARMDB_FLIGHT_DIR``, else the
  engine's flight directory) and a rewrite of the ring
  (``slo_alerts_<node>.json``).
- ``GET /admin/slo`` serves it all, ``/metrics`` its ``swarmdb_slo_*``
  gauges.

The default objectives (TTFT p95 2.5 s, queue p95 1.0 s, handoff p95
250 ms, cost growth 2x) are the JAX package's service objectives, kept
for parity; none was measured on any card.

The window's MFU / duty-cycle fold reads the device-time profiler
(``obs/profiler.py``) and its prefix-hit / headroom fold the memory
accountant (``obs/memprof.py``): ``_profile_window`` and ``_mem_window``,
as in the JAX package, so the mfu_drop_x, duty_drop_x, prefix_hit_drop_x
and mem_headroom_min objectives fire on a served engine's windows.

Locking: the deadline check takes no lock; the rare close takes a
non-blocking lock only to elect one closer when engine loops and send
threads race on one deadline (a loser skips, it never waits).
``ingest()``, the detection core, is deterministic given a window.

``SWARMDB_SENTINEL=0`` turns the sentinel off (``maybe_tick`` then costs
one attribute read).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

from .metrics import HISTOGRAMS, HIST_QUEUE_WAIT, HIST_TTFT
from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["SLOSentinel", "SLOConfig"]

#: engine cost categories, one-to-one with the offline analyzer's
CATEGORIES = ("queue_wait", "prefill", "decode", "host_sync")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class SLOConfig:
    """Env-backed sentinel knobs (README env catalog documents them)."""

    __slots__ = ("window_s", "warmup_windows", "min_completions",
                 "ttft_p95_s", "queue_p95_s", "cost_growth_x",
                 "retry_rate", "mfu_drop_x", "duty_drop_x",
                 "prefix_hit_drop_x", "mem_headroom_min",
                 "handoff_p95_ms", "max_alerts", "enabled")

    def __init__(self,
                 window_s: Optional[float] = None,
                 warmup_windows: Optional[int] = None,
                 min_completions: Optional[int] = None,
                 ttft_p95_s: Optional[float] = None,
                 queue_p95_s: Optional[float] = None,
                 cost_growth_x: Optional[float] = None,
                 retry_rate: Optional[float] = None,
                 mfu_drop_x: Optional[float] = None,
                 duty_drop_x: Optional[float] = None,
                 prefix_hit_drop_x: Optional[float] = None,
                 mem_headroom_min: Optional[float] = None,
                 handoff_p95_ms: Optional[float] = None,
                 max_alerts: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self.window_s = window_s if window_s is not None else \
            _env_float("SWARMDB_SLO_WINDOW_S", 10.0)
        self.warmup_windows = warmup_windows if warmup_windows is not None \
            else _env_int("SWARMDB_SLO_WARMUP", 3)
        # idle-window guard: fewer completions than this and the window
        # neither trains the baseline nor alerts (a 2-request blip would
        # otherwise dominate a mean)
        self.min_completions = min_completions if min_completions is not \
            None else _env_int("SWARMDB_SLO_MIN_COMPLETIONS", 8)
        self.ttft_p95_s = ttft_p95_s if ttft_p95_s is not None else \
            _env_float("SWARMDB_SLO_TTFT_P95_S", 2.5)
        self.queue_p95_s = queue_p95_s if queue_p95_s is not None else \
            _env_float("SWARMDB_SLO_QUEUE_P95_S", 1.0)
        self.cost_growth_x = cost_growth_x if cost_growth_x is not None \
            else _env_float("SWARMDB_SLO_COST_GROWTH_X", 2.0)
        # retry-rate SLO: supervised retries (lane migration
        # requeues, shed-and-retry, engine-loss requeues) per completion
        # in the window. A flapping lane shows up HERE — each flap
        # re-fails its migrated requests — before throughput degrades
        # enough to trip the cost SLO.
        self.retry_rate = retry_rate if retry_rate is not None else \
            _env_float("SWARMDB_SLO_RETRY_RATE", 0.5)
        # profiler regression SLOs: a busy window whose MFU
        # (or worst lane duty cycle) fell past baseline/<factor> breaches
        # even while throughput holds — silicon efficiency is a
        # first-class SLO (obs/profiler.py feeds them). <= 1 disables.
        self.mfu_drop_x = mfu_drop_x if mfu_drop_x is not None else \
            _env_float("SWARMDB_SLO_MFU_DROP_X", 3.0)
        self.duty_drop_x = duty_drop_x if duty_drop_x is not None else \
            _env_float("SWARMDB_SLO_DUTY_DROP_X", 3.0)
        # memory SLOs (obs/memprof.py): a busy window whose prefix hit rate
        # fell past baseline/<factor> (the anchor-jump / cache-thrash
        # signature), or whose pool headroom (free + evictable pages
        # over total) dropped under an absolute floor — parked KV is
        # about to starve admission. <= 1 / <= 0 disables.
        self.prefix_hit_drop_x = prefix_hit_drop_x \
            if prefix_hit_drop_x is not None else \
            _env_float("SWARMDB_SLO_PREFIX_HIT_DROP_X", 2.0)
        self.mem_headroom_min = mem_headroom_min \
            if mem_headroom_min is not None else \
            _env_float("SWARMDB_SLO_MEM_HEADROOM_MIN", 0.05)
        # fleet SLO: p95 prefill→decode handoff latency
        # in a window that actually handed off. The handoff is a host
        # gather + store round-trip — if it degrades toward prefill cost
        # the disaggregation is returning its win. <= 0 disables.
        self.handoff_p95_ms = handoff_p95_ms \
            if handoff_p95_ms is not None else \
            _env_float("SWARMDB_SLO_HANDOFF_P95_MS", 250.0)
        self.max_alerts = max_alerts if max_alerts is not None else \
            _env_int("SWARMDB_SLO_ALERTS", 64)
        self.enabled = enabled if enabled is not None else \
            os.environ.get("SWARMDB_SENTINEL", "1") != "0"

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


class SLOSentinel:
    """Always-on rolling-window SLO monitor over a shared metrics
    registry (the engine records into the same registry the runtime
    owns, so one sentinel sees the whole serving path)."""

    def __init__(self, metrics: Any = None,
                 config: Optional[SLOConfig] = None,
                 flight: Any = None,
                 tracer: Any = None,
                 flight_dir: Optional[str] = None) -> None:
        self.config = config or SLOConfig()
        self.metrics = metrics
        # bound by the serving layer once an engine exists (bind());
        # a broker-only process still gets windows/baseline/SLO checks
        self.flight = flight
        self.tracer = tracer
        self.flight_dir = flight_dir
        self.enabled = self.config.enabled
        self.baseline: Optional[Dict[str, Any]] = None
        self.last_window: Optional[Dict[str, Any]] = None
        self.breached = False
        self.windows_total = 0
        self.alerts_total = 0
        # swarmlint: guarded-by[self._alerts_lock]: _alerts
        self._alerts: List[Dict[str, Any]] = []
        self._alerts_lock = make_lock("obs.sentinel.SLOSentinel._alerts_lock")
        self._warmup: List[Dict[str, Any]] = []
        self._tick_lock = make_lock("obs.sentinel.SLOSentinel._tick_lock")  # single-closer election only
        self._deadline = time.monotonic() + self.config.window_s
        self._window_opened = time.time()
        self._prev_counters: Optional[Dict[str, int]] = None
        self._prev_ttft: List[int] = list(HIST_TTFT.counts)
        self._prev_queue: List[int] = list(HIST_QUEUE_WAIT.counts)
        # the profiler's cumulative snapshot at the previous close (window
        # MFU / duty cycles are deltas, like every other window number)
        self._prev_prof: Optional[Dict[str, Any]] = None
        # the accountant's cumulative snapshot (the window's prefix hit
        # rate is a token-count delta)
        self._prev_mem: Optional[Dict[str, Any]] = None
        # the fleet's cumulative handoff count (window handoffs = delta)
        self._prev_handoffs: Optional[int] = None

    # ------------------------------------------------------------- wiring

    def bind(self, flight: Any = None, tracer: Any = None,
             flight_dir: Optional[str] = None) -> None:
        """Attach the engine-side dump sources (ServingService calls
        this once the engine exists). Idempotent."""
        if flight is not None:
            self.flight = flight
        if tracer is not None:
            self.tracer = tracer
        if flight_dir is not None:
            self.flight_dir = flight_dir

    def set_enabled(self, enabled: bool) -> None:
        """Flip monitoring (the overhead A/B; mirrors the tracer /
        histogram toggles)."""
        self.enabled = bool(enabled)
        if enabled:
            self._deadline = time.monotonic() + self.config.window_s
            self._window_opened = time.time()
            self._prev_counters = None  # re-anchor, don't bill the gap
            self._prev_prof = None
            self._prev_mem = None
            self._prev_handoffs = None

    # -------------------------------------------------------- record path

    # swarmlint: hot
    def maybe_tick(self, now: float = 0.0) -> None:
        """Deadline probe, called from the engine loop and the runtime
        send path: one compare on the fast path, window close only when
        the deadline passed AND this caller wins the non-blocking
        closer election."""
        if not self.enabled:
            return
        if not now:
            now = time.monotonic()
        if now < self._deadline:
            return
        if not self._tick_lock.acquire(blocking=False):
            return
        try:
            if now >= self._deadline:  # re-check: a closer may have won
                self._close_window()
        finally:
            self._tick_lock.release()

    # ------------------------------------------------------- window close

    def _counter_value(self, name: str) -> int:
        # read .value without materializing a defaultdict miss for
        # engines that never ran (a broker-only process has no
        # phase_us_* counters)
        if self.metrics is None:
            return 0
        c = self.metrics.counters.get(name)
        return int(c.value) if c is not None else 0

    def _snapshot_counters(self) -> Dict[str, int]:
        names = ["engine_completed", "engine_admitted",
                 "engine_admission_waves", "engine_host_syncs",
                 "requests_retried", "requests_migrated", "requests_shed"]
        names += [f"phase_us_{c}" for c in CATEGORIES]
        return {n: self._counter_value(n) for n in names}

    @staticmethod
    def _p95_from_delta(boundaries, cur: List[int],
                        prev: List[int]) -> Optional[float]:
        """Window p95 from the cumulative-count delta of a fixed-bucket
        histogram: the upper bound of the bucket where the window's
        cumulative fraction crosses 0.95 (conservative overestimate —
        exactly what an SLO check wants)."""
        delta = [max(0, c - p) for c, p in zip(cur, prev)]
        total = sum(delta)
        if total <= 0:
            return None
        target = 0.95 * total
        cum = 0
        for i, d in enumerate(delta):
            cum += d
            if cum >= target:
                return float(boundaries[min(i, len(boundaries) - 1)])
        return float(boundaries[-1])

    def _close_window(self) -> None:
        """Diff counters/histograms since the previous close into a
        window summary, then run detection on it."""
        now_mono = time.monotonic()
        self._deadline = now_mono + self.config.window_s
        cur = self._snapshot_counters()
        cur_ttft = list(HIST_TTFT.counts)
        cur_queue = list(HIST_QUEUE_WAIT.counts)
        prev, self._prev_counters = self._prev_counters, cur
        opened, self._window_opened = self._window_opened, time.time()
        if prev is None:
            # first close (or re-enable): anchor only — the deltas would
            # bill everything since process start to one window
            self._prev_ttft, self._prev_queue = cur_ttft, cur_queue
            return
        completed = cur["engine_completed"] - prev["engine_completed"]
        window: Dict[str, Any] = {
            "closed_at": self._window_opened,
            "span_s": round(self._window_opened - opened, 3),
            "completed": completed,
            "admitted": cur["engine_admitted"] - prev["engine_admitted"],
            "admission_waves": (cur["engine_admission_waves"]
                                - prev["engine_admission_waves"]),
            "p95_ttft_s": self._p95_from_delta(
                HIST_TTFT.boundaries, cur_ttft, self._prev_ttft),
            "p95_queue_wait_s": self._p95_from_delta(
                HIST_QUEUE_WAIT.boundaries, cur_queue, self._prev_queue),
            "retried": cur["requests_retried"] - prev["requests_retried"],
            "migrated": (cur["requests_migrated"]
                         - prev["requests_migrated"]),
            "shed": cur["requests_shed"] - prev["requests_shed"],
        }
        window["retry_rate"] = round(
            window["retried"] / max(1, completed), 3)
        self._prev_ttft, self._prev_queue = cur_ttft, cur_queue
        denom = max(1, completed)
        per_completion = {}
        for cat in CATEGORIES:
            delta_us = cur[f"phase_us_{cat}"] - prev[f"phase_us_{cat}"]
            per_completion[cat] = round(delta_us / 1e3 / denom, 3)
        window["per_completion_ms"] = per_completion
        waves = max(1, window["admission_waves"])
        window["mean_wave_size"] = round(window["admitted"] / waves, 2)
        # per-category means for the attributor's explanation text:
        # queue/prefill per admission wave, decode/host_sync per chunk
        chunks = max(1, cur["engine_host_syncs"]
                     - prev["engine_host_syncs"])
        admitted = max(1, window["admitted"])
        window["mean_ms"] = {
            "queue_wait": round(
                (cur["phase_us_queue_wait"] - prev["phase_us_queue_wait"])
                / 1e3 / admitted, 3),
            "prefill": round(
                (cur["phase_us_prefill"] - prev["phase_us_prefill"])
                / 1e3 / waves, 3),
            "decode": round(
                (cur["phase_us_decode"] - prev["phase_us_decode"])
                / 1e3 / chunks, 3),
            "host_sync": round(
                (cur["phase_us_host_sync"] - prev["phase_us_host_sync"])
                / 1e3 / chunks, 3),
        }
        self._profile_window(window)
        self._mem_window(window)
        self._fleet_window(window)
        self.ingest(window)

    def _profile_window(self, window: Dict[str, Any]) -> None:
        """Fold the device-time profiler's deltas into the closing window:
        executed-FLOPs MFU over the window's wall time and the minimum
        per-lane duty cycle, the numbers the mfu_drop_x / duty_drop_x
        SLOs watch. No-op with the profiler off."""
        from .profiler import profile_enabled, profiler

        if not profile_enabled():
            return
        prof = profiler()
        cur = prof.counters_snapshot()
        prev, self._prev_prof = self._prev_prof, cur
        if prev is None:
            return
        span_s = max(1e-6, (cur["mono_ns"] - prev["mono_ns"]) / 1e9)
        peaks = prof.peaks()
        dflops = cur["flops_total"] - prev["flops_total"]
        if peaks.get("peak_flops") and dflops > 0:
            window["mfu"] = round(
                dflops / span_s / peaks["peak_flops"], 6)
        duties = []
        for lane, busy in cur["lane_busy_ns"].items():
            dbusy = busy - prev["lane_busy_ns"].get(lane, 0)
            duties.append(min(1.0, max(0.0, dbusy / (span_s * 1e9))))
        if duties:
            window["min_lane_duty"] = round(min(duties), 4)

    def _mem_window(self, window: Dict[str, Any]) -> None:
        """Fold the memory accountant's deltas into the closing window:
        the window's prefix hit rate (hit-token delta over looked-up-token
        delta) and the current pool headroom fraction (free +
        cached-evictable over total), the numbers the prefix_hit_drop_x /
        mem_headroom_min SLOs watch. No-op with the accountant off."""
        from .memprof import memprof, memprof_enabled

        if not memprof_enabled():
            return
        mp = memprof()
        cur = mp.counters_snapshot()
        prev, self._prev_mem = self._prev_mem, cur
        total = cur.get("pool_total_pages", 0)
        if total > 0:
            window["mem_headroom_frac"] = round(
                cur.get("pool_headroom_pages", 0) / total, 4)
        if prev is None:
            return
        dhit = cur["hit_tokens"] - prev["hit_tokens"]
        dmiss = cur["miss_tokens"] - prev["miss_tokens"]
        if dhit + dmiss > 0:
            window["prefix_hit_rate"] = round(dhit / (dhit + dmiss), 4)

    def _fleet_window(self, window: Dict[str, Any]) -> None:
        """Fold the fleet's handoff latency into the closing window: only
        windows that actually handed off carry ``handoff_p95_ms`` (the
        handoff_p95_ms SLO watches it). No-op without a fleet."""
        if self.metrics is None:
            return
        c = self.metrics.counters.get("fleet_handoffs")
        cur = int(c.value) if c is not None else 0
        prev, self._prev_handoffs = self._prev_handoffs, cur
        if prev is None or cur <= prev:
            return
        window["handoffs"] = cur - prev
        h = self.metrics.latencies.get("fleet_handoff_s")
        p95 = h.percentile(95) if h is not None else None
        if p95 is not None:
            window["handoff_p95_ms"] = round(p95 * 1e3, 3)

    # ---------------------------------------------------------- detection

    @staticmethod
    def _normalize(window: Dict[str, Any]) -> Dict[str, Any]:
        """Fill the keys the attributor expects (tests hand-build
        windows; the online path always provides everything)."""
        w = dict(window)
        pcm = {c: float(w.get("per_completion_ms", {}).get(c, 0.0))
               for c in CATEGORIES}
        w["per_completion_ms"] = pcm
        w.setdefault("mean_ms", dict(pcm))
        w["mean_ms"] = {c: float(w["mean_ms"].get(c, 0.0))
                        for c in CATEGORIES}
        w.setdefault("completed", 0)
        w.setdefault("admission_waves", 0)
        w.setdefault("mean_wave_size", 0.0)
        w.setdefault("retried", 0)
        w.setdefault("retry_rate",
                     round(w["retried"] / max(1, w["completed"]), 3))
        w.setdefault("mfu", None)
        w.setdefault("min_lane_duty", None)
        w.setdefault("prefix_hit_rate", None)
        w.setdefault("mem_headroom_frac", None)
        return w

    def _baseline_from_warmup(self) -> Dict[str, Any]:
        n = len(self._warmup)
        base: Dict[str, Any] = {
            "windows": n,
            "completed": sum(w["completed"] for w in self._warmup),
            "per_completion_ms": {
                c: round(sum(w["per_completion_ms"][c]
                             for w in self._warmup) / n, 3)
                for c in CATEGORIES},
            "mean_ms": {
                c: round(sum(w["mean_ms"][c] for w in self._warmup) / n, 3)
                for c in CATEGORIES},
            "admission_waves": round(
                sum(w["admission_waves"] for w in self._warmup) / n, 1),
            "mean_wave_size": round(
                sum(w["mean_wave_size"] for w in self._warmup) / n, 2),
        }
        for key in ("p95_ttft_s", "p95_queue_wait_s", "mfu",
                    "min_lane_duty", "prefix_hit_rate"):
            vals = [w[key] for w in self._warmup if w.get(key) is not None]
            base[key] = round(sum(vals) / len(vals), 6) if vals else None
        return base

    def ingest(self, window: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Run detection on one closed window (the deterministic core:
        the injected-regression test replays synthetic windows through
        here). Returns the alert if one fired, else None."""
        window = self._normalize(window)
        self.windows_total += 1
        self.last_window = window
        if window["completed"] < self.config.min_completions:
            window["idle"] = True
            return None
        if self.baseline is None:
            self._warmup.append(window)
            if len(self._warmup) >= self.config.warmup_windows:
                self.baseline = self._baseline_from_warmup()
                self._warmup = []
                logger.info("SLO sentinel baseline learned over %d "
                            "windows: %s per-completion ms",
                            self.baseline["windows"],
                            self.baseline["per_completion_ms"])
            return None
        breaches = self._check_slos(window)
        if not breaches:
            self.breached = False
            return None
        return self._fire_alert(window, breaches)

    def _check_slos(self, window: Dict[str, Any]) -> List[Dict[str, Any]]:
        cfg = self.config
        breaches: List[Dict[str, Any]] = []
        ttft = window.get("p95_ttft_s")
        if ttft is not None and ttft > cfg.ttft_p95_s:
            breaches.append({"slo": "ttft_p95_s", "limit": cfg.ttft_p95_s,
                             "value": ttft})
        queue = window.get("p95_queue_wait_s")
        if queue is not None and queue > cfg.queue_p95_s:
            breaches.append({"slo": "queue_wait_p95_s",
                             "limit": cfg.queue_p95_s, "value": queue})
        rr = window.get("retry_rate")
        if rr is not None and rr > cfg.retry_rate:
            breaches.append({"slo": "retry_rate", "limit": cfg.retry_rate,
                             "value": rr})
        base_cost = sum(self.baseline["per_completion_ms"].values())
        cost = sum(window["per_completion_ms"].values())
        growth = (cost / base_cost) if base_cost > 0 else 1.0
        window["cost_growth_x"] = round(growth, 2)
        if growth > cfg.cost_growth_x:
            breaches.append({"slo": "cost_growth_x",
                             "limit": cfg.cost_growth_x,
                             "value": round(growth, 2)})
        # profiler regression SLOs: a BUSY window (the idle
        # guard already gated) whose MFU or worst lane duty collapsed
        # past baseline/<drop factor> — silicon efficiency falling while
        # throughput holds is a regression, not a curiosity. Baselines
        # of None (profiler off during warmup) disable each check.
        mfu, base_mfu = window.get("mfu"), self.baseline.get("mfu")
        if (mfu is not None and base_mfu and cfg.mfu_drop_x > 1.0
                and mfu < base_mfu / cfg.mfu_drop_x):
            breaches.append({"slo": "mfu_drop_x",
                             "limit": round(base_mfu / cfg.mfu_drop_x, 6),
                             "value": mfu})
        duty = window.get("min_lane_duty")
        base_duty = self.baseline.get("min_lane_duty")
        if (duty is not None and base_duty and cfg.duty_drop_x > 1.0
                and duty < base_duty / cfg.duty_drop_x):
            breaches.append({"slo": "duty_drop_x",
                             "limit": round(base_duty / cfg.duty_drop_x,
                                            4),
                             "value": duty})
        # memory SLOs: hit rate collapsing past
        # baseline/<factor> is the cache-thrash / anchor-jump signature;
        # headroom under the absolute floor means parked KV is about to
        # starve admission.
        hr = window.get("prefix_hit_rate")
        base_hr = self.baseline.get("prefix_hit_rate")
        if (hr is not None and base_hr and cfg.prefix_hit_drop_x > 1.0
                and hr < base_hr / cfg.prefix_hit_drop_x):
            breaches.append({"slo": "prefix_hit_drop_x",
                             "limit": round(
                                 base_hr / cfg.prefix_hit_drop_x, 4),
                             "value": hr})
        headroom = window.get("mem_headroom_frac")
        if (headroom is not None and cfg.mem_headroom_min > 0
                and headroom < cfg.mem_headroom_min):
            breaches.append({"slo": "mem_headroom_min",
                             "limit": cfg.mem_headroom_min,
                             "value": headroom})
        # fleet SLO: the prefill→decode handoff is a
        # host gather + transit-store round-trip — p95 creeping toward
        # prefill cost means the disaggregation is returning its win.
        ho = window.get("handoff_p95_ms")
        if (ho is not None and cfg.handoff_p95_ms > 0
                and ho > cfg.handoff_p95_ms):
            breaches.append({"slo": "handoff_p95_ms",
                             "limit": cfg.handoff_p95_ms,
                             "value": ho})
        return breaches

    def _fire_alert(self, window: Dict[str, Any],
                    breaches: List[Dict[str, Any]]) -> Dict[str, Any]:
        # deferred import: obs/__init__ pulls this module in, and a
        # module-level import of .analyze here would make
        # `python -m swarmdb_tpu_torch.obs.analyze` trip runpy's
        # found-in-sys.modules warning
        from . import analyze

        self.breached = True
        self.alerts_total += 1
        alert_id = f"slo-{self.alerts_total}-{int(time.time() * 1000)}"
        # the offline attributor, online: baseline is the base of the A/B
        diagnosis = analyze.diagnose(self.baseline, window)
        alert: Dict[str, Any] = {
            "id": alert_id,
            "at": time.time(),
            "breaches": breaches,
            "dominant": diagnosis["dominant"],
            "diagnosis": diagnosis,
            "window": window,
            "baseline": self.baseline,
            "flight_dump": None,
            "trace_dump": None,
        }
        directory = os.environ.get("SWARMDB_FLIGHT_DIR") or self.flight_dir
        if self.flight is not None:
            # flight dump tagged with the alert id (filename + payload
            # reason); auto_dump never raises
            alert["flight_dump"] = self.flight.auto_dump(
                alert_id, self.flight_dir)
        if self.tracer is not None and directory:
            alert["trace_dump"] = self._dump_trace(alert_id, directory)
        with self._alerts_lock:
            self._alerts.append(alert)
            if len(self._alerts) > self.config.max_alerts:
                self._alerts = self._alerts[-self.config.max_alerts:]
        if directory:
            self._write_alert_ring(directory)
        logger.warning(
            "SLO breach %s: %s — dominant contributor %s (%.0f%%); "
            "flight=%s trace=%s", alert_id,
            ", ".join(f"{b['slo']} {b['value']} > {b['limit']}"
                      for b in breaches),
            diagnosis["dominant"],
            100 * diagnosis["shares"][diagnosis["dominant"]],
            alert["flight_dump"], alert["trace_dump"])
        return alert

    def _dump_trace(self, alert_id: str, directory: str) -> Optional[str]:
        """Best-effort trace export next to the flight dump, tagged with
        the alert id in both the filename and the metadata."""
        try:
            os.makedirs(directory, exist_ok=True)
            trace = self.tracer.to_chrome_trace()
            trace["metadata"]["alert_id"] = alert_id
            path = os.path.join(directory, f"trace_{alert_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
            return path
        except Exception:
            logger.exception("SLO trace dump failed (%s)", alert_id)
            return None

    def _write_alert_ring(self, directory: str) -> None:
        """Rewrite the full alert ring (atomic) so the CI failure
        artifact that already uploads SWARMDB_FLIGHT_DIR carries the
        sentinel's verdicts alongside the flight dumps."""
        try:
            os.makedirs(directory, exist_ok=True)
            node = os.environ.get("SWARMDB_NODE_ID") or f"p{os.getpid()}"
            path = os.path.join(directory, f"slo_alerts_{node}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"alerts": self.alerts(),
                           "alerts_total": self.alerts_total}, f, indent=1)
            os.replace(tmp, path)
        except Exception:
            logger.exception("SLO alert-ring write failed")

    # ------------------------------------------------------------ reading

    def alerts(self) -> List[Dict[str, Any]]:
        with self._alerts_lock:
            return list(self._alerts)

    def status(self) -> Dict[str, Any]:
        """The ``GET /admin/slo`` payload: config, baseline, the last
        window, the alert ring, and the exemplar links that turn a tail
        histogram bucket into a concrete trace export."""
        exemplars = {
            name: [dict(e, export=f"/admin/trace/export?trace_id="
                                   f"{e['trace_id']}")
                   for e in entries]
            for name, entries in HISTOGRAMS.exemplars().items()}
        return {
            "enabled": self.enabled,
            "config": self.config.to_dict(),
            "baseline": self.baseline,
            "warmup_windows_seen": len(self._warmup),
            "last_window": self.last_window,
            "breached": self.breached,
            "windows_total": self.windows_total,
            "alerts_total": self.alerts_total,
            "alerts": self.alerts(),
            "exemplars": exemplars,
        }

    def prometheus_lines(self) -> List[str]:
        """``swarmdb_slo_*`` gauges for /metrics (the alerting surface:
        page on ``swarmdb_slo_breached == 1`` and read the dominant
        contributor off /admin/slo)."""
        lines = [
            "# TYPE swarmdb_slo_breached gauge",
            f"swarmdb_slo_breached {1 if self.breached else 0}",
            "# TYPE swarmdb_slo_alerts_total counter",
            f"swarmdb_slo_alerts_total {self.alerts_total}",
            "# TYPE swarmdb_slo_windows_total counter",
            f"swarmdb_slo_windows_total {self.windows_total}",
        ]
        w = self.last_window or {}
        if w.get("p95_ttft_s") is not None:
            lines.append("# TYPE swarmdb_slo_ttft_p95_seconds gauge")
            lines.append(f"swarmdb_slo_ttft_p95_seconds {w['p95_ttft_s']}")
        if w.get("p95_queue_wait_s") is not None:
            lines.append("# TYPE swarmdb_slo_queue_wait_p95_seconds gauge")
            lines.append("swarmdb_slo_queue_wait_p95_seconds "
                         f"{w['p95_queue_wait_s']}")
        if w.get("cost_growth_x") is not None:
            lines.append("# TYPE swarmdb_slo_cost_growth_x gauge")
            lines.append(f"swarmdb_slo_cost_growth_x {w['cost_growth_x']}")
        if w.get("retry_rate") is not None:
            lines.append("# TYPE swarmdb_slo_retry_rate gauge")
            lines.append(f"swarmdb_slo_retry_rate {w['retry_rate']}")
        if w.get("mfu") is not None:
            lines.append("# TYPE swarmdb_slo_window_mfu gauge")
            lines.append(f"swarmdb_slo_window_mfu {w['mfu']}")
        if w.get("min_lane_duty") is not None:
            lines.append("# TYPE swarmdb_slo_min_lane_duty gauge")
            lines.append(
                f"swarmdb_slo_min_lane_duty {w['min_lane_duty']}")
        if w.get("prefix_hit_rate") is not None:
            lines.append("# TYPE swarmdb_slo_prefix_hit_rate gauge")
            lines.append(
                f"swarmdb_slo_prefix_hit_rate {w['prefix_hit_rate']}")
        if w.get("mem_headroom_frac") is not None:
            lines.append("# TYPE swarmdb_slo_mem_headroom_frac gauge")
            lines.append(
                f"swarmdb_slo_mem_headroom_frac {w['mem_headroom_frac']}")
        if w.get("per_completion_ms"):
            lines.append("# TYPE swarmdb_slo_per_completion_ms gauge")
            for cat in CATEGORIES:
                lines.append(
                    f'swarmdb_slo_per_completion_ms{{category="{cat}"}} '
                    f"{w['per_completion_ms'].get(cat, 0.0)}")
        return lines
