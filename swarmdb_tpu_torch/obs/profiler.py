"""The device-time profiler: per-variant device time, MFU, roofline class,
per-lane duty cycles and the dispatch-shape profile.

A copy of ``swarmdb_tpu/obs/profiler.py`` with the JAX package's names,
report schema (``"kind": "swarmdb.profile"``, ``"version": 1``) and
surfaces. What feeds it on the card:

- **Cost facts at warmup only.** ``Engine.profile_harvest`` prices every
  variant the engine can dispatch from the model config and the variant's
  shapes (``obs/cost.py``: GEMM and attention FLOPs, weight and KV bytes;
  PyTorch has no counterpart of XLA's cost model) and registers them
  here. :attr:`KernelProfiler.harvest_calls` stays flat once traffic
  flows.
- **Device time.** On the card each decode chunk (a CUDA graph replay)
  and each eager prefill wave is bracketed by a pair of timing events on
  the engine's stream; the engine reads their elapsed time only after a
  host wait it takes anyway (the chunk's block), so the profiler adds no
  synchronization. A prefill wave's pair measures the stream's span,
  launch gaps included. Off the card the engine records
  wall-around-dispatch, as the JAX package does off the TPU. The record
  path is a dict lookup and integer adds; ``SWARMDB_PROFILE=0`` hands
  every engine the shared :class:`NullLane`.
- **Derived per variant**: achieved FLOP/s over accumulated device time,
  MFU against the card's peak, arithmetic intensity and the roofline
  class (compute-bound at or above the ridge, memory-bound below).
- **Dispatch-shape profile**: per (wave kind, width), waves, packed and
  padding tokens and the variant keys serving the shape; ragged waves at
  or under ``SWARMDB_PROF_TINY_WIDTH`` are named tiny flush waves.
- **Per-lane duty cycles**: busy device time of the lane's stream over
  the time since serving started. Lanes on one card overlap, so a lane's
  duty is its own stream's, never the card's busy share.

Surfaces: ``GET /admin/profile`` (503 when off), ``swarmdb_mfu`` /
``swarmdb_lane_duty_cycle{lane=}`` /
``swarmdb_kernel_device_seconds_total{variant=}`` on /metrics, device
tracks merged into the trace export, ``obs/analyze.py --roofline`` over
profile dumps, the sentinel's MFU and duty-cycle objectives, and profile
dumps riding every flight auto-dump.

Stdlib-only: the engine measures and hands numbers in.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["KernelProfiler", "LaneProfile", "NullLane", "profiler",
           "profile_enabled", "platform_peaks"]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def profile_enabled() -> bool:
    """One switch for the whole layer (README env catalog:
    ``SWARMDB_PROFILE``, default ON — the profiler is an always-on
    flight instrument, not a debugging session)."""
    return os.environ.get("SWARMDB_PROFILE", "1") != "0"


#: peak dense bf16 FLOP/s and HBM bytes/s per card, from the vendor's
#: data sheet (the same constants as chip_smoke.py's bounds), matched by
#: substring against the normalized ``torch.cuda.get_device_name()``
_PLATFORM_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("h100", 989e12, 3.35e12),
)

#: CPU fallback: a container core's rough f32 FMA peak (order of
#: magnitude only: CPU MFU is a liveness proof, not a performance claim)
_CPU_PEAK_FLOPS = 5e10
_CPU_PEAK_BW = 2e10


def platform_peaks(platform: str, device_kind: str = "") -> Dict[str, float]:
    """{peak_flops, peak_bytes_per_s, ridge_flops_per_byte} for a
    platform / device-name pair (``"gpu"``, ``torch.cuda.get_device_name``).
    ``SWARMDB_PEAK_FLOPS`` / ``SWARMDB_PEAK_BW`` override both columns
    (cards the table predates, a power-capped card)."""
    flops: Optional[float] = None
    bw: Optional[float] = None
    kind = (device_kind or "").lower().replace(" ", "")
    if platform == "gpu" or kind:
        for key, f, b in _PLATFORM_PEAKS:
            if key in kind:
                flops, bw = f, b
                break
    if flops is None:
        flops, bw = _CPU_PEAK_FLOPS, _CPU_PEAK_BW
    flops = _env_float("SWARMDB_PEAK_FLOPS", flops)
    bw = _env_float("SWARMDB_PEAK_BW", bw)
    return {
        "peak_flops": flops,
        "peak_bytes_per_s": bw,
        "ridge_flops_per_byte": (flops / bw) if bw else None,
    }


class _Variant:
    """One dispatched program (a graph variant, a prefill wave shape):
    static cost facts from the warmup harvest + runtime invocation and
    device-time accumulators (the adds are deliberately unguarded: a lost
    count under a write race is the accepted failure mode)."""

    __slots__ = ("name", "flops", "bytes_accessed", "invocations",
                 "device_ns", "meta")

    def __init__(self, name: str) -> None:
        self.name = name
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.invocations = 0
        self.device_ns = 0
        self.meta: Dict[str, Any] = {}


class NullLane:
    """The flag-off lane handle: every dispatch site reads ``enabled``
    (one attribute) and skips the clock reads entirely. A singleton —
    the SWARMDB_PROFILE=0 type-identity test pins that disabled engines
    share exactly this object."""

    __slots__ = ()
    enabled = False
    label = "off"

    def set_label(self, label: str) -> None:  # pragma: no cover - trivial
        pass

    def dispatch(self, key: str, t0_ns: int, dur_ns: int) -> None:
        pass

    def wave(self, kind: str, width: int, packed: int, padding: int,
             variant_key: Optional[str] = None) -> None:
        pass

    def suspend(self) -> None:
        pass

    def resume(self) -> None:
        pass


NULL_LANE = NullLane()


class LaneProfile:
    """Per-engine (= per-lane) device-time accumulator + a bounded ring
    of recent dispatches for the Chrome-trace device tracks. Written by
    the lane's engine thread; readers race benignly (the flight-recorder
    stance: rings are evidence)."""

    __slots__ = ("label", "pool", "enabled", "busy_ns", "serving_since_ns",
                 "_reg", "_ring", "_ring_idx", "_ring_cap", "__weakref__")

    def __init__(self, reg: "KernelProfiler", label: str,
                 ring_cap: int) -> None:
        self.label = label
        self.pool: Optional[str] = None
        self.enabled = True
        self.busy_ns = 0
        self.serving_since_ns = time.monotonic_ns()
        self._reg = reg
        self._ring_cap = max(16, ring_cap)
        # (key, t0_ns, dur_ns) slots, preallocated — recent dispatches
        # become "device:<lane>" tracks in the Chrome trace export
        self._ring: List[Optional[Tuple[str, int, int]]] = \
            [None] * self._ring_cap
        self._ring_idx = 0

    def set_label(self, label: str) -> None:
        self.label = label

    def set_pool(self, pool: Optional[str]) -> None:
        """Name the lane's fleet role (swarmfleet pool map) so duty
        cycles and the roofline report group by pool."""
        self.pool = pool

    # ---------------------------------------------------------- record path

    # swarmlint: hot
    def dispatch(self, key: str, t0_ns: int, dur_ns: int) -> None:
        """Attribute one dispatch's device time to ``key`` (a timing-event
        pair's elapsed time on the card, wall-around-dispatch off it). Two
        dict/int ops on the variant + two on the lane + one ring slot
        write."""
        if not self.enabled:
            return
        v = self._reg.variant(key)
        v.invocations += 1
        v.device_ns += dur_ns
        self.busy_ns += dur_ns
        i = self._ring_idx % self._ring_cap
        self._ring[i] = (key, t0_ns, dur_ns)
        self._ring_idx += 1

    # swarmlint: hot
    def wave(self, kind: str, width: int, packed: int, padding: int,
             variant_key: Optional[str] = None) -> None:
        """One admission wave's shape into the dispatch profile (per
        wave, not per token — a handful of ops on the prefill path)."""
        if not self.enabled:
            return
        self._reg.record_wave(kind, width, packed, padding, variant_key)

    # ------------------------------------------------------------ lifecycle

    def suspend(self) -> None:
        """Stop recording (warmup: graph captures and kernel builds must
        not count as device time, or the first MFU window reads them as
        kernel work)."""
        self.enabled = False

    def resume(self) -> None:
        """Re-enable AND re-anchor the duty-cycle clock: elapsed starts
        when serving starts, not when the engine object was built."""
        self.busy_ns = 0
        self.serving_since_ns = time.monotonic_ns()
        self.enabled = profile_enabled() and self._reg.enabled

    # -------------------------------------------------------------- reading

    def duty_cycle(self, now_ns: Optional[int] = None) -> float:
        """Busy fraction since serving started, clamped to 1 (pipelined
        chunks overlap, so busy can legitimately exceed wall)."""
        now_ns = now_ns or time.monotonic_ns()
        elapsed = max(1, now_ns - self.serving_since_ns)
        return min(1.0, self.busy_ns / elapsed)

    def recent(self) -> List[Tuple[str, int, int]]:
        """Oldest-first snapshot of the dispatch ring."""
        idx = self._ring_idx
        ring = list(self._ring)
        if idx <= self._ring_cap:
            out = ring[:idx]
        else:
            cut = idx % self._ring_cap
            out = ring[cut:] + ring[:cut]
        return [r for r in out if r is not None]


# process-monotonic dump sequence (concurrent dumpers never collide)
_DUMP_SEQ = itertools.count(1)


class KernelProfiler:
    """Process-global registry: variants, lanes, dispatch shapes, the
    platform peak table — and every derived surface (report, Prometheus
    lines, Chrome device tracks, dumps)."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.enabled = profile_enabled() if enabled is None else enabled
        self._lock = make_lock("obs.profiler.KernelProfiler._lock")
        # swarmlint: guarded-by[self._lock]: _vars, _lanes, _waves
        self._vars: Dict[str, _Variant] = {}
        # held weakly: a dropped engine's lane leaves every report (a
        # stopped engine's zero duty would otherwise pin min_lane_duty)
        self._lanes: List["weakref.ref[LaneProfile]"] = []
        self._lanes_made = 0
        # (kind, width) -> [waves, packed, padding, {variant_key: waves}]
        self._waves: Dict[Tuple[str, int], List[Any]] = {}
        # swarmlint: guarded-by[self._lock]: _vmem_est
        # variant key (or "kernel:<tag>") -> (static bytes, budget bytes):
        # on the card, a CUDA kernel's shared memory per block and the
        # device's opt-in limit, folded in by ops.layers._record_static_smem
        self._vmem_est: Dict[str, Tuple[int, int]] = {}
        self.harvest_calls = 0
        self.platform: Optional[str] = None
        self.device_kind: str = ""
        self._ring_cap = _env_int("SWARMDB_PROFILE_RING", 1024)
        self._tiny_width = _env_int("SWARMDB_PROF_TINY_WIDTH", 8)
        # clock anchor pair (monotonic <-> epoch) for trace merging
        self._anchor_mono_ns = time.monotonic_ns()
        self._anchor_epoch = time.time()

    # ------------------------------------------------------------ wiring

    def lane(self, label: Optional[str] = None):
        """A recording handle for one engine. Flag off -> the shared
        :class:`NullLane` (type identity pinned by test)."""
        if not (self.enabled and profile_enabled()):
            return NULL_LANE
        with self._lock:
            lane = LaneProfile(self, label or f"lane{self._lanes_made}",
                               self._ring_cap)
            self._lanes_made += 1
            self._lanes = [r for r in self._lanes if r() is not None]
            self._lanes.append(weakref.ref(lane))
        return lane

    # swarmlint: holds[self._lock]
    def _live_lanes(self) -> List["LaneProfile"]:
        """The lanes whose engines are alive, in creation order (call
        with ``_lock`` held)."""
        return [lane for lane in (r() for r in self._lanes)
                if lane is not None]

    def set_platform(self, platform: str, device_kind: str = "") -> None:
        self.platform = platform
        self.device_kind = device_kind or ""

    def set_enabled(self, enabled: bool) -> None:
        """Flip recording everywhere (the overhead A/B; mirrors
        ``SpanTracer.set_enabled``). Lanes suspended here keep their
        duty anchor — the A/B toggles are seconds apart."""
        self.enabled = bool(enabled)
        with self._lock:
            lanes = self._live_lanes()
        for lane in lanes:
            lane.enabled = bool(enabled) and profile_enabled()

    def variant(self, key: str) -> _Variant:
        # racy fast path: dict.get is GIL-atomic and a miss re-checks
        # under the lock — the record path never blocks on registration
        v = self._vars.get(key)  # swarmlint: disable=SWL301 -- lock-free read fast path; miss re-checks under the lock
        if v is None:
            with self._lock:
                v = self._vars.get(key)
                if v is None:
                    v = _Variant(key)
                    self._vars[key] = v
        return v

    # ----------------------------------------------------------- harvest

    def record_variant(self, key: str, flops: Optional[float],
                       bytes_accessed: Optional[float],
                       meta: Optional[Dict[str, Any]] = None) -> None:
        """One harvested cost row (warmup only: the engine prices the
        variant and hands the numbers in; ``harvest_calls`` lets the
        zero-harvest-after-warmup test hold the line)."""
        self.harvest_calls += 1
        v = self.variant(key)
        v.flops = float(flops) if flops and flops > 0 else None
        v.bytes_accessed = (float(bytes_accessed)
                            if bytes_accessed and bytes_accessed > 0
                            else None)
        if meta:
            v.meta.update(meta)

    def record_vmem_estimate(self, key: str, est_bytes: int,
                             budget_bytes: int) -> None:
        """A static on-chip memory estimate for a variant, in a SIDE table
        (``record_variant`` would mark the variant harvested): on the card
        a CUDA kernel's shared memory per block and the device's opt-in
        limit per block, recorded at dispatch by
        ``ops.layers._record_static_smem``. The report keeps the JAX
        package's keys (``vmem_est_bytes``, ``vmem_budget_bytes``,
        ``vmem_utilization``). ``key`` is the exact variant key or a
        ``kernel:<name>`` alias matched against ``meta["kernel"]``."""
        with self._lock:
            self._vmem_est[key] = (int(est_bytes), int(budget_bytes))

    def has_vmem_estimate(self, key: str) -> bool:
        """Whether ``key`` already has an estimate (the dispatchers record
        once per key). A racy read: the worst case is one recomputation."""
        return key in self._vmem_est  # swarmlint: disable=SWL301 -- racy membership read; worst case one recomputed estimate

    def harvested(self, key: str) -> bool:
        """Whether a variant already carries cost facts (lane groups
        harvest once per variant, not once per lane). A racy read: the
        worst case is one redundant harvest."""
        v = self._vars.get(key)  # swarmlint: disable=SWL301 -- racy read; worst case one redundant harvest
        return v is not None and v.flops is not None

    def record_wave(self, kind: str, width: int, packed: int, padding: int,
                    variant_key: Optional[str] = None) -> None:
        # racy fast path, same shape as variant(): miss re-checks locked
        entry = self._waves.get((kind, width))  # swarmlint: disable=SWL301 -- lock-free read fast path; miss re-checks under the lock
        if entry is None:
            with self._lock:
                entry = self._waves.setdefault((kind, width),
                                               [0, 0, 0, {}])
        entry[0] += 1
        entry[1] += packed
        entry[2] += padding
        if variant_key is not None:
            entry[3][variant_key] = entry[3].get(variant_key, 0) + 1

    # ----------------------------------------------------------- reading

    def peaks(self) -> Dict[str, float]:
        return platform_peaks(self.platform or "", self.device_kind)

    def _variant_row(self, v: _Variant, peaks: Dict[str, float],
                     vmem: Optional[Dict[str, Tuple[int, int]]] = None,
                     ) -> Dict[str, Any]:
        dev_s = v.device_ns / 1e9
        row: Dict[str, Any] = {
            "variant": v.name,
            "invocations": v.invocations,
            "device_s": round(dev_s, 6),
            "flops_per_call": v.flops,
            "bytes_per_call": v.bytes_accessed,
        }
        if v.meta:
            row["meta"] = dict(v.meta)
        if v.flops and v.invocations and dev_s > 0:
            achieved = v.flops * v.invocations / dev_s
            row["achieved_flops_per_s"] = round(achieved, 1)
            if peaks.get("peak_flops"):
                row["mfu"] = round(achieved / peaks["peak_flops"], 6)
        if v.flops and v.bytes_accessed:
            ai = v.flops / v.bytes_accessed
            row["arithmetic_intensity"] = round(ai, 3)
            ridge = peaks.get("ridge_flops_per_byte")
            if ridge:
                row["roofline"] = ("compute-bound" if ai >= ridge
                                   else "memory-bound")
        if vmem:
            est = vmem.get(v.name)
            if est is None and v.meta.get("kernel"):
                est = vmem.get("kernel:" + str(v.meta["kernel"]))
            if est is not None:
                row["vmem_est_bytes"] = est[0]
                row["vmem_budget_bytes"] = est[1]
                if est[1] > 0:
                    row["vmem_utilization"] = round(est[0] / est[1], 4)
        return row

    def variants_report(self) -> List[Dict[str, Any]]:
        """All variants, most device time first."""
        peaks = self.peaks()
        with self._lock:
            vs = list(self._vars.values())
            vmem = dict(self._vmem_est)
        rows = [self._variant_row(v, peaks, vmem) for v in vs]
        rows.sort(key=lambda r: -r["device_s"])
        return rows

    def lanes_report(self) -> List[Dict[str, Any]]:
        now_ns = time.monotonic_ns()
        with self._lock:
            lanes = self._live_lanes()
        return [{
            "lane": lane.label,
            "pool": lane.pool,
            "busy_s": round(lane.busy_ns / 1e9, 6),
            "elapsed_s": round(
                max(0, now_ns - lane.serving_since_ns) / 1e9, 3),
            "duty_cycle": round(lane.duty_cycle(now_ns), 6),
        } for lane in lanes]

    # variant-name families per fleet role: with role-typed pools these
    # partition the registry (prefill lanes only ever dispatch prefill-
    # family variants and vice versa), so per-pool MFU is exact there
    _POOL_FAMILIES = {
        "prefill": ("prefill",),
        "decode": ("decode", "resident"),
    }

    def pools_report(self) -> List[Dict[str, Any]]:
        """Per-pool rollup (swarmfleet): duty cycles aggregated over the
        pool's lanes + the pool's variant-family MFU. Empty list when no
        lane carries a pool label (colocated mode)."""
        now_ns = time.monotonic_ns()
        peaks = self.peaks()
        with self._lock:
            lanes = [l for l in self._live_lanes() if l.pool is not None]
            vs = list(self._vars.values())
        if not lanes:
            return []
        out: List[Dict[str, Any]] = []
        for pool in sorted({l.pool for l in lanes}):
            members = [l for l in lanes if l.pool == pool]
            duties = [l.duty_cycle(now_ns) for l in members]
            row: Dict[str, Any] = {
                "pool": pool,
                "lanes": [l.label for l in members],
                "busy_s": round(sum(l.busy_ns for l in members) / 1e9, 6),
                "duty_cycle_min": round(min(duties), 6),
                "duty_cycle_mean": round(sum(duties) / len(duties), 6),
            }
            fams = self._POOL_FAMILIES.get(pool)
            if fams and peaks.get("peak_flops"):
                fam_vs = [v for v in vs
                          if v.name.startswith(fams) and v.flops]
                flops = sum(v.flops * v.invocations for v in fam_vs)
                dev_s = sum(v.device_ns for v in fam_vs) / 1e9
                if flops and dev_s > 0:
                    row["mfu"] = round(
                        flops / dev_s / peaks["peak_flops"], 6)
            out.append(row)
        return out

    def dispatch_profile(self) -> List[Dict[str, Any]]:
        """The wave-shape histogram, tiny ragged flush waves named. Each
        row joins its serving variants' invocation counts and cumulative
        device seconds, so "the w=1 flush waves cost X ms total" is one
        lookup."""
        with self._lock:
            waves = {k: (e[0], e[1], e[2], dict(e[3]))
                     for k, e in self._waves.items()}
        out: List[Dict[str, Any]] = []
        for (kind, width), (n, packed, padding, keys) in sorted(
                waves.items()):
            row: Dict[str, Any] = {
                "kind": kind, "width": width, "waves": n,
                "packed_tokens": packed, "padding_tokens": padding,
            }
            if kind == "ragged" and width <= self._tiny_width:
                row["tiny_flush"] = True
            if keys:
                dev_s = 0.0
                inv = 0
                for key in keys:
                    # read-only join against live counters (benign race)
                    v = self._vars.get(key)  # swarmlint: disable=SWL301 -- read-only snapshot join; torn read costs one stale row
                    if v is not None:
                        dev_s += v.device_ns / 1e9
                        inv += v.invocations
                row["variants"] = sorted(keys)
                row["variant_invocations"] = inv
                row["variant_device_s"] = round(dev_s, 6)
            out.append(row)
        return out

    def tiny_flush_waves(self) -> int:
        """Ragged waves at or under SWARMDB_PROF_TINY_WIDTH: the signal
        to set ``SWARMDB_RAGGED_MIN_WIDTH`` from (ROADMAP item 3)."""
        with self._lock:
            return sum(e[0] for (kind, width), e in self._waves.items()
                       if kind == "ragged" and width <= self._tiny_width)

    def mfu(self) -> Optional[float]:
        """Aggregate harvested-FLOPs MFU: total executed FLOPs over
        total accumulated device time, vs one card's peak. Overlapping
        lanes make device time additive across devices, so this is the
        per-device mean — conservative by construction."""
        peaks = self.peaks()
        if not peaks.get("peak_flops"):
            return None
        with self._lock:
            vs = list(self._vars.values())
        flops = sum(v.flops * v.invocations for v in vs if v.flops)
        dev_s = sum(v.device_ns for v in vs if v.flops) / 1e9
        if not flops or dev_s <= 0:
            return None
        return flops / dev_s / peaks["peak_flops"]

    def counters_snapshot(self) -> Dict[str, Any]:
        """Cumulative totals for window-delta consumers (the SLO
        sentinel): executed FLOPs, device seconds, per-lane busy ns."""
        with self._lock:
            vs = list(self._vars.values())
            lanes = self._live_lanes()
        return {
            "flops_total": sum(v.flops * v.invocations
                               for v in vs if v.flops),
            "device_s_total": sum(v.device_ns for v in vs) / 1e9,
            "lane_busy_ns": {lane.label: lane.busy_ns for lane in lanes},
            "mono_ns": time.monotonic_ns(),
        }

    def report(self) -> Dict[str, Any]:
        """The ``GET /admin/profile`` payload / dump body."""
        agg = self.mfu()
        return {
            "kind": "swarmdb.profile",
            "version": 1,
            "enabled": self.enabled and profile_enabled(),
            "platform": self.platform,
            "device_kind": self.device_kind,
            "peaks": self.peaks(),
            "harvest_calls": self.harvest_calls,
            "mfu": round(agg, 6) if agg is not None else None,
            "variants": self.variants_report(),
            "lanes": self.lanes_report(),
            "pools": self.pools_report(),
            "dispatch_profile": self.dispatch_profile(),
            "tiny_flush_waves": self.tiny_flush_waves(),
        }

    def kernel_profile(self, top: int = 8) -> Dict[str, Any]:
        """A compact block for a benchmark record: top device-time
        variants + lane duty cycles, small enough to ride a JSON line."""
        rows = self.variants_report()[:top]
        out = {
            "platform": self.platform,
            "mfu": (round(self.mfu(), 6)
                    if self.mfu() is not None else None),
            "variants": rows,
            "lanes": self.lanes_report(),
            "tiny_flush_waves": self.tiny_flush_waves(),
        }
        pools = self.pools_report()
        if pools:
            out["pools"] = pools
        return out

    # -------------------------------------------------------- prometheus

    def prometheus_lines(self) -> List[str]:
        """``swarmdb_mfu`` / ``swarmdb_lane_duty_cycle{lane=}`` /
        ``swarmdb_kernel_device_seconds_total{variant=}`` /
        ``swarmdb_kernel_invocations_total{variant=}`` for /metrics."""
        lines: List[str] = []
        agg = self.mfu()
        lines.append("# TYPE swarmdb_mfu gauge")
        lines.append(f"swarmdb_mfu {round(agg, 6) if agg else 0.0}")
        lines.append("# TYPE swarmdb_lane_duty_cycle gauge")
        for row in self.lanes_report():
            lbl = f'lane="{row["lane"]}"'
            if row.get("pool"):
                # fleet mode: pool idleness is a first-class label
                lbl += f',pool="{row["pool"]}"'
            lines.append(f"swarmdb_lane_duty_cycle{{{lbl}}} "
                         f"{row['duty_cycle']}")
        lines.append("# TYPE swarmdb_kernel_device_seconds_total counter")
        lines.append("# TYPE swarmdb_kernel_invocations_total counter")
        for row in self.variants_report():
            lbl = f'{{variant="{row["variant"]}"}}'
            lines.append(
                f"swarmdb_kernel_device_seconds_total{lbl} "
                f"{row['device_s']}")
            lines.append(
                f"swarmdb_kernel_invocations_total{lbl} "
                f"{row['invocations']}")
        return lines

    # ------------------------------------------------------- trace merge

    def merge_chrome_trace(self, trace: Dict[str, Any]) -> Dict[str, Any]:
        """Append per-lane device-time tracks to a Chrome trace export
        (``SpanTracer.to_chrome_trace`` output, mutated in place). The
        export's timestamps are microseconds relative to ITS anchor
        epoch (``metadata.anchor_epoch_s``); the profiler re-anchors its
        monotonic dispatch stamps through its own (mono, epoch) pair, so
        device tracks line up with the host spans they explain."""
        meta = trace.get("metadata") or {}
        anchor_epoch = meta.get("anchor_epoch_s")
        if anchor_epoch is None:
            return trace
        pid = os.getpid()
        events = trace.setdefault("traceEvents", [])
        with self._lock:
            lanes = self._live_lanes()
        n_tracks = 0
        for i, lane in enumerate(lanes):
            recent = lane.recent()
            if not recent:
                continue
            tid = 900000 + i  # device tracks, far from real thread ids
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"device:{lane.label}"},
            })
            n_tracks += 1
            for key, t0_ns, dur_ns in recent:
                epoch0 = (self._anchor_epoch
                          + (t0_ns - self._anchor_mono_ns) / 1e9)
                events.append({
                    "name": key, "cat": "device", "ph": "X", "pid": pid,
                    "tid": tid,
                    "ts": (epoch0 - anchor_epoch) * 1e6,
                    "dur": max(0.0, dur_ns / 1e3),
                })
        meta["device_tracks"] = n_tracks
        return trace

    # -------------------------------------------------------------- dumps

    def _dump_identity(self) -> str:
        raw = os.environ.get("SWARMDB_NODE_ID") or f"p{os.getpid()}"
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def dump_to(self, directory: str, reason: str = "on_demand") -> str:
        """Write the report under ``directory`` (atomic, collision-free
        filename) and return the path. ``profile_*.json`` files next to
        flight dumps are listed by ``obs/analyze.py`` and consumed by
        its ``--roofline`` mode."""
        os.makedirs(directory, exist_ok=True)
        payload = self.report()
        payload["dumped_at"] = time.time()
        payload["node"] = self._dump_identity()
        payload["reason"] = reason
        path = os.path.join(
            directory,
            f"profile_{self._dump_identity()}_{next(_DUMP_SEQ)}_"
            f"{reason}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path

    def auto_dump(self, reason: str,
                  directory: Optional[str] = None) -> Optional[str]:
        """Best-effort dump for failure paths (rides every flight
        auto-dump): never raises, returns the path or None."""
        directory = os.environ.get("SWARMDB_FLIGHT_DIR") or directory
        if not directory or not (self.enabled and profile_enabled()):
            return None
        try:
            return self.dump_to(directory, reason)
        except Exception:
            logger.exception("profile dump failed (%s)", reason)
            return None

    def reset(self) -> None:
        """Drop everything (tests / sub-run isolation). Existing
        lane handles keep recording into the registry; their stats
        re-anchor."""
        with self._lock:
            self._vars.clear()
            self._waves.clear()
            self._vmem_est.clear()
            lanes = self._live_lanes()
        for lane in lanes:
            lane.busy_ns = 0
            lane.serving_since_ns = time.monotonic_ns()
            lane._ring = [None] * lane._ring_cap
            lane._ring_idx = 0
        self.harvest_calls = 0


_PROFILER: Optional[KernelProfiler] = None
_PROFILER_LOCK = make_lock("obs.profiler._PROFILER_LOCK")


def profiler() -> KernelProfiler:
    """The process-global profiler (lazy — brokers/analyzers that never
    serve a token pay nothing)."""
    global _PROFILER
    if _PROFILER is None:
        with _PROFILER_LOCK:
            if _PROFILER is None:
                _PROFILER = KernelProfiler()
    return _PROFILER
