"""The memory accountant: pool residency, conversation temperature,
prefix reuse distances, and the warm-tier and cold-resume what-if models.

A copy of ``swarmdb_tpu/obs/memprof.py`` with the JAX package's names and
report schema (``"kind": "swarmdb.mem"``, ``"version": 1``). Three
ledgers, fed by int and dict operations on hooks the owning structures
already hold their locks for:

- **Pool residency** (``MemPool``, one per ``ops.paged_kv.PageAllocator``):
  per-page allocation stamps written inside the allocator's own critical
  sections, read back as an occupancy decomposition (free / active /
  pinned / cached-evictable) and a residency-age distribution.
- **Conversation temperature** (``ConvLedger``, fed by
  ``backend/service.ServingService``, read by ``backend/tiering.py``):
  per-conversation resident pages, anchor-head tokens, last-touch age and
  touch count, classified hot / warm / cold at read time
  (``SWARMDB_MEM_HOT_S`` / ``SWARMDB_MEM_WARM_S``). Each service holds a
  ledger of its own (``memprof().conv_ledger()`` hands out a new one per
  call), so services that share conversation keys keep their touches
  apart; the registry's reports read every live ledger.
- **Reuse distances** (``ReuseSampler``, fed by
  ``ops.prefix_cache.PrefixLRU.match``): SHARDS-style spatially hashed
  sampling of prefix-chain accesses (rate 1/``SWARMDB_MEM_SAMPLE``) whose
  scaled stack distances give the miss-ratio curve.

On the curve sit a ghost warm tier (extra hit rate of host memory beyond
the device pool, re-admission priced at ``SWARMDB_MEM_H2D_GBPS``, whose
default is the host-to-device rate measured on the card, ``PERF.md``),
a cold-resume model (re-prefill time from conversation length over the
profiler's measured prefill tokens per device-second) and
``tier_validation``, which holds the model against the running
``TierManager``'s promotions and cold resumes.

``SWARMDB_MEMPROF=0`` hands every hook site a shared Null handle.
Surfaces: ``GET /admin/mem``, ``swarmdb_mem_*`` on /metrics,
``obs/analyze.py --memory``, the sentinel's prefix-hit and headroom
objectives, and mem dumps riding every flight auto-dump.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils.sync import make_lock

logger = logging.getLogger("swarmdb_tpu_torch.memprof")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def memprof_enabled() -> bool:
    """One switch for the whole layer (README env catalog:
    ``SWARMDB_MEMPROF``, default ON — the accountant is an always-on
    flight instrument, like the profiler)."""
    return os.environ.get("SWARMDB_MEMPROF", "1") != "0"


#: miss-ratio-curve capacity points, as multiples of the device pool
MEM_CURVE_POINTS: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0, 4.0)

#: host-to-device GB/s that prices a warm page's re-admission: a bf16
#: Llama-3-8B page (K + V, 2 MiB) promoted from the tier's page-locked
#: slab in 0.0493 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py's
#: rolling phase; PERF.md)
H2D_GBPS_DEFAULT = 42.5


# --------------------------------------------------------------- null handles


class NullPool:
    """Flag-off pool handle: the allocator's hook sites pay one no-op
    method call. A singleton — the SWARMDB_MEMPROF=0 type-identity test
    pins that disabled allocators share exactly this object."""

    __slots__ = ()
    enabled = False
    label = "off"

    def set_label(self, label: str) -> None:  # pragma: no cover - trivial
        pass

    def page_alloc(self, pages) -> None:
        pass

    def page_free(self, pages) -> None:
        pass

    def pool_reset(self) -> None:
        pass


NULL_POOL = NullPool()


class NullProbe:
    """Flag-off prefix-access probe (shared singleton)."""

    __slots__ = ()
    enabled = False

    def access(self, chain: bytes) -> None:
        pass


NULL_PROBE = NullProbe()


class NullConvLedger:
    """Flag-off conversation ledger (shared singleton)."""

    __slots__ = ()
    enabled = False

    def touch(self, key, tokens: int) -> None:
        pass

    def resident(self, key, pages: int) -> None:
        pass

    def anchor(self, key, tokens: int) -> None:
        pass

    def drop(self, key) -> None:
        pass

    def snapshot(self) -> List[Tuple[Any, int, int, int, int, int]]:
        return []


NULL_CONV = NullConvLedger()


# ------------------------------------------------------------- pool residency


class MemPool:
    """Per-allocator residency ledger. The write path runs INSIDE the
    owning PageAllocator's critical sections (the hooks are called with
    its lock held), so the dict writes need no lock of their own;
    readers snapshot with the profiler's benign-race stance."""

    __slots__ = ("label", "enabled", "ages", "alloc_events", "free_events",
                 "_stats_ref")

    def __init__(self, label: str,
                 stats: Optional[Callable[[], Dict[str, int]]] = None) -> None:
        self.label = label
        self.enabled = True
        # page id -> alloc monotonic ns (residency-age distribution)
        self.ages: Dict[int, int] = {}
        self.alloc_events = 0
        self.free_events = 0
        self._stats_ref = (weakref.WeakMethod(stats)
                           if stats is not None else None)

    def set_label(self, label: str) -> None:
        self.label = label

    # ---------------------------------------------------------- record path

    # swarmlint: hot
    def page_alloc(self, pages) -> None:
        """Stamp newly granted pages (caller: allocator, lock held).
        One clock read + one dict write per page."""
        if not self.enabled:
            return
        t = time.monotonic_ns()
        ages = self.ages
        for p in pages:
            ages[p] = t
        self.alloc_events += 1

    # swarmlint: hot
    def page_free(self, pages) -> None:
        """Clear stamps of returned pages (caller: allocator, lock
        held). One dict pop per page."""
        if not self.enabled:
            return
        ages = self.ages
        for p in pages:
            ages.pop(p, None)
        self.free_events += 1

    def pool_reset(self) -> None:
        """Pool generation bump: every stamp dies with the old ids."""
        self.ages.clear()

    # -------------------------------------------------------------- reading

    def owner_stats(self) -> Optional[Dict[str, int]]:
        """The owning allocator's live stats(), or None once it is
        collected (engines are rebuilt per sub-run / test)."""
        if self._stats_ref is None:
            return None
        fn = self._stats_ref()
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # owner mid-teardown — a dead pool, not an error
            return None

    def residency_ages(self, now_ns: Optional[int] = None) -> Dict[str, Any]:
        """Residency-age distribution of currently-stamped pages."""
        now_ns = now_ns or time.monotonic_ns()
        for _ in range(4):
            try:
                vals = list(self.ages.values())  # swarmlint: disable=SWL301 -- lock-free snapshot; a concurrent resize retries
                break
            except RuntimeError:
                continue
        else:
            vals = []
        if not vals:
            return {"pages": 0}
        ages = sorted((now_ns - t) / 1e9 for t in vals)
        n = len(ages)
        return {
            "pages": n,
            "p50_s": round(ages[n // 2], 3),
            "p90_s": round(ages[min(n - 1, (n * 9) // 10)], 3),
            "max_s": round(ages[-1], 3),
        }


# ------------------------------------------------------ conversation ledger


class ConvLedger:
    """One service's conversation temperature ledger. Touched once per
    served message (service thread) and once per change of kept state
    (engine thread): per-message frequency, so a small lock is fine here;
    the per-page / per-access hot paths live in MemPool and ReuseSampler
    instead."""

    __slots__ = ("enabled", "_lock", "_convs", "_cap", "touches_total",
                 "__weakref__")

    def __init__(self, cap: int) -> None:
        self.enabled = True
        self._lock = make_lock("obs.memprof.ConvLedger._lock")
        # key -> [last_touch_ns, touches, resident_pages, anchor_tokens,
        #         prompt_tokens]; insertion order == LRU (size-capped)
        # swarmlint: guarded-by[self._lock]: _convs
        self._convs: "OrderedDict[Any, List[Any]]" = OrderedDict()
        self._cap = cap
        self.touches_total = 0

    def touch(self, key, tokens: int) -> None:
        """One served message for ``key`` (prompt length ``tokens``)."""
        if not self.enabled:
            return
        with self._lock:
            st = self._convs.get(key)
            if st is None:
                st = [0, 0, 0, 0, 0]
                while len(self._convs) >= self._cap:
                    self._convs.popitem(last=False)
                self._convs[key] = st
            else:
                self._convs.move_to_end(key)
            st[0] = time.monotonic_ns()
            st[1] += 1
            st[4] = tokens
            self.touches_total += 1

    def resident(self, key, pages: int) -> None:
        """The conversation's kept KV pages (rolling-KV adoption at
        retirement; 0 = state dropped)."""
        if not self.enabled:
            return
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[2] = pages

    def anchor(self, key, tokens: int) -> None:
        """Anchor-head capture (sink-anchored window): ``tokens`` of
        immutable head this conversation re-hits every turn."""
        if not self.enabled:
            return
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[3] = tokens

    def drop(self, key) -> None:
        """The conversation's kept state went back to the pool."""
        if not self.enabled:
            return
        with self._lock:
            st = self._convs.get(key)
            if st is not None:
                st[2] = 0

    # -------------------------------------------------------------- reading

    def snapshot(self) -> List[Tuple[Any, int, int, int, int, int]]:
        """(key, last_touch_ns, touches, resident_pages, anchor_tokens,
        prompt_tokens) per conversation, oldest touch first."""
        with self._lock:
            return [(k, st[0], st[1], st[2], st[3], st[4])
                    for k, st in self._convs.items()]

    def report(self, hot_s: float, warm_s: float,
               top: int = 8) -> Dict[str, Any]:
        """hot/warm/cold decomposition by idle age, plus the heaviest
        resident conversations (the tier manager's demotion
        candidates)."""
        return _temperature_report(self.snapshot(), self.touches_total,
                                   hot_s, warm_s, top)

    def reset(self) -> None:
        with self._lock:
            self._convs.clear()
            self.touches_total = 0


def _temperature_report(rows, touches_total: int, hot_s: float,
                        warm_s: float, top: int) -> Dict[str, Any]:
    """The hot / warm / cold report over ledger snapshot rows."""
    now = time.monotonic_ns()
    counts = {"hot": 0, "warm": 0, "cold": 0}
    pages = {"hot": 0, "warm": 0, "cold": 0}
    detailed = []
    for key, last, touches, res, anchor, toks in rows:
        idle = (now - last) / 1e9
        state = ("hot" if idle < hot_s
                 else "warm" if idle < warm_s else "cold")
        counts[state] += 1
        pages[state] += res
        detailed.append({
            "conversation": "→".join(key)
            if isinstance(key, tuple) else str(key),
            "state": state,
            "idle_s": round(idle, 3),
            "touches": touches,
            "resident_pages": res,
            "anchor_tokens": anchor,
            "prompt_tokens": toks,
        })
    detailed.sort(key=lambda r: (-r["resident_pages"], r["idle_s"]))
    return {
        "tracked": len(rows),
        "touches_total": touches_total,
        "by_state": counts,
        "resident_pages_by_state": pages,
        "top_resident": detailed[:top],
    }


class ConvLedgers:
    """The registry's view of every live service's ledger (held weakly:
    a dropped service takes its ledger along). Reads as one ledger."""

    def __init__(self) -> None:
        self._lock = make_lock("obs.memprof.ConvLedgers._lock")
        self._ledgers: "weakref.WeakSet[ConvLedger]" = weakref.WeakSet()

    def add(self, ledger: ConvLedger) -> None:
        with self._lock:
            self._ledgers.add(ledger)

    def live(self) -> List[ConvLedger]:
        with self._lock:
            return list(self._ledgers)

    @property
    def touches_total(self) -> int:
        return sum(led.touches_total for led in self.live())

    def snapshot(self) -> List[Tuple[Any, int, int, int, int, int]]:
        return [row for led in self.live() for row in led.snapshot()]

    def report(self, hot_s: float, warm_s: float,
               top: int = 8) -> Dict[str, Any]:
        return _temperature_report(self.snapshot(), self.touches_total,
                                   hot_s, warm_s, top)

    def set_enabled(self, on: bool) -> None:
        for led in self.live():
            led.enabled = on

    def reset(self) -> None:
        for led in self.live():
            led.reset()


# ----------------------------------------------------------- reuse sampling


def simulate_lru(trace: Iterable[Any], capacity: int) -> float:
    """Exact LRU hit rate of ``trace`` at ``capacity`` — the brute-force
    ghost-cache verifier the sampled curve is tested against (and the
    ``--memory`` self-check replays)."""
    od: "OrderedDict[Any, None]" = OrderedDict()
    hits = 0
    n = 0
    for key in trace:
        n += 1
        if key in od:
            od.move_to_end(key)
            hits += 1
        else:
            od[key] = None
            if len(od) > capacity:
                od.popitem(last=False)
    return hits / n if n else 0.0


class ReuseSampler:
    """SHARDS-style spatially-hashed reuse-distance sampler.

    Every access hashes its chain digest; only keys under the hash
    threshold (rate ``1/SWARMDB_MEM_SAMPLE``) enter the bounded sampled
    LRU stack. A sampled key's stack distance (distinct sampled keys
    touched since its last access) scaled by the sampling rate is an
    unbiased estimate of its full-stream reuse distance, so
    ``hit_rate(C) = |sampled reuses with scaled distance < C| /
    |sampled accesses|`` — the miss-ratio curve at any capacity from one
    pass. Spatial hashing (vs temporal) keeps the estimate unbiased
    under skew: a key is either always sampled or never."""

    __slots__ = ("enabled", "_lock", "_mod", "_thresh", "rate", "_stack",
                 "_stack_cap", "_hist", "sampled", "accesses", "cold",
                 "overflowed")

    _MOD = 1 << 24

    def __init__(self, sample_inv: int, stack_cap: int) -> None:
        self.enabled = True
        self._lock = make_lock("obs.memprof.ReuseSampler._lock")
        self._mod = self._MOD
        self._thresh = max(1, self._mod // max(1, sample_inv))
        self.rate = self._mod / self._thresh  # distance scale factor
        # swarmlint: guarded-by[self._lock]: _stack, _hist
        self._stack: "OrderedDict[bytes, None]" = OrderedDict()
        self._stack_cap = stack_cap
        self._hist: Dict[int, int] = {}  # scaled distance -> count
        self.sampled = 0
        self.cold = 0
        self.overflowed = 0
        self.accesses = 0

    # ---------------------------------------------------------- record path

    # swarmlint: hot
    def access(self, chain: bytes) -> None:
        """One prefix-chain access (caller: PrefixLRU.match, its lock
        held). Unsampled: one hash, one compare. Sampled (1/rate of
        accesses): the stack update under this sampler's own lock."""
        if not self.enabled:
            return
        self.accesses += 1
        # Fibonacci bit-mix before the threshold test: chain digests are
        # already uniform, but synthetic test traces (and any future
        # integer key source) need not be — spatial sampling is only
        # unbiased if the hash is
        h = ((int.from_bytes(chain[:8], "little")
              * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 40
        if h >= self._thresh:
            return
        with self._lock:
            self._record(chain)

    # swarmlint: holds[self._lock]
    def _record(self, chain: bytes) -> None:
        self.sampled += 1
        stack = self._stack
        if chain in stack:
            d = 0
            for k in reversed(stack):
                if k == chain:
                    break
                d += 1
            stack.move_to_end(chain)
            sd = int(d * self.rate)
            self._hist[sd] = self._hist.get(sd, 0) + 1
        else:
            self.cold += 1
            stack[chain] = None
            if len(stack) > self._stack_cap:
                stack.popitem(last=False)
                self.overflowed += 1

    # -------------------------------------------------------------- reading

    def hit_rate_at(self, capacity_pages: int) -> float:
        """Estimated LRU hit rate at ``capacity_pages`` (over ALL
        accesses, cold misses included)."""
        with self._lock:
            items = list(self._hist.items())
            sampled = self.sampled
        if not sampled:
            return 0.0
        h = sum(n for d, n in items if d < capacity_pages)
        return h / sampled

    def curve(self, device_capacity: int) -> List[Dict[str, Any]]:
        """The miss-ratio curve at the standard capacity multiples."""
        out = []
        for mult in MEM_CURVE_POINTS:
            cap = max(1, int(device_capacity * mult))
            out.append({
                "capacity_x": mult,
                "capacity_pages": cap,
                "hit_rate": round(self.hit_rate_at(cap), 4),
            })
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "accesses": self.accesses,
                "sampled": self.sampled,
                "cold": self.cold,
                "stack_overflowed": self.overflowed,
                "sample_rate": round(1.0 / self.rate, 6),
                "stack_cap": self._stack_cap,
            }

    def reset(self) -> None:
        with self._lock:
            self._stack.clear()
            self._hist.clear()
            self.sampled = 0
            self.cold = 0
            self.overflowed = 0
            self.accesses = 0


class PrefixProbe:
    """The handle PrefixLRU hook sites hold: forwards sampled accesses
    into the shared ReuseSampler and keeps the cache's stats reachable
    for the occupancy decomposition."""

    __slots__ = ("enabled", "_sampler", "_stats_ref")

    def __init__(self, sampler: ReuseSampler,
                 stats: Optional[Callable[[], Dict[str, int]]] = None
                 ) -> None:
        self.enabled = True
        self._sampler = sampler
        self._stats_ref = (weakref.WeakMethod(stats)
                           if stats is not None else None)

    # swarmlint: hot
    def access(self, chain: bytes) -> None:
        if not self.enabled:
            return
        self._sampler.access(chain)

    def owner_stats(self) -> Optional[Dict[str, int]]:
        if self._stats_ref is None:
            return None
        fn = self._stats_ref()
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None


# process-monotonic dump sequence (concurrent dumpers never collide)
_DUMP_SEQ = itertools.count(1)


def _no_tier() -> Dict[str, Any]:
    """The status of a tier whose manager was collected."""
    raise LookupError("the bound tier manager is gone")


class MemProfiler:
    """Process-global registry: pool ledgers, the services' conversation
    ledgers, the reuse sampler -- and every derived surface (report,
    Prometheus lines, the compact block, dumps, the warm-tier /
    cold-resume models)."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.enabled = memprof_enabled() if enabled is None else enabled
        self._lock = make_lock("obs.memprof.MemProfiler._lock")
        # swarmlint: guarded-by[self._lock]: _pools, _probes
        self._pools: List[MemPool] = []
        self._probes: List[PrefixProbe] = []
        self.hot_s = _env_float("SWARMDB_MEM_HOT_S", 30.0)
        self.warm_s = _env_float("SWARMDB_MEM_WARM_S", 300.0)
        self.sampler = ReuseSampler(
            _env_int("SWARMDB_MEM_SAMPLE", 16),
            _env_int("SWARMDB_MEM_STACK", 65536))
        # every live service's ledger (conv_ledger() hands out one each)
        self.conversations = ConvLedgers()
        self.sampler.enabled = self.enabled
        # KV bytes per page (the engine sets this from its pool) -- prices
        # the warm tier's re-admission copy
        self.page_bytes = 0
        # the running TierManager binds its status() so tier_validation()
        # holds the what-if model above against the tier that runs
        self._tier_status: Optional[Callable[[], Dict[str, Any]]] = None

    def bind_tier(self, status_fn: Callable[[], Dict[str, Any]]) -> None:
        """Register the live TierManager's ``status`` callable. Always
        bound (not flag-gated): the validation compares two cheap
        snapshots at read time, records nothing on the hot path. A bound
        method is held weakly, so a dropped service (its engine, its
        device pool) is not kept alive by the registry."""
        if hasattr(status_fn, "__self__"):
            ref = weakref.WeakMethod(status_fn)
            self._tier_status = lambda: (ref() or _no_tier)()
        else:
            self._tier_status = status_fn

    # ------------------------------------------------------------ wiring

    def pool(self, stats: Optional[Callable[[], Dict[str, int]]] = None,
             label: str = "pool0"):
        """A residency ledger for one PageAllocator. Flag off -> the
        shared :data:`NULL_POOL` (no registration, no cost)."""
        if not (self.enabled and memprof_enabled()):
            return NULL_POOL
        p = MemPool(label, stats)
        with self._lock:
            self._pools.append(p)
        return p

    def prefix_probe(self,
                     stats: Optional[Callable[[], Dict[str, int]]] = None):
        """An access probe for one PrefixLRU. Flag off -> the shared
        :data:`NULL_PROBE`."""
        if not (self.enabled and memprof_enabled()):
            return NULL_PROBE
        pr = PrefixProbe(self.sampler, stats)
        with self._lock:
            self._probes.append(pr)
        return pr

    def conv_ledger(self):
        """A new conversation ledger for one serving service, registered
        with this accountant's reports. Flag off -> the shared
        :data:`NULL_CONV`. Its size cap is ``SWARMDB_MEM_CONV_CAP``
        (default 100000). The JAX package keeps one per process; one per
        service keeps the touches of services that share conversation
        keys apart (the tier manager breaks ties with them)."""
        if not (self.enabled and memprof_enabled()):
            return NULL_CONV
        led = ConvLedger(max(1, _env_int("SWARMDB_MEM_CONV_CAP", 100000)))
        self.conversations.add(led)
        return led

    def set_page_bytes(self, n: int) -> None:
        if n > 0:
            self.page_bytes = int(n)

    def set_enabled(self, on: bool) -> None:
        """Flip recording everywhere (the overhead A/B). Handles handed
        out while the flag was OFF stay null: like the profiler, a
        disabled build pays nothing."""
        self.enabled = on
        self.sampler.enabled = on
        self.conversations.set_enabled(on)
        with self._lock:
            pools = list(self._pools)
            probes = list(self._probes)
        for p in pools:
            p.enabled = on
        for pr in probes:
            pr.enabled = on

    # ------------------------------------------------------------- reading

    def _live_pools(self) -> List[Tuple[MemPool, Dict[str, int]]]:
        with self._lock:
            pools = list(self._pools)
        out = []
        for p in pools:
            st = p.owner_stats()
            if st is not None:
                out.append((p, st))
        return out

    def _live_prefix_stats(self) -> List[Dict[str, int]]:
        with self._lock:
            probes = list(self._probes)
        out = []
        for pr in probes:
            st = pr.owner_stats()
            if st is not None:
                out.append(st)
        return out

    def occupancy(self) -> Dict[str, Any]:
        """The per-pool decomposition, derived at read time: the
        allocator knows free vs granted; the prefix caches know how
        much of the granted side is cache custody (evictable) vs
        pinned; the remainder is active slot KV."""
        pools = self._live_pools()
        prefix = self._live_prefix_stats()
        now = time.monotonic_ns()
        rows = []
        total = free = 0
        for p, st in pools:
            n = st.get("num_pages", 0)
            f = st.get("free_pages", 0)
            total += max(0, n - 1)  # page 0 (trash) is never handed out
            free += f
            rows.append({
                "pool": p.label,
                "num_pages": n,
                "free_pages": f,
                "live_slots": st.get("live_slots", 0),
                "pages_allocated_total": st.get("pages_allocated_total", 0),
                "pages_freed_total": st.get("pages_freed_total", 0),
                "residency": p.residency_ages(now),
            })
        cached = sum(st.get("cached_pages", 0) for st in prefix)
        pinned = sum(st.get("pinned_pages", 0) for st in prefix)
        evictable = max(0, cached - pinned)
        active = max(0, total - free - cached)
        return {
            "total_pages": total,
            "free": free,
            "active": active,
            "cached_evictable": evictable,
            "pinned": min(pinned, cached),
            "headroom_pages": free + evictable,
            "pools": rows,
        }

    def prefix_totals(self) -> Dict[str, int]:
        """Summed PrefixLRU counters across live caches (the
        flag-independent /metrics gauges read the caches directly;
        this sum feeds the report / sentinel window)."""
        tot = {"lookups": 0, "full_misses": 0, "hit_tokens": 0,
               "miss_tokens": 0, "cached_pages": 0, "pinned_pages": 0,
               "num_pages": 0}
        for st in self._live_prefix_stats():
            for k in tot:
                tot[k] += st.get(k, 0)
        return tot

    def device_capacity(self) -> int:
        """The capacity the curve's "1x" point means: total pool pages
        across live allocators (the HBM-resident tier)."""
        cap = sum(max(0, st.get("num_pages", 1) - 1)
                  for _, st in self._live_pools())
        if cap <= 0:
            cap = _env_int("SWARMDB_MEM_CAPACITY", 1024)
        return cap

    # ------------------------------------------------------ what-if models

    def warm_tier_model(self) -> List[Dict[str, Any]]:
        """Ghost host-RAM warm tier: for each candidate size, the extra
        hit rate over the device-only cache and the modeled re-admission
        cost (a page-locked host-to-device copy at
        ``SWARMDB_MEM_H2D_GBPS``, default :data:`H2D_GBPS_DEFAULT`)."""
        c_dev = self.device_capacity()
        base = self.sampler.hit_rate_at(c_dev)
        bw = _env_float("SWARMDB_MEM_H2D_GBPS", H2D_GBPS_DEFAULT) * 1e9
        per_page_ms = (self.page_bytes / bw * 1e3
                       if self.page_bytes and bw else None)
        # warm byte price: a spilled page costs page_bytes of host RAM —
        # divided by the LIVE store's measured compress ratio when
        # SWARMDB_TIER_ZSTD is actually shipping compressed payloads
        ratio = None
        if self._tier_status is not None:
            try:
                ws = self._tier_status().get("warm_store") or {}
                ratio = ws.get("compress_ratio")
            except Exception:
                ratio = None
        page_cost = self.page_bytes
        if page_cost and ratio and ratio > 0:
            page_cost = page_cost / ratio
        out = []
        for mult in (0.5, 1.0, 2.0, 4.0):
            n = max(1, int(c_dev * mult))
            hr = self.sampler.hit_rate_at(c_dev + n)
            row = {
                "warm_pages": n,
                "warm_x": mult,
                "hit_rate": round(hr, 4),
                "extra_hit_rate": round(max(0.0, hr - base), 4),
            }
            if per_page_ms is not None:
                row["readmit_ms_per_page"] = round(per_page_ms, 4)
            if page_cost:
                row["warm_host_bytes"] = int(n * page_cost)
                if ratio:
                    row["compress_ratio"] = ratio
            out.append(row)
        return out

    def cold_resume_model(self) -> Dict[str, Any]:
        """Cold tier = re-prefill from the broker log. TTFT estimate =
        conversation tokens over the profiler's measured prefill tokens
        per device-second."""
        rate = None
        try:
            from .profiler import profile_enabled, profiler
            if profile_enabled():
                tokens = 0
                dev_s = 0.0
                for row in profiler().dispatch_profile():
                    tokens += row.get("packed_tokens", 0)
                    dev_s += row.get("variant_device_s", 0.0)
                if tokens and dev_s > 0:
                    rate = tokens / dev_s
        except Exception:
            rate = None
        out: Dict[str, Any] = {"prefill_tokens_per_device_s": (
            round(rate, 1) if rate else None)}
        if rate:
            toks = sorted(t for _, _, _, _, _, t
                          in self.conversations.snapshot() if t)
            if toks:
                n = len(toks)
                out["resume_ttft_est_s"] = {
                    "p50": round(toks[n // 2] / rate, 4),
                    "p95": round(toks[min(n - 1, (n * 19) // 20)] / rate, 4),
                    "max": round(toks[-1] / rate, 4),
                }
        return out

    def verdict(self) -> Optional[str]:
        """The one-line sizing answer: the smallest modeled warm tier
        whose extra hit rate clears 1%."""
        if not self.sampler.sampled:
            return None
        c_dev = self.device_capacity()
        base = self.sampler.hit_rate_at(c_dev)
        for row in self.warm_tier_model():
            if row["extra_hit_rate"] >= 0.01:
                return (f"warm tier of {row['warm_pages']} pages "
                        f"({row['warm_x']}x device) buys "
                        f"{row['extra_hit_rate'] * 100:.1f}% hit rate "
                        f"(device-only {base * 100:.1f}%)")
        return (f"device pool already captures the working set "
                f"(hit rate {base * 100:.1f}% at 1x; no modeled warm "
                f"tier adds >=1%)")

    def tier_validation(self) -> Optional[Dict[str, Any]]:
        """Predicted vs measured warm tier.

        The what-if model priced a ghost warm tier from sampled reuse
        distances; now a real one is running. Among arrivals that MISSED
        the device pool, the model predicts the share the warm tier
        recovers as ``extra_hit_rate / (1 - device_hit_rate)``; the
        tier manager measures the same share directly as
        ``promotions / (promotions + cold_resumes)``. Drift beyond
        ``SWARMDB_MEM_TIER_DRIFT`` (default 0.2 absolute) flags the
        model as stale — wrong sampling rate, non-stationary workload,
        or a warm store sized below what the curve assumed.
        """
        if self._tier_status is None:
            return None
        try:
            st = self._tier_status()
        except Exception:
            return None
        counters = st.get("counters", {})
        promotions = int(counters.get("promotions", 0))
        cold = int(counters.get("cold_resumes", 0))
        warm_pages = int(st.get("pages", {}).get("warm", 0))
        resumes = promotions + cold
        out: Dict[str, Any] = {
            "warm_pages": warm_pages,
            "promotions": promotions,
            "cold_resumes": cold,
            "measured_warm_share": (round(promotions / resumes, 4)
                                    if resumes else None),
            "predicted_warm_share": None,
            "drift": None,
            "drifted": False,
        }
        if self.sampler.sampled and warm_pages > 0:
            c_dev = self.device_capacity()
            base = self.sampler.hit_rate_at(c_dev)
            extra = max(0.0, self.sampler.hit_rate_at(c_dev + warm_pages)
                        - base)
            miss = max(1e-9, 1.0 - base)
            out["predicted_warm_share"] = round(min(1.0, extra / miss), 4)
        if (out["measured_warm_share"] is not None
                and out["predicted_warm_share"] is not None
                and resumes >= _env_int("SWARMDB_MEM_TIER_MIN_RESUMES", 20)):
            drift = out["measured_warm_share"] - out["predicted_warm_share"]
            out["drift"] = round(drift, 4)
            out["drifted"] = abs(drift) > _env_float(
                "SWARMDB_MEM_TIER_DRIFT", 0.2)
        return out

    # ------------------------------------------------------------- surfaces

    def counters_snapshot(self) -> Dict[str, Any]:
        """Cumulative totals for window-delta consumers (the SLO
        sentinel)."""
        pt = self.prefix_totals()
        occ = self.occupancy()
        return {
            "hit_tokens": pt["hit_tokens"],
            "miss_tokens": pt["miss_tokens"],
            "lookups": pt["lookups"],
            "full_misses": pt["full_misses"],
            "pool_total_pages": occ["total_pages"],
            "pool_headroom_pages": occ["headroom_pages"],
            "conv_touches": self.conversations.touches_total,
            "mono_ns": time.monotonic_ns(),
        }

    def report(self) -> Dict[str, Any]:
        """The ``GET /admin/mem`` payload / dump body."""
        pt = self.prefix_totals()
        denom = pt["hit_tokens"] + pt["miss_tokens"]
        c_dev = self.device_capacity()
        return {
            "kind": "swarmdb.mem",
            "version": 1,
            "enabled": self.enabled and memprof_enabled(),
            "page_bytes": self.page_bytes,
            "hot_s": self.hot_s,
            "warm_s": self.warm_s,
            "occupancy": self.occupancy(),
            "prefix": dict(pt, hit_rate=round(
                pt["hit_tokens"] / denom, 4) if denom else None),
            "conversations": self.conversations.report(
                self.hot_s, self.warm_s),
            "reuse": dict(self.sampler.stats(),
                          device_capacity_pages=c_dev,
                          curve=self.sampler.curve(c_dev)),
            "warm_tier": self.warm_tier_model(),
            "cold_resume": self.cold_resume_model(),
            "tier_validation": self.tier_validation(),
            "verdict": self.verdict(),
        }

    def mem_profile(self) -> Dict[str, Any]:
        """A compact block for a benchmark record (beside the profiler's
        ``kernel_profile``)."""
        pt = self.prefix_totals()
        denom = pt["hit_tokens"] + pt["miss_tokens"]
        occ = self.occupancy()
        conv = self.conversations.report(self.hot_s, self.warm_s, top=0)
        c_dev = self.device_capacity()
        return {
            "prefix_hit_rate": (round(pt["hit_tokens"] / denom, 4)
                                if denom else None),
            "lookups": pt["lookups"],
            "full_misses": pt["full_misses"],
            "occupancy": {k: occ[k] for k in
                          ("total_pages", "free", "active",
                           "cached_evictable", "pinned",
                           "headroom_pages")},
            "conversations": conv["by_state"],
            "curve": {str(r["capacity_x"]): r["hit_rate"]
                      for r in self.sampler.curve(c_dev)},
            "sampled_accesses": self.sampler.sampled,
            "tier_validation": self.tier_validation(),
            "verdict": self.verdict(),
        }

    # -------------------------------------------------------- prometheus

    def prometheus_lines(self) -> List[str]:
        """``swarmdb_mem_*`` + ``swarmdb_conversation_temperature`` for
        /metrics (gated by memprof_enabled(); the flag-independent pool
        and prefix gauges are rendered by the API layer directly)."""
        lines: List[str] = []
        occ = self.occupancy()
        lines.append("# TYPE swarmdb_mem_pool_pages gauge")
        for state in ("free", "active", "cached_evictable", "pinned"):
            lines.append(
                f'swarmdb_mem_pool_pages{{state="{state}"}} {occ[state]}')
        lines.append("# TYPE swarmdb_mem_headroom_pages gauge")
        lines.append(f"swarmdb_mem_headroom_pages {occ['headroom_pages']}")
        conv = self.conversations.report(self.hot_s, self.warm_s, top=0)
        lines.append("# TYPE swarmdb_conversation_temperature gauge")
        for state in ("hot", "warm", "cold"):
            lines.append(
                f'swarmdb_conversation_temperature{{state="{state}"}} '
                f"{conv['by_state'][state]}")
        sst = self.sampler.stats()
        lines.append("# TYPE swarmdb_mem_sampled_accesses_total counter")
        lines.append(
            f"swarmdb_mem_sampled_accesses_total {sst['sampled']}")
        c_dev = self.device_capacity()
        lines.append("# TYPE swarmdb_mem_curve_hit_rate gauge")
        for row in self.sampler.curve(c_dev):
            lines.append(
                f'swarmdb_mem_curve_hit_rate{{capacity="'
                f'{row["capacity_x"]}x"}} {row["hit_rate"]}')
        return lines

    # -------------------------------------------------------------- dumps

    def _dump_identity(self) -> str:
        raw = os.environ.get("SWARMDB_NODE_ID") or f"p{os.getpid()}"
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def dump_to(self, directory: str, reason: str = "on_demand") -> str:
        """Write the report under ``directory`` (atomic, collision-free
        filename). ``mem_*.json`` files next to flight dumps are listed
        by ``obs/analyze.py`` and consumed by its ``--memory`` mode."""
        os.makedirs(directory, exist_ok=True)
        payload = self.report()
        payload["dumped_at"] = time.time()
        payload["node"] = self._dump_identity()
        payload["reason"] = reason
        path = os.path.join(
            directory,
            f"mem_{self._dump_identity()}_{next(_DUMP_SEQ)}_"
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
        if not directory or not (self.enabled and memprof_enabled()):
            return None
        try:
            return self.dump_to(directory, reason)
        except Exception:
            logger.exception("mem dump failed (%s)", reason)
            return None

    def reset(self) -> None:
        """Drop everything (tests / sub-run isolation). Existing
        pool handles keep recording; their stamps re-anchor."""
        self.sampler.reset()
        self.conversations.reset()
        with self._lock:
            pools = list(self._pools)
            # drop handles whose owners are gone (engines are rebuilt
            # per sub-run; dead registrations would pile up forever)
            self._pools = [p for p in pools
                           if p.owner_stats() is not None]
            self._probes = [pr for pr in self._probes
                            if pr.owner_stats() is not None]
        for p in pools:
            p.ages.clear()
            p.alloc_events = 0
            p.free_events = 0


_MEMPROF: Optional[MemProfiler] = None
_MEMPROF_LOCK = make_lock("obs.memprof._MEMPROF_LOCK")


def memprof() -> MemProfiler:
    """The process-global accountant (lazy — brokers/analyzers that
    never serve a token pay nothing)."""
    global _MEMPROF
    if _MEMPROF is None:
        with _MEMPROF_LOCK:
            if _MEMPROF is None:
                _MEMPROF = MemProfiler()
    return _MEMPROF
