"""The three-tier conversation-state hierarchy: device pool -> pinned host
memory -> log replay.

The counterpart of ``swarmdb_tpu/backend/tiering.py``, on the card:

    HOT   the engine's device page pool (rolling KV's kept pages)
      |  demote: the coldest idle conversations by the temperature
      |  ledger, when the backpressure gate's SWARMDB_TIER_DEMOTE band
      |  trips or paged admission fails to allocate. One batched gather
      |  per pool into the warm store's page-locked slab, copied
      |  asynchronously on the engine's stream; an event passes before
      |  the store publishes the entry
      v
    WARM  host page store (``ops/host_pool.py``): raw storage-width
      |   payloads keyed by conversation. On the conversation's next turn
      |   promotion reserves device pages and the engine copies the exact
      |   bytes back in place before the resume prefill reads them
      v
    COLD  nothing: the conversation's next turn prefills its whole window
          from the broker log (the supervisor's replay path proved that
          replay gives the same tokens)

Threading, as in the JAX package:

- the tier WORKER thread only plans (victim selection over the rolling
  registry, under the service's registry lock) and queues demote orders;
- all device work runs on the ENGINE thread, on its stream, in program
  order with the decode graphs and the admission writes: orders drain at
  the start of each paged admission round (``Engine._admit_paged`` calls
  ``on_tier_drain`` right after the pending-free flush), promotion
  payloads ride the resumed ``GenRequest`` into admission
  (``Engine._promote_insert``);
- ``demote_now`` runs when paged admission failed to allocate
  (``ServingService._on_pool_pressure``: engine thread, registry lock
  held), spilling idle conversations before any is evicted to nothing.

Under the page sanitizer (``SWARMDB_PAGECHECK=1``, ``obs/pagecheck.py``)
every move is mirrored into the pool's shadow state, as in the JAX
package: a demotion marks the pages ``host_resident`` before the gather,
a promotion turns its reserved pages into rolling custody, and a warm
entry that leaves the store without promotion clears its key. Referencing
a demoted page, demoting a key twice and promoting into pages that were
not reserved are violations.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..obs.tracer import TRACER
from ..ops.host_pool import HostPageStore
from ..ops.paged_kv import pool_gather_pages

logger = logging.getLogger("swarmdb_tpu_torch.backend")

__all__ = ["TierManager", "select_victims", "tiering_enabled"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def tiering_enabled() -> bool:
    """``SWARMDB_TIER`` (default on; the tier engages only on rolling
    paged engines)."""
    return os.environ.get("SWARMDB_TIER", "1") not in ("", "0")


def select_victims(cands: Sequence[Tuple[Any, int, float, int]],
                   need_pages: int, now: float,
                   min_idle_s: float) -> List[Any]:
    """Demotion victims, coldest first. ``cands``: ``(key, n_pages,
    last_touch_ts, touches)`` per device-resident idle conversation,
    ordered by oldest last touch, then fewest touches; entries idle less
    than ``min_idle_s`` are never picked (no thrash on a conversation
    about to come back). Returns keys covering at least ``need_pages``
    pages, or every eligible key when they cannot."""
    eligible = [c for c in cands if now - c[2] >= min_idle_s]
    eligible.sort(key=lambda c: (c[2], c[3]))
    out: List[Any] = []
    got = 0
    for key, n_pages, _last, _touches in eligible:
        if got >= need_pages:
            break
        out.append(key)
        got += n_pages
    return out


class TierManager:
    """One engine's tier manager: the warm store, the cold ledger, victim
    selection and the demote / promote counters. ``ServingService``
    attaches it when rolling KV runs on a paged engine."""

    def __init__(self, service: Any, engine: Any,
                 store: Optional[HostPageStore] = None) -> None:
        self.service = service
        self.engine = engine
        self.store = (store if store is not None else
                      HostPageStore(pinned=engine.device.type == "cuda"))
        self.min_idle_s = _env_float("SWARMDB_TIER_MIN_IDLE_S", 0.5)
        # conversations evicted out of the hierarchy, with their page
        # footprint: bounded LRU accounting (an aged-out key just counts
        # as "fresh" instead of "cold")
        self._cold_cap = int(_env_float("SWARMDB_TIER_COLD_TRACK", 200000))
        self._cold: "OrderedDict[Any, Tuple[float, int]]" = OrderedDict()
        self._cold_lock = threading.Lock()
        # demote orders planned by the worker, run by the engine thread
        self._orders: "deque[Any]" = deque()
        self._need = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.demotions = 0
        self.promotions = 0
        self.cold_resumes = 0
        self.warm_evictions = 0
        # pages moved and seconds spent, each way (the demote gathers are
        # timed to their event; promotions in Engine._promote_insert)
        self.demoted_pages = 0
        self.demote_s = 0.0
        engine.on_tier_pressure = self.notify_pressure
        engine.on_tier_drain = self.drain_engine
        # the memory accountant's tier_validation holds its what-if warm
        # tier against this tier's measured promotions and cold resumes
        from ..obs.memprof import memprof

        memprof().bind_tier(self.status)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "TierManager":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="swarmdb-torch-tier", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def close(self) -> None:
        """Stop for good (a stopped manager never restarts its worker)
        and release the warm store's page-locked slab now, to the system
        (``HostPageStore.close``). The engine's hooks and this manager
        reference each other, as do the manager and its service, so
        without this the slab would wait for a cyclic garbage collection
        after the last outside reference went, and then stay in PyTorch's
        caching host allocator; a store built meanwhile would be
        page-locked beside it. Call it once the engine's loop has
        stopped."""
        self.stop()
        if self.engine.on_tier_pressure == self.notify_pressure:
            self.engine.on_tier_pressure = None
        if self.engine.on_tier_drain == self.drain_engine:
            self.engine.on_tier_drain = None
        self._orders.clear()
        # promotion copies still in flight read the slab's views
        self.engine.release_promote_sources()
        self.store.close()

    # ---------------------------------------------------- pressure / worker

    def notify_pressure(self, need: int) -> None:
        """Engine thread, the gate's demote band: a non-blocking signal;
        the worker plans."""
        self._need = max(self._need, int(need))
        if self._thread is None and not self._stop.is_set():
            self.start()
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            need, self._need = self._need, 0
            if need <= 0:
                continue
            try:
                self._plan(need)
            except Exception:
                logger.exception("tier demotion planning failed")

    def _candidates(self, touches: Dict[Any, int]
                    ) -> List[Tuple[Any, int, float, int]]:
        """Device-resident idle conversations of the current epoch
        (registry lock held)."""
        epoch = self.engine.pool_epoch()
        return [(k, len(st["pages"]), st["last"], touches.get(k, 0))
                for k, st in self.service._rolling.items()
                if st.get("pages") and not st.get("in_flight")
                and st["epoch"] == epoch]

    def _plan(self, need: int) -> None:
        """Worker thread: pick victims under the registry lock, claim them
        (``tier_demote`` + ``in_flight``, so no plan or eviction races the
        order) and queue them for the engine's next admission round."""
        svc = self.service
        if svc._rolling is None:
            return
        now = time.time()
        touches = {row[0]: int(row[2]) for row in svc._mem.snapshot()}
        with svc._rolling_lock:
            victims = select_victims(self._candidates(touches), need, now,
                                     self.min_idle_s)
            for k in victims:
                st = svc._rolling[k]
                st["in_flight"] = True
                st["tier_demote"] = True
                self._orders.append(k)

    # ------------------------------------------------- engine-thread work

    def drain_engine(self) -> None:
        """Engine thread, start of a paged admission round: run the
        worker's planned demotions."""
        if not self._orders:
            return
        svc = self.service
        with svc._rolling_lock:
            while self._orders:
                key = self._orders.popleft()
                st = svc._rolling.get(key) if svc._rolling else None
                if (st is None or not st.get("tier_demote")
                        or not st.get("pages")):
                    continue
                st.pop("tier_demote", None)
                self._demote_locked(key, st)

    def demote_now(self, need: int) -> int:
        """Engine thread, registry lock held (the pool-pressure hook):
        spill the coldest idle conversations to cover ``need`` pages.
        Returns the pages freed; the caller evicts to nothing for any
        shortfall."""
        svc = self.service
        if svc._rolling is None:
            return 0
        freed = 0
        for key in select_victims(self._candidates({}), need, time.time(),
                                  self.min_idle_s):
            st = svc._rolling.get(key)
            if st is None or not st.get("pages"):
                continue
            st["in_flight"] = True
            st.pop("tier_demote", None)
            freed += self._demote_locked(key, st)
        return freed

    def _demote_locked(self, key: Any, st: Dict[str, Any]) -> int:
        """Engine thread, registry lock held: copy the entry's pages to
        host memory, hand them to the warm store, free the device ids.
        Any failure degrades to a cold eviction, never a leak."""
        eng = self.engine
        pages = list(st["pages"])
        if st["epoch"] != eng.pool_epoch():
            # the pool was rebuilt under the claim: the reset reclaimed
            # the ids already
            self._finish_cold(key, st, len(pages), free=False)
            return 0
        pc = getattr(eng, "_pagecheck", None)
        if pc is not None:
            pc.on_demote(pages, key)
        t0 = time.perf_counter()
        evicted: List[Any] = []

        def host(shape, dtype):
            # the store's slab, older warm entries evicted for room
            t, out = self.store.host_tensor(shape, dtype, evict=True)
            evicted.extend(out)
            return t

        try:
            k_pay = pool_gather_pages(eng.cache["k"], pages, host)
            v_pay = (pool_gather_pages(eng.cache["v"], pages, host)
                     if k_pay is not None else None)
            if eng.device.type == "cuda":
                # the copies were enqueued on the engine's stream: the
                # payload is published only once they have landed
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        except Exception:
            logger.exception("tier demote gather failed for %r", key)
            k_pay = v_pay = None
        if v_pay is not None:
            self.demote_s += time.perf_counter() - t0
            self.demoted_pages += len(pages)
            evicted += self.store.put(key, k_pay, v_pay, len(pages),
                                      st["len"])
        for ek in evicted:
            if ek != key:
                # an older warm entry fell out to make room: cold now
                self._warm_to_cold(ek)
        if v_pay is None or key in evicted:
            # larger than the whole store (or the copy failed): straight
            # to cold
            self._finish_cold(key, st, len(pages), free=True)
            return len(pages)
        eng.rolling_free(pages)
        st["pages"] = None
        st["host"] = True
        st["in_flight"] = False
        self.demotions += 1
        self.service.db.metrics.counters["tier_demotions"].inc()
        self.service._mem.resident(key, 0)
        TRACER.instant("tier.demote", cat="tier", args={"pages": len(pages)})
        eng.flight.record_event({"kind": "tier.demote", "ts": time.time(),
                                 "pages": len(pages)})
        return len(pages)

    def _finish_cold(self, key: Any, st: Dict[str, Any], n_pages: int,
                     free: bool) -> None:
        """Registry lock held: drop the entry out of the hierarchy."""
        eng = self.engine
        if free and st.get("pages") and st["epoch"] == eng.pool_epoch():
            eng.rolling_free(st["pages"])
        self.service._rolling.pop(key, None)
        self.service._mem.drop(key)
        pc = getattr(eng, "_pagecheck", None)
        if pc is not None:
            pc.on_host_drop(key)
        self.note_cold(key, n_pages)

    def _warm_to_cold(self, key: Any) -> None:
        """A warm entry was evicted from the store (registry lock held):
        its registry entry, if still host-resident, goes with it."""
        svc = self.service
        st = svc._rolling.get(key) if svc._rolling is not None else None
        n = 0
        if st is not None and st.get("host") and not st.get("pages"):
            ps = max(1, self.engine.rolling_page_size())
            n = -(-st["len"] // ps)
            svc._rolling.pop(key, None)
            svc._mem.drop(key)
        pc = getattr(self.engine, "_pagecheck", None)
        if pc is not None:
            pc.on_host_drop(key)
        self.warm_evictions += 1
        svc.db.metrics.counters["tier_warm_evictions"].inc()
        self.note_cold(key, n)

    # ------------------------------------------------------ promotion (plan)

    def begin_promote(self, key: Any, st: Dict[str, Any],
                      epoch: int) -> Optional[Tuple[List[int], Any]]:
        """Service thread, registry lock held (``_rolling_plan``): a
        warm conversation arrived. Reserve its device pages and return
        ``(page_ids, payload)`` for the engine's copy back, or None when
        the warm copy is gone or the pool cannot host it even after
        evicting (the caller restarts the conversation cold)."""
        eng = self.engine
        entry = self.store.pop(key)
        if entry is None:
            return None
        alloc = eng.paged.allocator
        n = entry.n_pages
        ids = alloc.reserve(n)
        if len(ids) < n:
            try:
                self.service._rolling_evict(n - len(ids))
                ids += alloc.reserve(n - len(ids))
            except BaseException:
                alloc.add_free(ids)  # nothing owns them yet
                raise
        pc = getattr(eng, "_pagecheck", None)
        if len(ids) < n:
            alloc.add_free(ids)
            if pc is not None:
                pc.on_host_drop(key)
            self.note_cold(key, n)
            return None
        if pc is not None:
            pc.on_promote(ids, key)
        self.promotions += 1
        self.service.db.metrics.counters["tier_promotions"].inc()
        self.service._mem.resident(key, n)
        TRACER.instant("tier.promote", cat="tier", args={"pages": n})
        eng.flight.record_event({"kind": "tier.promote", "ts": time.time(),
                                 "pages": n})
        return ids, (entry.k, entry.v)

    def drop_warm(self, key: Any) -> None:
        """The warm copy is obsolete (restart, or a non-clean finish):
        discard it without cold accounting."""
        self.store.drop(key)
        pc = getattr(self.engine, "_pagecheck", None)
        if pc is not None:
            pc.on_host_drop(key)

    # ---------------------------------------------------------- cold ledger

    def note_cold(self, key: Any, n_pages: int = 0) -> None:
        with self._cold_lock:
            self._cold.pop(key, None)
            self._cold[key] = (time.time(), int(n_pages))
            while len(self._cold) > self._cold_cap:
                self._cold.popitem(last=False)

    def take_cold(self, key: Any) -> bool:
        """A fresh prefill is about to serve ``key``: True when it was
        evicted out of the hierarchy (a cold resume, re-prefilled from the
        broker log) rather than brand new."""
        with self._cold_lock:
            hit = self._cold.pop(key, None)
        if hit is None:
            return False
        self.cold_resumes += 1
        self.service.db.metrics.counters["tier_cold_resumes"].inc()
        TRACER.instant("tier.cold_resume", cat="tier")
        self.engine.flight.record_event({"kind": "tier.cold_resume",
                                         "ts": time.time()})
        return True

    # ------------------------------------------------------------------ intro

    def pages_by_tier(self) -> Dict[str, int]:
        """hot = device pages out of the free list (slots, prefix cache,
        registry); warm = pages in the host store; cold = last-known
        footprint of conversations evicted out of the hierarchy."""
        eng = self.engine
        hot = max(0, eng.paged.num_pages - 1
                  - eng.paged.allocator.free_count())
        with self._cold_lock:
            cold = sum(n for _, n in self._cold.values())
        return {"hot": hot, "warm": self.store.page_count(), "cold": cold}

    def status(self) -> Dict[str, Any]:
        """The JAX package's ``status()`` keys (``/admin/tiers``)."""
        eng = self.engine
        with self._cold_lock:
            cold_conversations = len(self._cold)
        return {
            "enabled": True,
            "pages": self.pages_by_tier(),
            "warm_store": self.store.stats(),
            "cold_conversations": cold_conversations,
            "counters": {
                "demotions": self.demotions,
                "promotions": self.promotions,
                "cold_resumes": self.cold_resumes,
                "warm_evictions": self.warm_evictions,
            },
            "warm_hit_rate": (self.promotions
                              / max(1, self.promotions + self.cold_resumes)),
            "config": {
                "min_idle_s": self.min_idle_s,
                "demote_watermark": getattr(eng, "_bp_demote", None),
                "warm_capacity_bytes": self.store.capacity_bytes,
            },
            "pending_orders": len(self._orders),
        }
