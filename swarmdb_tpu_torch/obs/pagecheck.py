"""Runtime page sanitizer: ASan for the KV page pool, a copy of
``swarmdb_tpu/obs/pagecheck.py``.

When ``SWARMDB_PAGECHECK=1``, every page pool the package allocates
through the factories in ``ops/paged_kv.py`` / ``ops/prefix_cache.py`` is
a thin checked subclass that keeps **shadow state per page**:

- a state machine -- ``free`` / ``owned`` (by a slot) / ``cached``
  (prefix-cache or rolling custody) / ``reserved`` (chaos withdrawal,
  promotion target) / ``host_resident`` (demoted to the warm tier or in
  the fleet's transit store) / ``trash`` (page 0, never allocatable) --
  with pin counts overlaid; double-free, free-of-pinned, allocation of a
  live page, and unpin-without-pin are violations,
- an **alloc epoch** per page plus per-slot **row stamps**: the engine
  validates the stamps at dispatch, so a page freed and re-allocated
  between admission and dispatch is an ``epoch-mismatch`` violation,
- **ownership metadata** (owner slot, request id, lane, acquiring stack),
  so a referenced page the row does not hold -- the cross-lane aliasing a
  migrated ``resume_pages`` list can cause -- is a ``stale-reference``
  violation naming both owners,
- a **canary**: the engine poisons freed pages' device K/V in place on
  its stream and verifies them intact on re-allocation
  (``ops.paged_kv.canary_fill`` / ``canary_check``), catching writes-
  after-free that no host-side bookkeeping can see.

The checked allocators mirror the custody moves of
:class:`~swarmdb_tpu_torch.ops.paged_kv.PageAllocator` at its public
methods (``allocate_with_prefix``, ``add_free``, ``reserve``,
``release_taken``, ``transfer_to_cache`` and ``reset``);
``CheckedShardedPageAllocator`` does the same over the slot-affine pool
of a data axis, with every shard's trash page registered as trash. The
same sequence of calls gives the same violations as the JAX package's
checked allocators (tests/test_torch_pagecheck.py).

Violations are recorded once, written to attached flight recorders as
``pagecheck.violation`` instants, dumped immediately to
``pagecheck_<node>.json`` in ``SWARMDB_FLIGHT_DIR``, surfaced at
``GET /admin/pagecheck``, and exported on ``/metrics`` as
``swarmdb_page_violations_total`` + ``swarmdb_page_state{state=}``.

With the flag off (default) the factories return the plain classes and
this module is never imported (type identity pinned by
tests/test_torch_pagecheck.py).

The registry's mutex is a *leaf* lock (taken under the allocator's lock,
never the reverse; no user code runs under it).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("swarmdb_tpu_torch.obs")

__all__ = ["enabled", "registry", "PageCheckRegistry", "PoolHandle",
           "CheckedPageAllocator", "CheckedPrefixLRU",
           "CheckedShardedPageAllocator"]


def enabled() -> bool:
    return os.environ.get("SWARMDB_PAGECHECK", "0") not in ("", "0")


def _short_stack(skip: int = 3, limit: int = 5) -> List[str]:
    out = []
    for fr in reversed(traceback.extract_stack()[:-skip]):
        if fr.filename.endswith(("pagecheck.py",)):
            continue
        out.append(f"{os.path.basename(fr.filename)}:{fr.lineno} "
                   f"{fr.name}")
        if len(out) >= limit:
            break
    return out


class _Page:
    __slots__ = ("state", "epoch", "owner_slot", "owner_rid", "pins",
                 "stack", "poisoned")

    def __init__(self, state: str = "free") -> None:
        self.state = state
        self.epoch = 0
        self.owner_slot: Optional[int] = None
        self.owner_rid: Optional[str] = None
        self.pins = 0
        self.stack: List[str] = []
        self.poisoned = False


class _Pool:
    def __init__(self, pool_id: int, label: str, num_pages: int,
                 trash: Sequence[int]) -> None:
        self.pool_id = pool_id
        self.label = label
        self.num_pages = num_pages
        self.pages: Dict[int, _Page] = {
            p: _Page("trash" if p in set(trash) else "free")
            for p in range(num_pages)}
        # slot -> [(page, epoch)] recorded when the row was built
        self.row_stamps: Dict[int, List[Tuple[int, int]]] = {}
        self.owner_rids: Dict[int, str] = {}
        # conversation keys whose pages were demoted to the warm tier
        # (cleared by on_promote / on_host_drop)
        self.host_keys: set = set()
        self.lane: Optional[str] = None
        self.churn_allocated = 0
        self.churn_freed = 0

    def state_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for pg in self.pages.values():
            key = "pinned" if pg.pins > 0 else pg.state
            out[key] = out.get(key, 0) + 1
        return out


class PageCheckRegistry:
    """Process-global shadow state over every checked pool."""

    def __init__(self) -> None:
        # leaf lock (module docstring): taken under pool locks, never
        # holds one, no user code runs under it
        self._mu = threading.Lock()
        self._pools: Dict[int, _Pool] = {}
        self._next_pool = 0
        self._epoch = 0
        self._violations: List[Dict[str, Any]] = []
        self._violation_keys: set = set()
        self._flights: List[Any] = []
        self._atexit_armed = False

    # ------------------------------------------------------------ wiring

    def attach_flight(self, recorder: Any) -> None:
        with self._mu:
            if recorder not in self._flights:
                self._flights.append(recorder)

    def register_pool(self, num_pages: int, trash: Sequence[int],
                      label: Optional[str] = None) -> "PoolHandle":
        with self._mu:
            pool_id = self._next_pool
            self._next_pool += 1
            pool = _Pool(pool_id, label or f"pool{pool_id}", num_pages,
                         trash)
            self._pools[pool_id] = pool
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._atexit_dump)
        return PoolHandle(self, pool_id)

    # ----------------------------------------------------------- events
    # All on_* methods may be called under the owning allocator's lock;
    # violation side effects (flight instants, dump) run OUTSIDE _mu.

    # swarmlint: holds[self._mu]
    def _violation(self, pool: _Pool, kind: str, message: str,
                   pages: Sequence[int]) -> Optional[Dict[str, Any]]:
        """Called under ``self._mu``; dedup by (pool, kind, pages)."""
        key = (pool.pool_id, kind, tuple(sorted(pages)[:8]))
        if key in self._violation_keys:
            return None
        self._violation_keys.add(key)
        v = {
            "kind": kind,
            "pool": pool.label,
            "lane": pool.lane,
            "pages": sorted(pages)[:32],
            "message": message,
            "thread": threading.current_thread().name,
            "stack": _short_stack(),
            "detected_at": time.time(),
        }
        self._violations.append(v)
        return v

    def _emit(self, violation: Optional[Dict[str, Any]]) -> None:
        """Side effects OUTSIDE the mutex."""
        if violation is None:
            return
        logger.warning("pagecheck: %s violation in %s: %s",
                       violation["kind"], violation["pool"],
                       violation["message"])
        # swarmlint: disable=SWL303 -- benign racy snapshot of an append-only list: flight rings take their own locks
        for fl in list(self._flights):
            try:
                fl.record_event({
                    "kind": "pagecheck.violation",
                    "ts": time.time(),
                    "violation_kind": violation["kind"],
                    "pool": violation["pool"],
                    "pages": violation["pages"],
                })
            except Exception:
                pass
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if directory:
            try:
                self.dump_to(directory)
            except Exception:
                logger.exception("pagecheck dump failed")

    def on_take(self, pool_id: int, pages: Sequence[int],
                slot: int) -> None:
        """Pages handed out by the allocator free-list."""
        with self._mu:
            pool = self._pools[pool_id]
            bad = []
            self._epoch += 1
            for p in pages:
                pg = pool.pages[p]
                if pg.state != "free":
                    bad.append(p)
                pg.state = "owned"
                pg.epoch = self._epoch
                pg.owner_slot = slot
                pg.owner_rid = pool.owner_rids.get(slot)
                pg.stack = _short_stack()
            pool.churn_allocated += len(pages)
            v = None
            if bad:
                v = self._violation(
                    pool, "alloc-live-page",
                    f"allocator handed out page(s) {bad} that were not "
                    f"free — the free list and the shadow state "
                    f"disagree (double-registration or table "
                    f"corruption)", bad)
        self._emit(v)

    def on_give(self, pool_id: int, pages: Sequence[int]) -> None:
        """Pages returned to the free list."""
        with self._mu:
            pool = self._pools[pool_id]
            dbl, pinned = [], []
            for p in pages:
                pg = pool.pages.get(p)
                if pg is None:
                    continue
                if pg.state == "free":
                    dbl.append(p)
                    continue
                if pg.pins > 0:
                    pinned.append(p)
                pg.state = "free"
                pg.owner_slot = None
                pg.owner_rid = None
                pg.pins = 0
                pg.poisoned = False
            pool.churn_freed += len(pages)
            v1 = v2 = None
            if dbl:
                v1 = self._violation(
                    pool, "double-free",
                    f"page(s) {dbl} freed twice — two future "
                    f"allocations will alias the same pages", dbl)
            if pinned:
                v2 = self._violation(
                    pool, "free-pinned",
                    f"page(s) {pinned} freed while pinned — an active "
                    f"slot's attention still reads them", pinned)
        self._emit(v1)
        self._emit(v2)

    def on_reserve(self, pool_id: int, pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages[p]
                pg.state = "reserved"
                pg.owner_slot = None

    def on_reference(self, pool_id: int, slot: int,
                     pages: Sequence[int]) -> None:
        """A row is about to REFERENCE (not own) these pages: prefix
        hits and rolling resume pages. They must be live in THIS pool
        — a freed page, a reserved page, or a page id from another
        lane's pool (cross-lane aliasing after a migration replay) all
        fail here."""
        with self._mu:
            pool = self._pools[pool_id]
            bad: List[Tuple[int, str]] = []
            demoted: List[int] = []
            for p in pages:
                pg = pool.pages.get(p)
                if pg is None:
                    bad.append((p, "not a page of this pool"))
                elif pg.state == "host_resident":
                    demoted.append(p)
                elif pg.state not in ("owned", "cached"):
                    bad.append((p, f"state={pg.state}"))
            v = v2 = None
            if bad:
                detail = ", ".join(f"{p} ({why})" for p, why in bad)
                v = self._violation(
                    pool, "stale-reference",
                    f"slot {slot} (rid="
                    f"{pool.owner_rids.get(slot)}) references dead or "
                    f"foreign page(s): {detail} — the row would alias "
                    f"pages this conversation does not own",
                    [p for p, _ in bad])
            if demoted:
                v2 = self._violation(
                    pool, "use-after-demote",
                    f"slot {slot} (rid="
                    f"{pool.owner_rids.get(slot)}) references demoted "
                    f"page(s) {demoted} — their contents left for the "
                    f"warm tier; the device copy is about to be freed "
                    f"and reallocated (promote first, or re-prefill "
                    f"cold)", demoted)
        self._emit(v)
        self._emit(v2)

    def stamp_row(self, pool_id: int, slot: int,
                  pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            pool.row_stamps[slot] = [
                (p, pool.pages[p].epoch) for p in pages
                if p in pool.pages and pool.pages[p].state != "trash"]

    def validate_row(self, pool_id: int, slot: int) -> None:
        """Dispatch-time check: every page the slot's row was built on
        is still live at the epoch it was stamped with."""
        with self._mu:
            pool = self._pools[pool_id]
            stamps = pool.row_stamps.get(slot)
            if not stamps:
                return
            bad: List[Tuple[int, str]] = []
            for p, epoch in stamps:
                pg = pool.pages.get(p)
                if pg is None or pg.state in ("free", "reserved"):
                    bad.append((p, "freed"))
                elif pg.epoch != epoch:
                    bad.append(
                        (p, f"epoch {epoch} -> {pg.epoch} (owner slot "
                            f"{pg.owner_slot}, rid {pg.owner_rid})"))
            v = None
            if bad:
                detail = ", ".join(f"{p}: {why}" for p, why in bad)
                v = self._violation(
                    pool, "epoch-mismatch",
                    f"slot {slot} dispatching a table row whose pages "
                    f"moved under it: {detail} — the stale-table/"
                    f"reused-page race", [p for p, _ in bad])
        self._emit(v)

    def on_evict(self, pool_id: int, pages: Sequence[int]) -> None:
        """Cached entries evicted straight into a new custody (the
        dense acquire path evicts and re-hands in one step): cached ->
        free silently; other states are left for on_take to police."""
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages.get(p)
                if pg is not None and pg.state == "cached" \
                        and pg.pins <= 0:
                    pg.state = "free"

    def on_to_cache(self, pool_id: int, pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages.get(p)
                if pg is not None and pg.state == "owned":
                    pg.state = "cached"
                    pg.owner_slot = None

    # -- cross-tier custody ------------------------------------------

    def on_demote(self, pool_id: int, pages: Sequence[int],
                  key: Any = None) -> None:
        """Conversation ``key``'s pages are leaving for the warm tier:
        their contents were gathered to host RAM and the device ids are
        about to return to the free list. Shadow state ``owned``/
        ``cached`` -> ``host_resident`` — a demoted page is NOT freed
        yet, and referencing it is a distinct ``use-after-demote``
        crime. Demoting a page you do not hold (free/reserved/trash) or
        demoting the same key twice without an intervening promote/drop
        are violations."""
        with self._mu:
            pool = self._pools[pool_id]
            dbl = key is not None and key in pool.host_keys
            bad, twice = [], []
            for p in pages:
                pg = pool.pages.get(p)
                if pg is None or pg.state in ("free", "reserved",
                                              "trash"):
                    bad.append(p)
                    continue
                if pg.state == "host_resident":
                    twice.append(p)
                    continue
                pg.state = "host_resident"
                pg.owner_slot = None
            if key is not None:
                pool.host_keys.add(key)
            v1 = v2 = None
            if bad:
                v1 = self._violation(
                    pool, "demote-of-free",
                    f"demotion gathered page(s) {bad} the conversation "
                    f"does not hold — the spilled payload would carry "
                    f"another owner's (or freed) pages to the warm "
                    f"tier", bad)
            if twice or dbl:
                v2 = self._violation(
                    pool, "double-demote",
                    f"key {key!r} demoted twice (pages {twice or pages}"
                    f") — two warm-tier payloads would claim the same "
                    f"conversation and the second gather reads pages "
                    f"already spilled", list(twice or pages))
        self._emit(v1)
        self._emit(v2)

    def on_promote(self, pool_id: int, pages: Sequence[int],
                   key: Any = None) -> None:
        """Warm payload re-admitted: ``pages`` are the freshly RESERVED
        device ids the payload was device_put into; they become rolling
        custody (``cached``). Promoting into pages the allocator did
        not reserve is a violation — the insert would overwrite live
        state."""
        with self._mu:
            pool = self._pools[pool_id]
            self._epoch += 1
            bad = []
            for p in pages:
                pg = pool.pages.get(p)
                if pg is None:
                    continue
                if pg.state != "reserved":
                    bad.append(p)
                pg.state = "cached"
                pg.epoch = self._epoch
                pg.owner_slot = None
            if key is not None:
                pool.host_keys.discard(key)
            v = None
            if bad:
                v = self._violation(
                    pool, "promote-unreserved",
                    f"promotion inserted into page(s) {bad} that were "
                    f"not reserved — the H2D bulk insert would "
                    f"overwrite pages another conversation owns", bad)
        self._emit(v)

    def on_host_drop(self, pool_id: int, key: Any) -> None:
        """A warm entry left the host store WITHOUT promotion (capacity
        eviction or finalize) — the conversation went cold. Clears the
        double-demote guard for the key."""
        with self._mu:
            self._pools[pool_id].host_keys.discard(key)

    def on_pin(self, pool_id: int, pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages.get(p)
                if pg is not None:
                    pg.pins += 1

    def on_unpin(self, pool_id: int, pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            bad = []
            for p in pages:
                pg = pool.pages.get(p)
                if pg is None:
                    continue
                if pg.pins <= 0:
                    bad.append(p)
                else:
                    pg.pins -= 1
            v = None
            if bad:
                v = self._violation(
                    pool, "unpin-unpinned",
                    f"page(s) {bad} unpinned without a matching pin — "
                    f"pin bookkeeping has drifted and evictable_count "
                    f"is wrong", bad)
        self._emit(v)

    def on_reset(self, pool_id: int) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            for pg in pool.pages.values():
                if pg.state != "trash":
                    pg.state = "free"
                    pg.owner_slot = None
                    pg.owner_rid = None
                    pg.pins = 0
                    pg.poisoned = False
            pool.row_stamps.clear()
            pool.owner_rids.clear()

    def set_owner(self, pool_id: int, slot: int, rid: Optional[str],
                  lane: Optional[str] = None) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            if rid is None:
                pool.owner_rids.pop(slot, None)
            else:
                pool.owner_rids[slot] = rid
            for pg in pool.pages.values():
                if pg.owner_slot == slot:
                    pg.owner_rid = rid
            if lane is not None:
                pool.lane = lane

    def set_lane(self, pool_id: int, lane: str) -> None:
        with self._mu:
            self._pools[pool_id].lane = lane

    def mark_poisoned(self, pool_id: int, pages: Sequence[int]) -> None:
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages.get(p)
                if pg is not None:
                    pg.poisoned = True

    def poisoned_pages(self, pool_id: int,
                       pages: Sequence[int]) -> List[int]:
        """Which of ``pages`` carry a canary the engine should verify."""
        with self._mu:
            pool = self._pools[pool_id]
            return [p for p in pages
                    if pool.pages.get(p) is not None
                    and pool.pages[p].poisoned]

    def clear_poison(self, pool_id: int, pages: Sequence[int]) -> None:
        """Verification done — the new owner is about to legitimately
        overwrite these pages."""
        with self._mu:
            pool = self._pools[pool_id]
            for p in pages:
                pg = pool.pages.get(p)
                if pg is not None:
                    pg.poisoned = False

    def canary_violation(self, pool_id: int, pages: Sequence[int],
                         detail: str = "") -> None:
        """The engine found a freed page's canary overwritten."""
        with self._mu:
            pool = self._pools[pool_id]
            v = self._violation(
                pool, "canary",
                f"freed page(s) {sorted(pages)} were WRITTEN between "
                f"free and re-allocation{': ' + detail if detail else ''}"
                f" — a write-after-free landed in the pool (stale "
                f"dispatch or table aliasing)", list(pages))
        self._emit(v)

    # ------------------------------------------------------------ reading

    def _node_identity(self) -> str:
        raw = (os.environ.get("SWARMDB_NODE_ID") or f"p{os.getpid()}")
        return re.sub(r"[^A-Za-z0-9_.-]", "_", raw)

    def violations(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [dict(v) for v in self._violations]

    def report(self) -> Dict[str, Any]:
        with self._mu:
            pools = []
            for pool in self._pools.values():
                pools.append({
                    "pool": pool.label,
                    "lane": pool.lane,
                    "num_pages": pool.num_pages,
                    "states": pool.state_counts(),
                    "churn_allocated": pool.churn_allocated,
                    "churn_freed": pool.churn_freed,
                    "live_rows": len(pool.row_stamps),
                })
            violations = [dict(v) for v in self._violations]
        return {
            "enabled": enabled(),
            "node": self._node_identity(),
            "pools": pools,
            "violations": violations,
            "generated_at": time.time(),
        }

    def prometheus_lines(self, prefix: str = "swarmdb_") -> List[str]:
        with self._mu:
            counts: Dict[str, int] = {}
            per_lane: Dict[str, Tuple[int, int]] = {}
            for pool in self._pools.values():
                for k, v in pool.state_counts().items():
                    counts[k] = counts.get(k, 0) + v
                lane = pool.lane or pool.label
                a, f = per_lane.get(lane, (0, 0))
                per_lane[lane] = (a + pool.churn_allocated,
                                  f + pool.churn_freed)
            n_violations = len(self._violations)
        lines = [f"# TYPE {prefix}page_violations_total counter",
                 f"{prefix}page_violations_total {n_violations}",
                 f"# TYPE {prefix}page_state gauge"]
        for k in sorted(counts):
            lines.append(f'{prefix}page_state{{state="{k}"}} '
                         f"{counts[k]}")
        lines.append(f"# TYPE {prefix}page_churn_allocated_total counter")
        lines.append(f"# TYPE {prefix}page_churn_freed_total counter")
        for lane in sorted(per_lane):
            a, f = per_lane[lane]
            lines.append(
                f'{prefix}page_churn_allocated_total{{lane="{lane}"}} '
                f"{a}")
            lines.append(
                f'{prefix}page_churn_freed_total{{lane="{lane}"}} {f}')
        return lines

    def _write_dump(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"pagecheck_{self._node_identity()}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=1)
        os.replace(tmp, path)
        return path

    def dump_to(self, directory: str) -> str:
        # report() takes the mutex itself; the file write stays outside
        return self._write_dump(directory)

    def _atexit_dump(self) -> None:
        directory = os.environ.get("SWARMDB_FLIGHT_DIR")
        if not directory:
            return
        try:
            self.dump_to(directory)
        except Exception:  # pragma: no cover - shutdown best-effort
            pass

    def reset(self) -> None:
        """Tests only — forget pools, violations, and flights."""
        with self._mu:
            self._pools.clear()
            self._next_pool = 0
            self._epoch = 0
            self._violations.clear()
            self._violation_keys.clear()
            self._flights.clear()


_REGISTRY = PageCheckRegistry()


def registry() -> PageCheckRegistry:
    return _REGISTRY


class PoolHandle:
    """A checked pool's bound view of the registry (engine-facing)."""

    __slots__ = ("_reg", "pool_id")

    def __init__(self, reg: PageCheckRegistry, pool_id: int) -> None:
        self._reg = reg
        self.pool_id = pool_id

    def __getattr__(self, name: str) -> Any:
        fn = getattr(self._reg, name)

        def bound(*args: Any, **kwargs: Any) -> Any:
            return fn(self.pool_id, *args, **kwargs)

        return bound


# ------------------------------------------------------ checked classes

def _checked_allocator(base: type) -> type:
    class CheckedPageAllocator(base):  # type: ignore[misc, valid-type]
        """Checked page allocator: every custody transition of the base
        class is mirrored into the registry, in the order the JAX
        package's ``_take`` / ``_give`` / ``_check_prefix`` hooks see
        them."""

        def __init__(self, *args: Any, label: Optional[str] = None,
                     **kwargs: Any) -> None:
            self.pagecheck: Optional[PoolHandle] = None
            super().__init__(*args, **kwargs)
            # page 0, or every shard's first page on a sharded pool
            trash = [k * self.num_pages // self.n_shards
                     for k in range(self.n_shards)]
            self.pagecheck = registry().register_pool(
                self.num_pages, trash, label=label)

        # ``allocate`` goes through here in the port
        # swarmlint: borrows[page]: prefix_pages
        def allocate_with_prefix(self, slot_id: int,
                                 prefix_pages: List[int],
                                 n_fresh: int):
            if prefix_pages and slot_id not in self._by_slot:
                self.pagecheck.on_reference(slot_id, list(prefix_pages))
            row = super().allocate_with_prefix(slot_id, prefix_pages,
                                               n_fresh)
            if row is not None:
                fresh = self.pages_for(slot_id)
                self.pagecheck.on_take(fresh, slot_id)
                self.pagecheck.stamp_row(slot_id,
                                         list(prefix_pages) + fresh)
            return row

        def transfer_to_cache(self, slot_id: int,
                              page_ids: List[int]) -> None:
            super().transfer_to_cache(slot_id, page_ids)
            self.pagecheck.on_to_cache(page_ids)

        def add_free(self, page_ids: List[int]) -> None:
            self.pagecheck.on_give(page_ids)
            super().add_free(page_ids)

        def reserve(self, n: int) -> List[int]:
            taken = super().reserve(n)
            if taken:
                self.pagecheck.on_reserve(taken)
            return taken

        def release_taken(self, pending: List[int]) -> None:
            for slot_id in pending:
                pages = self.pages_for(slot_id)
                if pages:
                    self.pagecheck.on_give(list(reversed(pages)))
            super().release_taken(pending)

        def reset(self) -> None:
            super().reset()
            if self.pagecheck is not None:
                self.pagecheck.on_reset()

    return CheckedPageAllocator


def _checked_prefix_lru() -> type:
    from ..ops.prefix_cache import PrefixLRU

    class CheckedPrefixLRU(PrefixLRU):
        """Checked prefix cache. In paged mode (manage_free=False) it
        shares the engine allocator's pool shadow (pass ``pool=``); in
        dense mode it registers its own."""

        def __init__(self, num_pages: int, page_size: int,
                     manage_free: bool = True,
                     pool: Optional[Any] = None,
                     label: Optional[str] = None) -> None:
            super().__init__(num_pages, page_size,
                             manage_free=manage_free)
            shared = getattr(pool, "pagecheck", None)
            if shared is not None:
                self.pagecheck: PoolHandle = shared
                self._own_pool = False
            else:
                self.pagecheck = registry().register_pool(
                    num_pages, [0], label=label or "prefix")
                self._own_pool = True

        def pin(self, page_ids: Sequence[int]) -> None:
            super().pin(page_ids)
            self.pagecheck.on_pin(page_ids)

        def unpin(self, page_ids: Sequence[int]) -> None:
            super().unpin(page_ids)
            self.pagecheck.on_unpin(page_ids)

        def register(self, chain: bytes, tokens: Tuple[int, ...],
                     page_id: int) -> bool:
            accepted = super().register(chain, tokens, page_id)
            if accepted and self._own_pool:
                # dense mode: the page moves from caller custody into
                # the table (paged mode mirrors via transfer_to_cache)
                self.pagecheck.on_to_cache([page_id])
            return accepted

        def acquire(self, n: int) -> List[int]:
            pages = super().acquire(n)
            if pages and self._own_pool:
                self.pagecheck.on_evict(pages)  # evicted: cached -> free
                self.pagecheck.on_take(pages, -1)
            return pages

        def release(self, page_id: int) -> None:
            super().release(page_id)
            if self._manage_free and self._own_pool:
                self.pagecheck.on_give([page_id])

        def reset(self) -> None:
            super().reset()
            if self._own_pool:
                self.pagecheck.on_reset()

    return CheckedPrefixLRU


def __getattr__(name: str) -> Any:  # lazy class construction
    if name in ("CheckedPageAllocator", "CheckedShardedPageAllocator"):
        from ..ops import paged_kv

        cls = _checked_allocator(getattr(paged_kv, name[len("Checked"):]))
        cls.__name__ = cls.__qualname__ = name
    elif name == "CheckedPrefixLRU":
        cls = _checked_prefix_lru()
    else:
        raise AttributeError(name)
    globals()[name] = cls
    return cls
