"""Automatic prefix caching over the KV page pool (vLLM-style).

The serve workload re-sends each conversation's whole history every turn
(`backend/service.build_prompt`), so prefill work grows quadratically with
conversation length. This module caches the KV of PAGE-ALIGNED prompt
prefixes across requests:

- Every full ``page_size``-token page of a prompt is identified by a CHAIN
  hash — a running blake2b over all tokens from position 0 through the end
  of that page — so equal chains imply equal token prefixes (the raw token
  window is stored and compared too, making collisions impossible rather
  than merely improbable).
- At admission the engine looks up the longest cached chain run, reuses
  those pages in place (the ragged prefill kernel reads them as the row's
  prefix) and prefills ONLY the suffix. After prefill it registers the
  prompt's freshly-written full pages for future turns.
- Pages live in the main paged pool; eviction is LRU over pages no active
  slot depends on.

Host-side safety argument (single engine thread + device program order):
admission N's page reads are dispatched before admission N+1 is even
matched, so an entry evicted and re-registered by N+1 can only be
REWRITTEN by a dispatch that the device executes after N's reads. The
table never points a chain at a page whose (eventual) content differs from
that chain's tokens.

A copy of ``swarmdb_tpu/ops/prefix_cache.py``; ``make_prefix_lru`` is
the page sanitizer's factory (``SWARMDB_PAGECHECK``,
``obs/pagecheck.py``). Every ``match`` feeds its chain
accesses to the memory accountant's reuse sampler (``mem``, the shared
null probe under ``SWARMDB_MEMPROF=0``).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
from ..utils.sync import make_lock


def make_prefix_lru(num_pages: int, page_size: int,
                    manage_free: bool = True, pool: Any = None,
                    label: Optional[str] = None) -> "PrefixLRU":
    """Prefix-cache factory. Flag off: the plain :class:`PrefixLRU`,
    exactly. ``SWARMDB_PAGECHECK=1``: the checked subclass whose pin /
    unpin / register / evict events feed the page sanitizer's shadow
    registry -- ``pool`` (the engine's checked allocator) shares its pool
    shadow in paged mode; dense mode registers its own."""
    if os.environ.get("SWARMDB_PAGECHECK", "0") not in ("", "0"):
        from ..obs import pagecheck

        return pagecheck.CheckedPrefixLRU(
            num_pages, page_size, manage_free=manage_free, pool=pool,
            label=label)
    return PrefixLRU(num_pages, page_size, manage_free=manage_free)


def page_chains(tokens: Sequence[int], page_size: int,
                max_pages: Optional[int] = None) -> List[bytes]:
    """Chain hashes for every FULL page of ``tokens``.

    chain[i] digests tokens[0 : (i+1)*page_size] — a prefix identity, not a
    page identity, so page i can only hit behind a hit of page i-1.
    """
    n_full = len(tokens) // page_size
    if max_pages is not None:
        n_full = min(n_full, max_pages)
    h = hashlib.blake2b(digest_size=16)
    out: List[bytes] = []
    # one vectorized serialization — this runs per admission on the single
    # engine thread; a per-int to_bytes loop was ~100x slower on long
    # prompts (review finding)
    raw = np.asarray(tokens[: n_full * page_size], dtype="<i4").tobytes()
    stride = 4 * page_size
    for i in range(n_full):
        h.update(raw[i * stride: (i + 1) * stride])
        out.append(h.digest())
    return out


class PrefixLRU:
    """Chain-hash → page-id table with LRU eviction over an id pool.

    Page ids are ``1..num_pages-1`` (0 is the trash page, never cached).
    ``pin``/``unpin`` guard pages that an ACTIVE slot's attention still
    reads every decode step (dense mode never needs this — the gathered
    prefix is copied into the slot's lane — but the paged engine reads
    shared pages in place until retirement).
    """

    def __init__(self, num_pages: int, page_size: int,
                 manage_free: bool = True) -> None:
        """``manage_free=False`` (paged-engine mode): this table does NOT
        own a free list — pages are borrowed from the engine's
        PageAllocator, ``acquire``/``evict_lru`` only evict entries, and
        the caller returns evicted ids to the allocator."""
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.page_size = page_size
        self.num_pages = num_pages
        self._manage_free = manage_free
        self._free: List[int] = (
            list(range(num_pages - 1, 0, -1)) if manage_free else []
        )
        # chain -> (page_id, token window); insertion order == LRU order
        self._entries: "OrderedDict[bytes, Tuple[int, Tuple[int, ...]]]" = (
            OrderedDict()
        )
        self._pins: dict = {}            # page_id -> pin count
        self._lock = make_lock("ops.prefix_cache.PrefixLRU._lock")
        self.hits = 0
        self.misses = 0
        # per-LOOKUP counters (vs the per-page hits/misses above):
        # a full-miss lookup on a prompt with cached-eligible pages is
        # the anchor-jump signature — the window re-anchored and every
        # previously cached page of the conversation went dark. The
        # ratio full_misses/lookups is the number the sink-anchored
        # window drives toward zero.
        self.lookups = 0
        self.full_misses = 0
        # pool generation (managed-free mode): bumped by reset(). Pages
        # held OUTSIDE the table (the serving layer's dense rolling-KV
        # registry acquires custody via acquire()) are only valid within
        # the generation they were taken in — reset() rebuilds the free
        # list, so a stale holder releasing or resuming them would alias
        # a later occupant's pages (same contract as
        # ops.paged_kv.PageAllocator.generation).
        self.generation = 0
        # the memory accountant's reuse-distance probe: every match()
        # feeds its chain accesses to the sampler (unsampled accesses
        # cost one hash and one compare)
        from ..obs.memprof import memprof

        self.mem = memprof().prefix_probe(self.stats)

    # ---------------------------------------------------------------- lookup

    def match(self, chains: Sequence[bytes],
              tokens: Sequence[int]) -> List[int]:
        """Longest cached run of ``chains`` (from page 0); returns its page
        ids and touches them MRU. ``tokens`` re-verifies content so a hash
        collision cannot alias two different prefixes."""
        pages: List[int] = []
        ps = self.page_size
        with self._lock:
            for i, chain in enumerate(chains):
                entry = self._entries.get(chain)
                if entry is None:
                    break
                page_id, window = entry
                if tuple(tokens[i * ps: (i + 1) * ps]) != window:
                    break  # collision — treat as miss
                self._entries.move_to_end(chain)
                pages.append(page_id)
            self.hits += len(pages)
            self.misses += max(0, len(chains) - len(pages))
            if chains:
                self.lookups += 1
                if not pages:
                    self.full_misses += 1
            m = self.mem
            if m.enabled:
                for chain in chains:
                    m.access(chain)
        return pages

    # ------------------------------------------------------------ allocation

    def acquire(self, n: int) -> List[int]:
        """Take UP TO ``n`` page ids for registration, evicting LRU
        unpinned entries as needed; returns what the pool can cover
        (possibly empty — the caller registers that much less)."""
        with self._lock:
            take: List[int] = []
            while len(take) < n and self._free:
                take.append(self._free.pop())
            if len(take) < n:
                evictable = [c for c, (p, _) in self._entries.items()
                             if not self._pins.get(p)]
                for chain in evictable:
                    if len(take) >= n:
                        break
                    page_id, _ = self._entries.pop(chain)
                    take.append(page_id)
            return take

    def evict_lru(self, n: int, want=None) -> List[int]:
        """Evict up to ``n`` LRU unpinned entries, returning their page
        ids for the caller's free list (paged-engine mode — the returned
        pages are NOT retained here). ``want(page_id)`` filters the
        candidates: on a DP-sharded pool only same-shard pages can cover
        a slot's shortfall, and evicting foreign-shard entries would
        drain the whole cache without unblocking anything."""
        with self._lock:
            out: List[int] = []
            for chain in [c for c, (p, _) in self._entries.items()
                          if not self._pins.get(p)
                          and (want is None or want(p))]:
                if len(out) >= n:
                    break
                page_id, _ = self._entries.pop(chain)
                out.append(page_id)
            return out

    def match_and_pin(self, chains: Sequence[bytes],
                      tokens: Sequence[int]) -> List[int]:
        """``match`` + pin the hit pages atomically (paged mode: a later
        admission in the same round must not evict pages this one is
        about to attach to a slot)."""
        pages = self.match(chains, tokens)
        self.pin(pages)
        return pages

    def reset(self) -> None:
        """Forget everything (engine restart rebuilds the pool buffers, so
        every cached entry would point at zeroed pages)."""
        with self._lock:
            # bump BEFORE rebuilding the free list: a racing epoch check
            # must never observe (old generation, rebuilt pool)
            self.generation += 1
            self._free = (list(range(self.num_pages - 1, 0, -1))
                          if self._manage_free else [])
            self._entries.clear()
            self._pins.clear()

    def evictable_count(self) -> int:
        """How many cached pages could be evicted right now (cached and
        not pinned) — the page-pool backpressure gate counts these as
        headroom, since admission can always reclaim them via
        evict_lru."""
        with self._lock:
            return sum(1 for _, (p, _t) in self._entries.items()
                       if not self._pins.get(p))

    def free_count(self) -> int:
        """Managed-free mode: pages immediately takeable without eviction
        (the dense rolling registry's headroom probe)."""
        with self._lock:
            return len(self._free)

    def register(self, chain: bytes, tokens: Tuple[int, ...],
                 page_id: int) -> bool:
        """Bind ``chain`` to ``page_id`` (whose device content a dispatched
        write is filling with exactly ``tokens``'s KV). Returns True if
        custody of ``page_id`` was accepted; False on a DUPLICATE chain
        (two slots prefilled the same new prefix in one round) — the old
        page is kept and the caller retains custody of the new one (in
        managed-free mode it is recycled here)."""
        with self._lock:
            old = self._entries.pop(chain, None)
            if old is not None:
                self._entries[chain] = old
                self._entries.move_to_end(chain)
                if self._manage_free:
                    self._free.append(page_id)
                return False
            self._entries[chain] = (page_id, tuple(tokens))
            return True

    def release(self, page_id: int) -> None:
        """Return a page acquired but never registered (group failed).
        In paged mode (manage_free=False) the caller returns the page to
        the PageAllocator instead — appending here would fork custody."""
        with self._lock:
            if self._manage_free:
                self._free.append(page_id)

    # ---------------------------------------------------------------- pinning

    def pin(self, page_ids: Sequence[int]) -> None:
        with self._lock:
            for p in page_ids:
                self._pins[p] = self._pins.get(p, 0) + 1

    def unpin(self, page_ids: Sequence[int]) -> None:
        with self._lock:
            for p in page_ids:
                c = self._pins.get(p, 0) - 1
                if c <= 0:
                    self._pins.pop(p, None)
                else:
                    self._pins[p] = c

    # ----------------------------------------------------------- introspection

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "free_pages": len(self._free),
                "cached_pages": len(self._entries),
                "pinned_pages": len(self._pins),
                "page_size": self.page_size,
                "hit_tokens": self.hits * self.page_size,
                "miss_tokens": self.misses * self.page_size,
                "lookups": self.lookups,
                "full_misses": self.full_misses,
            }
