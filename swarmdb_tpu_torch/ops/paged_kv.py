"""Block-paged KV cache: the page pool, its writes and the host allocator.

The counterpart of ``swarmdb_tpu/ops/paged_kv.py`` for plain (bf16 / f32)
pools. K and V live in a shared pool of fixed-size pages:

    k, v:        [L, num_pages, page_size, Hkv, D]
    page_table:  [B, pages_per_slot] int32   (page ids per slot)

Pool invariants (the same as the JAX package's):

- Page 0 is the TRASH page, never allocated: retired and inactive slots
  keep a zeroed table row, and padding tokens and writes past a slot's
  coverage land there.
- A retired slot's pages are freed only after its table row is zeroed.

JAX arrays are immutable, so the JAX package's writes return new pools.
Here the writes update the pool IN PLACE (tensor index assignment): the
pool is the largest buffer of the serving path and a copy per write would
double its traffic. The functions still return the pools, so call sites
read like the JAX ones.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.sync import make_lock

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def kv_dtype_name() -> str:
    """Resolve SWARMDB_KV_DTYPE (default ``bf16``). ``int8`` pools are a
    later slice of the port and raise here."""
    name = os.environ.get("SWARMDB_KV_DTYPE", "bf16").strip().lower()
    if name in ("", "auto"):
        return "bf16"
    if name == "int8":
        raise NotImplementedError(
            "SWARMDB_KV_DTYPE=int8 (quantized pages and their kernels) is "
            "not ported yet: it is the int8-pool slice in ROADMAP.md "
            "queue 1")
    if name not in KV_DTYPES:
        raise ValueError(f"SWARMDB_KV_DTYPE={name!r}: expected one of "
                         f"{sorted(KV_DTYPES) + ['int8']}")
    return name


def pages_per_slot(max_seq: int, page_size: int) -> int:
    return -(-max_seq // page_size)  # ceil


def init_paged_kv_cache(
    n_layers: int,
    num_pages: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    batch: int,
    max_seq: int,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """Zeroed page pool + all-trash page table. ``num_pages`` INCLUDES the
    trash page 0. ``dtype=None`` resolves SWARMDB_KV_DTYPE."""
    if dtype is None:
        dtype = KV_DTYPES[kv_dtype_name()]
    shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)
    maxp = pages_per_slot(max_seq, page_size)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "page_table": torch.zeros((batch, maxp), dtype=torch.int32,
                                  device=device),
    }


def paged_gather_kv(
    k_pages: torch.Tensor,     # [P, ps, Hkv, D] (single layer)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [B, maxp*ps, Hkv, D] view of each slot's pages — the input of
    the plain decode attention."""
    B, maxp = page_table.shape
    ps = k_pages.shape[1]
    idx = page_table.long()
    shape = (B, maxp * ps) + tuple(k_pages.shape[2:])
    return k_pages[idx].reshape(shape), v_pages[idx].reshape(shape)


def paged_write_chunk(
    k_pages: torch.Tensor,     # [L, P, ps, Hkv, D]
    v_pages: torch.Tensor,
    chunk_k: torch.Tensor,     # [L, B, Kc, Hkv, D] a finished decode chunk
    chunk_v: torch.Tensor,
    start_positions: torch.Tensor,  # [B] absolute position of chunk step 0
    page_table: torch.Tensor,       # [B, maxp]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a finished decode chunk's K/V into the pool — one bulk write
    per chunk. Positions past the table's coverage and rows with zeroed
    table entries land in trash page 0."""
    L = k_pages.shape[0]
    ps = k_pages.shape[2]
    B, maxp = page_table.shape
    Kc = chunk_k.shape[2]
    pos = (start_positions.long()[:, None]
           + torch.arange(Kc, device=start_positions.device)[None, :])
    col = torch.clamp(pos // ps, max=maxp - 1)
    page = torch.gather(page_table.long(), 1, col)       # [B, Kc]
    page = torch.where(pos < maxp * ps, page, torch.zeros_like(page))
    off = pos % ps
    pf, of = page.reshape(-1), off.reshape(-1)           # [B*Kc]
    tail = tuple(chunk_k.shape[3:])
    k_pages[:, pf, of] = chunk_k.reshape((L, B * Kc) + tail).to(k_pages.dtype)
    v_pages[:, pf, of] = chunk_v.reshape((L, B * Kc) + tail).to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_ragged(
    k_pages: torch.Tensor,     # [L, P, ps, Hkv, D]
    v_pages: torch.Tensor,
    sfx_k: torch.Tensor,       # [L, W, Hkv, D] packed wave K (stream order)
    sfx_v: torch.Tensor,
    tok_row: torch.Tensor,     # [W] owning wave row (>= R = padding)
    tok_pos: torch.Tensor,     # [W] absolute position within the row
    row_tables: torch.Tensor,  # [R, maxp] page ids per wave row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token scatter of a packed ragged wave's K/V into the pool:
    stream token t lands at page ``row_tables[tok_row[t], tok_pos[t] //
    ps]`` offset ``tok_pos[t] % ps``. Padding tokens land in trash page 0
    (duplicate trash writes are harmless: page 0 is never read as live)."""
    ps = k_pages.shape[2]
    R, maxp = row_tables.shape
    tok_row = tok_row.long()
    tok_pos = tok_pos.long()
    col = torch.clamp(tok_pos // ps, 0, maxp - 1)
    row = torch.clamp(tok_row, 0, R - 1)
    page = row_tables.long()[row, col]                   # [W]
    dead = (tok_pos >= maxp * ps) | (tok_row < 0) | (tok_row >= R)
    zero = torch.zeros_like(page)
    page = torch.where(dead, zero, page)
    off = torch.where(dead, zero, tok_pos % ps)
    k_pages[:, page, off] = sfx_k.to(k_pages.dtype)
    v_pages[:, page, off] = sfx_v.to(v_pages.dtype)
    return k_pages, v_pages


def set_page_table_rows(page_table: torch.Tensor, rows, values
                        ) -> torch.Tensor:
    """Replace whole page-table rows in place (admission assigns,
    retirement zeroes)."""
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return page_table
    maxp = page_table.shape[1]
    vals = np.asarray(values, np.int32).reshape(len(rows), maxp)
    idx = torch.from_numpy(rows).to(page_table.device)
    page_table[idx] = torch.from_numpy(vals).to(page_table.device)
    return page_table


@dataclass
class _SlotPages:
    pages: List[int]


class PageAllocator:
    """Host-side page pool bookkeeping (engine admission/retirement path).

    Engine calls happen on the engine thread; the lock keeps stats() and
    external probes safe. Page 0 (trash) is never handed out.
    """

    def __init__(self, num_pages: int, page_size: int, max_seq: int,
                 batch: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.max_seq = max_seq
        self.maxp = pages_per_slot(max_seq, page_size)
        self.num_pages = num_pages
        self.batch = batch
        self._by_slot: Dict[int, _SlotPages] = {}
        self._pending_free: List[int] = []
        self._lock = make_lock("ops.paged_kv.PageAllocator._lock")
        self.pages_allocated_total = 0
        self.pages_freed_total = 0
        # bumped by every reset(): page ids held outside the allocator are
        # only valid within the generation they were handed out in
        self.generation = 0
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    # -- admission -----------------------------------------------------------

    def pages_needed(self, prompt_len: int, max_new: int, chunk: int) -> int:
        """Pages covering every position this request can ever WRITE:
        prompt + generated tokens + up to one chunk of overshoot, capped at
        max_seq (beyond-cap writes are trash-routed)."""
        worst = min(self.max_seq, prompt_len + max_new + chunk)
        return min(self.maxp, -(-worst // self.page_size))

    def can_allocate(self, n: int) -> bool:
        with self._lock:
            return len(self._free) >= n

    def _take(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def allocate(self, slot_id: int, n: int) -> Optional[np.ndarray]:
        """Take n pages for a slot; None if the pool can't cover it.
        Returns the slot's FULL page-table row (maxp wide, trash-padded)."""
        return self.allocate_with_prefix(slot_id, [], n)

    def allocate_with_prefix(self, slot_id: int, prefix_pages: List[int],
                             n_fresh: int) -> Optional[np.ndarray]:
        """Row = ``prefix_pages`` (prefix-cache pages the slot only
        REFERENCES; retirement does not free them) followed by ``n_fresh``
        newly owned pages. None if the pool can't cover the fresh part."""
        with self._lock:
            if slot_id in self._by_slot:
                raise RuntimeError(f"slot {slot_id} already holds pages")
            fresh = self._take(n_fresh)
            if fresh is None:
                return None
            self.pages_allocated_total += len(fresh)
            self._by_slot[slot_id] = _SlotPages(fresh)
            row = np.zeros(self.maxp, np.int32)
            pages = list(prefix_pages) + fresh
            row[: len(pages)] = pages
            return row

    def transfer_to_cache(self, slot_id: int, page_ids: List[int]) -> None:
        """Remove ``page_ids`` from a slot's OWNED set: custody moves to
        the prefix cache, so retirement won't free them."""
        with self._lock:
            sp = self._by_slot.get(slot_id)
            if sp is not None:
                drop = set(page_ids)
                sp.pages = [p for p in sp.pages if p not in drop]

    def add_free(self, page_ids: List[int]) -> None:
        """Return cache-evicted pages to the pool."""
        with self._lock:
            self.pages_freed_total += len(page_ids)
            self._free.extend(page_ids)

    def free_count(self, slot_id: Optional[int] = None) -> int:
        with self._lock:
            return len(self._free)

    def pages_for(self, slot_id: int) -> List[int]:
        with self._lock:
            sp = self._by_slot.get(slot_id)
            return list(sp.pages) if sp else []

    def slot_capacity(self) -> int:
        """Most pages any single request can ever be granted."""
        return self.num_pages - 1

    # -- retirement ----------------------------------------------------------

    def mark_retired(self, slot_id: int) -> None:
        """Queue a slot's pages for reclaim; they stay owned until the
        table row is zeroed (take_pending_frees / release_taken)."""
        with self._lock:
            if slot_id in self._by_slot:
                self._pending_free.append(slot_id)

    def take_pending_frees(self) -> List[int]:
        with self._lock:
            pending, self._pending_free = self._pending_free, []
        return pending

    def release_taken(self, pending: List[int]) -> None:
        """Free the pages of slots drained by take_pending_frees — only
        after their table rows were zeroed."""
        with self._lock:
            for slot_id in pending:
                sp = self._by_slot.pop(slot_id, None)
                if sp is not None:
                    self.pages_freed_total += len(sp.pages)
                    self._free.extend(reversed(sp.pages))

    def requeue_pending(self, pending: List[int]) -> None:
        with self._lock:
            self._pending_free[:0] = pending

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "free_pages": len(self._free),
                "live_slots": len(self._by_slot),
                "page_size": self.page_size,
                "pages_allocated_total": self.pages_allocated_total,
                "pages_freed_total": self.pages_freed_total,
            }

    def reset(self) -> None:
        with self._lock:
            self.generation += 1
            self._free = list(range(self.num_pages - 1, 0, -1))
            self._by_slot.clear()
            self._pending_free.clear()
