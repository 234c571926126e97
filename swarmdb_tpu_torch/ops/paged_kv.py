"""Block-paged KV cache: the page pool, its writes and the host allocator.

The counterpart of ``swarmdb_tpu/ops/paged_kv.py``. K and V live in a
shared pool of fixed-size pages:

    k, v:        [L, num_pages, page_size, Hkv, D]   (plain f32 / bf16 pool)
                 QuantPool(data int8 [L, P, ps, Hkv, D], scale f32 [L, P, Hkv])
    page_table:  [B, pages_per_slot] int32   (page ids per slot)

``SWARMDB_KV_DTYPE`` picks the storage: ``bf16`` (default) and ``f32`` keep
pages verbatim; ``int8`` keeps symmetric per-page-per-head quantized pages
with f32 scales beside them (a :class:`QuantPool` under the same ``"k"`` /
``"v"`` keys), half the bytes of bf16 per token. Reads dequantize to f32
(``paged_gather_kv``) or, in the kernels, per tile.

Pool invariants (the same as the JAX package's):

- Page 0 is the TRASH page, never allocated: retired and inactive slots
  keep a zeroed table row, and padding tokens and writes past a slot's
  coverage land there.
- A retired slot's pages are freed only after its table row is zeroed.

JAX arrays are immutable, so the JAX package's writes return new pools.
Here the writes update the pool IN PLACE (tensor index assignment): the
pool is the largest buffer of the serving path and a copy per write would
double its traffic. A quantized write is a requant window: the touched
pages are gathered, recomputed and scattered back whole; only trash page 0
may appear twice in one scatter. The functions still return the pools, so
call sites read like the JAX ones.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..utils.sync import make_lock

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}

#: logical dtype a quantized pool stands for: suffix K/V are cast to it
#: before attending, as in the JAX package
DEQUANT_DTYPE = torch.bfloat16

#: symmetric range [-127, 127]: int8's -128 stays free for the canary of
#: the page sanitizer (never produced by the quantizer)
_QMAX = 127.0


class QuantPool(NamedTuple):
    """A quantized page pool: int8 payload + f32 symmetric scales.

    ``data``  [..., P, ps, Hkv, D] int8; ``scale`` [..., P, Hkv] f32, one
    per page and KV head: the value is ``data * scale``. ``pool[l]`` is
    tuple FIELD indexing; the layer slice is :func:`pool_layer`."""

    data: torch.Tensor
    scale: torch.Tensor


def kv_dtype_name() -> str:
    """Resolve SWARMDB_KV_DTYPE (default ``bf16``)."""
    name = os.environ.get("SWARMDB_KV_DTYPE", "bf16").strip().lower()
    if name in ("", "auto"):
        return "bf16"
    if name not in KV_DTYPES:
        raise ValueError(f"SWARMDB_KV_DTYPE={name!r}: expected one of "
                         f"{sorted(KV_DTYPES)}")
    return name


def kv_quantized(name: Optional[str] = None) -> bool:
    """Whether ``name`` (default: ``SWARMDB_KV_DTYPE``) is the int8
    pool."""
    return (name or kv_dtype_name()) == "int8"


def is_quantized(pool: Any) -> bool:
    return isinstance(pool, QuantPool)


def pool_data(pool: Any) -> torch.Tensor:
    """Storage tensor of a pool (the int8 payload of a quantized one)."""
    return pool.data if isinstance(pool, QuantPool) else pool


def pool_dtype(pool: Any) -> torch.dtype:
    """LOGICAL dtype of a pool: what suffix K/V are cast to before they
    are attended (``DEQUANT_DTYPE`` for a quantized pool)."""
    return DEQUANT_DTYPE if isinstance(pool, QuantPool) else pool.dtype


def pool_layer(pool: Any, l: int) -> Any:
    """Layer ``l`` of an [L, ...] pool, either kind (views, no copy)."""
    if isinstance(pool, QuantPool):
        return QuantPool(pool.data[l], pool.scale[l])
    return pool[l]


def pool_page_bytes(pool: Any) -> int:
    """Device bytes ONE page id takes across layers, scale rows included
    ([L, P, ...] or single-layer [P, ...] pools)."""
    data = pool_data(pool)
    pages = max(1, int(data.shape[-4]))
    nbytes = data.numel() * data.element_size()
    if isinstance(pool, QuantPool):
        nbytes += pool.scale.numel() * pool.scale.element_size()
    return nbytes // pages


def _quantize_pages(vals: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-page-per-head quantization of whole pages: ``vals``
    [..., ps, Hkv, D] (any float dtype) -> (int8 [..., ps, Hkv, D], f32
    scale [..., Hkv]); scale = amax over (token slot, D) / 127, rounding
    half to even. An all-zero page gets a tiny positive scale (its payload
    is zero either way)."""
    v = vals.float()
    amax = v.abs().amax(dim=(-3, -1))                    # [..., Hkv]
    scale = torch.clamp(amax, min=1e-30) / _QMAX
    q = torch.clamp(torch.round(v / scale[..., None, :, None]),
                    -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def _dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 view of quantized pages: data [..., ps, Hkv, D] * scale
    [..., Hkv] (per head)."""
    return q.float() * scale[..., None, :, None]


def _requant_window(old_q: torch.Tensor, old_s: torch.Tensor,
                    new_v: torch.Tensor, is_new: torch.Tensor,
                    is_keep: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Requantize whole pages after an incremental write: survivors
    (``is_keep``, slots before the write) are dequantized, new tokens
    (``is_new``) spliced in, every other slot zeroed (stale values must not
    raise the amax), and the page quantized again. ``old_q`` [..., ps, Hkv,
    D] int8, ``old_s`` [..., Hkv], ``new_v`` broadcastable to the pages,
    ``is_new`` / ``is_keep`` [..., ps] bool."""
    old_f = _dequantize_pages(old_q, old_s)
    vals = torch.where(is_new[..., None, None], new_v.float(),
                       torch.where(is_keep[..., None, None], old_f, 0.0))
    return _quantize_pages(vals)


def pagecheck_enabled() -> bool:
    """The runtime page sanitizer's flag (``SWARMDB_PAGECHECK``,
    :mod:`swarmdb_tpu_torch.obs.pagecheck`), read where a pool is built."""
    return os.environ.get("SWARMDB_PAGECHECK", "0") not in ("", "0")


def make_page_allocator(num_pages: int, page_size: int, max_seq: int,
                        batch: int, label: Optional[str] = None) -> Any:
    """Allocator factory. Flag off (default): the plain
    :class:`PageAllocator`, exactly. ``SWARMDB_PAGECHECK=1``: the checked
    subclass that mirrors every custody transition into the sanitizer's
    shadow registry."""
    if pagecheck_enabled():
        from ..obs import pagecheck

        return pagecheck.CheckedPageAllocator(
            num_pages, page_size, max_seq, batch, label=label)
    return PageAllocator(num_pages, page_size, max_seq, batch)


def make_sharded_page_allocator(pages_per_shard: int, n_shards: int,
                                page_size: int, max_seq: int, batch: int,
                                label: Optional[str] = None) -> Any:
    """The slot-affine allocator of a pool sharded over a data axis:
    :class:`ShardedPageAllocator`, or under ``SWARMDB_PAGECHECK=1`` its
    checked subclass (every shard's trash page registered as trash)."""
    if pagecheck_enabled():
        from ..obs import pagecheck

        return pagecheck.CheckedShardedPageAllocator(
            pages_per_shard, n_shards, page_size, max_seq, batch,
            label=label)
    return ShardedPageAllocator(pages_per_shard, n_shards, page_size,
                                max_seq, batch)


#: canary stamped into freed pages' K/V under the page sanitizer: exactly
#: representable in bf16 and f32, far outside any K/V value
CANARY_VALUE = -16384.0

#: int8 pools cannot hold -16384: their canary is -128, the one int8 code
#: the quantizer never emits (payload clipped to [-127, 127])
INT8_CANARY_VALUE = -128

#: canary of a quantized pool's SCALE slots: real scales are strictly
#: positive, so a write-after-free that recomputes a scale always trips it
SCALE_CANARY_VALUE = -1.0


def canary_for(dtype: torch.dtype) -> float:
    """The canary a pool of ``dtype`` holds: the float canary, or int8's
    reserved -128 on quantized pools."""
    if not dtype.is_floating_point:
        return float(INT8_CANARY_VALUE)
    return CANARY_VALUE


def canary_fill(k_pages: Any, v_pages: Any, page_ids: Sequence[int],
                value: Optional[float] = None) -> Tuple[Any, Any]:
    """Poison freed pages' K/V [L, P, ...] with the canary, IN PLACE on
    the current stream (the pool keeps its storage: captured decode graphs
    read fixed addresses). A quantized pool gets both fields poisoned:
    -128 in the int8 payload and -1.0 in the scale rows. Returns the
    pools."""
    ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=pool_data(k_pages).device)
    if ids.numel() == 0:
        return k_pages, v_pages
    if isinstance(k_pages, QuantPool):
        dv = int(value) if value is not None else INT8_CANARY_VALUE
        for pool in (k_pages, v_pages):
            pool.data.index_fill_(1, ids, dv)
            pool.scale.index_fill_(1, ids, SCALE_CANARY_VALUE)
        return k_pages, v_pages
    fv = value if value is not None else canary_for(k_pages.dtype)
    k_pages.index_fill_(1, ids, fv)
    v_pages.index_fill_(1, ids, fv)
    return k_pages, v_pages


def canary_check(k_pages: Any, v_pages: Any, page_ids: Sequence[int],
                 value: Optional[float] = None) -> List[int]:
    """Page ids whose canary was OVERWRITTEN between free and re-
    allocation (a write-after-free landed in the pool). One read-back to
    the host per call: the sanitizer's own sync. Quantized pools verify
    payload AND scale rows."""
    ids = [int(p) for p in page_ids]
    if not ids:
        return []
    idx = torch.as_tensor(ids, dtype=torch.long,
                          device=pool_data(k_pages).device)

    def intact(t: torch.Tensor, want: float) -> torch.Tensor:
        sel = t.index_select(1, idx)                     # [L, n, ...]
        return (sel == want).reshape(sel.shape[0], len(ids), -1).all(
            dim=2).all(dim=0)

    if isinstance(k_pages, QuantPool):
        dv = int(value) if value is not None else INT8_CANARY_VALUE
        ok = (intact(k_pages.data, dv) & intact(v_pages.data, dv)
              & intact(k_pages.scale, SCALE_CANARY_VALUE)
              & intact(v_pages.scale, SCALE_CANARY_VALUE))
    else:
        fv = value if value is not None else canary_for(k_pages.dtype)
        ok = intact(k_pages, fv) & intact(v_pages, fv)
    good = ok.cpu().tolist()
    return [p for p, g in zip(ids, good) if not g]


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
) -> Dict[str, Any]:
    """Zeroed page pool + all-trash page table. ``num_pages`` INCLUDES the
    trash page 0. ``dtype=None`` resolves SWARMDB_KV_DTYPE; ``torch.int8``
    gives :class:`QuantPool` entries (zero payload, zero scales: every
    page reads as zeros, like a plain pool)."""
    if dtype is None:
        dtype = KV_DTYPES[kv_dtype_name()]
    shape = (n_layers, num_pages, page_size, n_kv_heads, head_dim)

    def pool():
        if dtype == torch.int8:
            return QuantPool(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros((n_layers, num_pages, n_kv_heads),
                            dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "k": pool(),
        "v": pool(),
        "page_table": torch.zeros((batch, pages_per_slot(max_seq, page_size)),
                                  dtype=torch.int32, device=device),
    }


def paged_gather_kv(
    k_pages: Any,              # [P, ps, Hkv, D] (single layer), either kind
    v_pages: Any,
    page_table: torch.Tensor,  # [B, maxp]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [B, maxp*ps, Hkv, D] view of each slot's pages -- the input of
    the plain decode attention. A quantized pool gathers payload and
    scales and dequantizes to f32."""
    B, maxp = page_table.shape
    idx = page_table.long()
    data = pool_data(k_pages)
    shape = (B, maxp * data.shape[1]) + tuple(data.shape[2:])
    if isinstance(k_pages, QuantPool):
        kg = _dequantize_pages(k_pages.data[idx], k_pages.scale[idx])
        vg = _dequantize_pages(v_pages.data[idx], v_pages.scale[idx])
        return kg.reshape(shape), vg.reshape(shape)
    return k_pages[idx].reshape(shape), v_pages[idx].reshape(shape)


def paged_write_decode(
    k_pages: Any,              # [P, ps, Hkv, D] (single layer), either kind
    v_pages: Any,
    k: torch.Tensor,           # [B, 1, Hkv, D]
    v: torch.Tensor,
    positions: torch.Tensor,   # [B, 1] absolute write positions
    page_table: torch.Tensor,  # [B, maxp]
) -> Tuple[Any, Any]:
    """Write one decode token per slot into its page, in place. Writes at
    positions past the table's coverage and from inactive slots (zeroed
    table rows) land in trash page 0. On a quantized pool the token's page
    is requantized: slots before the position survive, later slots are
    zeroed."""
    ps = pool_data(k_pages).shape[1]
    maxp = page_table.shape[1]
    pos = positions[:, 0].long()                         # [B]
    col = torch.clamp(pos // ps, max=maxp - 1)
    page = torch.gather(page_table.long(), 1, col[:, None])[:, 0]
    page = torch.where(pos < maxp * ps, page, torch.zeros_like(page))
    off = pos % ps
    if isinstance(k_pages, QuantPool):
        slots = torch.arange(ps, device=pos.device)[None, :]   # [1, ps]
        slot_pos = (col * ps)[:, None] + slots                  # [B, ps]
        is_new = slots == off[:, None]
        is_keep = slot_pos < pos[:, None]
        for pool, tok in ((k_pages, k), (v_pages, v)):
            q, s = _requant_window(pool.data[page], pool.scale[page],
                                   tok[:, 0][:, None], is_new, is_keep)
            pool.data[page] = q
            pool.scale[page] = s
        return k_pages, v_pages
    k_pages[page, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page, off] = v[:, 0].to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_chunk(
    k_pages: Any,              # [L, P, ps, Hkv, D], either kind
    v_pages: Any,
    chunk_k: torch.Tensor,     # [L, B, Kc, Hkv, D] a finished decode chunk
    chunk_v: torch.Tensor,
    start_positions: torch.Tensor,  # [B] absolute position of chunk step 0
    page_table: torch.Tensor,       # [B, maxp]
) -> Tuple[Any, Any]:
    """Fold a finished decode chunk's K/V into the pool -- one bulk write
    per chunk. Positions past the table's coverage and rows with zeroed
    table entries land in trash page 0. On a quantized pool the chunk's
    page columns (at most ceil((ps - 1 + Kc) / ps) from start // ps) are
    requantized: slots before the chunk start survive, slots past its end
    are zeroed."""
    L, _, ps = pool_data(k_pages).shape[:3]
    B, maxp = page_table.shape
    Kc = chunk_k.shape[2]
    dev = start_positions.device
    start = start_positions.long()
    table = page_table.long()
    if isinstance(k_pages, QuantPool):
        npc = min(maxp, (Kc + 2 * ps - 2) // ps)
        c0 = torch.clamp(start // ps, 0, maxp - 1)                 # [B]
        cols = c0[:, None] + torch.arange(npc, device=dev)[None]   # [B, npc]
        page = torch.gather(table, 1, torch.clamp(cols, 0, maxp - 1))
        touched = (cols < maxp) & (cols * ps < (start + Kc)[:, None])
        page = torch.where(touched, page, torch.zeros_like(page))
        slot_pos = cols[..., None] * ps + torch.arange(ps, device=dev)
        t = slot_pos - start[:, None, None]                        # chunk idx
        is_new = (t >= 0) & (t < Kc) & (slot_pos < maxp * ps)
        is_keep = slot_pos < start[:, None, None]
        tc = torch.clamp(t, 0, Kc - 1)
        bidx = torch.arange(B, device=dev)[:, None, None]
        pf = page.reshape(-1)                                      # [B*npc]
        for pool, chunk in ((k_pages, chunk_k), (v_pages, chunk_v)):
            new_v = chunk[:, bidx, tc]             # [L, B, npc, ps, Hkv, D]
            q, s = _requant_window(pool.data[:, page], pool.scale[:, page],
                                   new_v, is_new, is_keep)
            pool.data[:, pf] = q.reshape((L, B * npc) + tuple(q.shape[3:]))
            pool.scale[:, pf] = s.reshape((L, B * npc) + tuple(s.shape[3:]))
        return k_pages, v_pages
    pos = start[:, None] + torch.arange(Kc, device=dev)[None, :]
    col = torch.clamp(pos // ps, max=maxp - 1)
    page = torch.gather(table, 1, col)                   # [B, Kc]
    page = torch.where(pos < maxp * ps, page, torch.zeros_like(page))
    off = pos % ps
    pf, of = page.reshape(-1), off.reshape(-1)           # [B*Kc]
    tail = tuple(chunk_k.shape[3:])
    k_pages[:, pf, of] = chunk_k.reshape((L, B * Kc) + tail).to(k_pages.dtype)
    v_pages[:, pf, of] = chunk_v.reshape((L, B * Kc) + tail).to(v_pages.dtype)
    return k_pages, v_pages


def paged_write_ragged(
    k_pages: Any,              # [L, P, ps, Hkv, D], either kind
    v_pages: Any,
    sfx_k: torch.Tensor,       # [L, W, Hkv, D] packed wave K (stream order)
    sfx_v: torch.Tensor,
    tok_row: torch.Tensor,     # [W] owning wave row (>= R = padding)
    tok_pos: torch.Tensor,     # [W] absolute position within the row
    row_tables: torch.Tensor,  # [R, maxp] page ids per wave row
) -> Tuple[Any, Any]:
    """Per-token scatter of a packed ragged wave's K/V into the pool:
    stream token t lands at page ``row_tables[tok_row[t], tok_pos[t] //
    ps]`` offset ``tok_pos[t] % ps``. Padding tokens land in trash page 0
    (duplicate trash writes are harmless: page 0 is never read as live)."""
    if isinstance(k_pages, QuantPool):
        return _paged_write_ragged_quant(k_pages, v_pages, sfx_k, sfx_v,
                                         tok_row, tok_pos, row_tables)
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


def _paged_write_ragged_quant(
    k_pages: QuantPool, v_pages: QuantPool,
    sfx_k: torch.Tensor, sfx_v: torch.Tensor,
    tok_row: torch.Tensor, tok_pos: torch.Tensor,
    row_tables: torch.Tensor,
) -> Tuple[QuantPool, QuantPool]:
    """Quantized ragged wave write: a requant window per wave row. A row's
    tokens are contiguous positions, so it touches at most ceil(W / ps) + 1
    page columns from its first token's column (first and last position
    found with a segment min / max over ``tok_pos``). Survivors are the
    slots before the row's first wave token (an earlier chunk of a split
    prompt in a partly filled page); slots past its last token are zeroed.
    Prefix-cache hit pages are whole pages before every window, so shared
    pages are never rewritten. Untouched columns and dead rows go to trash
    page 0."""
    L, _, ps = k_pages.data.shape[:3]
    tail = tuple(k_pages.data.shape[3:])                 # (Hkv, D)
    R, maxp = row_tables.shape
    W = tok_pos.shape[0]
    dev = tok_pos.device
    big = maxp * ps
    tok_row = tok_row.long()
    tok_pos = tok_pos.long()
    live = (tok_row >= 0) & (tok_row < R) & (tok_pos >= 0) & (tok_pos < big)
    rowc = torch.clamp(tok_row, 0, R - 1)
    init = torch.empty((R,), dtype=torch.long, device=dev)
    row_min = init.fill_(big).scatter_reduce(
        0, rowc, torch.where(live, tok_pos, big), reduce="amin")
    row_max = init.new_full((R,), -1).scatter_reduce(
        0, rowc, torch.where(live, tok_pos, -1), reduce="amax")
    npc = min(maxp, -(-W // ps) + 1)
    c0 = torch.clamp(row_min // ps, 0, maxp - 1)                   # [R]
    cols = c0[:, None] + torch.arange(npc, device=dev)[None]       # [R, npc]
    page = torch.gather(row_tables.long(), 1, torch.clamp(cols, 0, maxp - 1))
    touched = (cols < maxp) & (cols * ps <= row_max[:, None])
    page = torch.where(touched, page, torch.zeros_like(page))
    # stage the packed wave into per-row dense windows; padding and strays
    # go to the spare row R, which is dropped
    rel = tok_pos - c0[rowc] * ps
    okw = live & (rel >= 0) & (rel < npc * ps)
    sr = torch.where(okw, rowc, torch.full_like(rowc, R))
    srel = torch.where(okw, rel, torch.zeros_like(rel))
    is_new = torch.zeros((R + 1, npc * ps), dtype=torch.bool, device=dev)
    is_new[sr, srel] = True
    is_new = is_new[:R].reshape(R, npc, ps)
    slot_pos = cols[..., None] * ps + torch.arange(ps, device=dev)
    is_keep = slot_pos < row_min[:, None, None]
    pf = page.reshape(-1)                                          # [R*npc]
    # one layer at a time: the f32 windows of a wide wave over all layers
    # would take several GiB at Llama-3-8B's shape
    for pool, sfx in ((k_pages, sfx_k), (v_pages, sfx_v)):
        for l in range(L):
            data, scale = pool.data[l], pool.scale[l]
            stage = torch.zeros((R + 1, npc * ps) + tail,
                                dtype=torch.float32, device=dev)
            stage[sr, srel] = sfx[l].float()
            new_v = stage[:R].reshape((R, npc, ps) + tail)
            q, s = _requant_window(data[page], scale[page], new_v, is_new,
                                   is_keep)
            data[pf] = q.reshape((R * npc, ps) + tail)
            scale[pf] = s.reshape(R * npc, -1)
    return k_pages, v_pages


def pool_insert_pages(pool: Any, flat_ids: torch.Tensor,
                      dense_pages: torch.Tensor) -> Any:
    """Whole-page insert, in place: ``dense_pages`` [L, n, ps, Hkv, D] at
    full precision into the pool's pages ``flat_ids`` [n] (the row-
    bucketed and prefix prefills' page scatter). A quantized pool takes
    the exact quantization of the fresh values, per page and head from
    their amax, with no survivor requant (every slot of the page is
    written), one layer at a time. Only trash page 0 may repeat in
    ``flat_ids``."""
    idx = flat_ids.long()
    if isinstance(pool, QuantPool):
        for l in range(pool.data.shape[0]):
            q, s = _quantize_pages(dense_pages[l])
            pool.data[l, idx] = q
            pool.scale[l, idx] = s
        return pool
    pool[:, idx] = dense_pages.to(pool.dtype)
    return pool


def paged_insert_prefill(k_pages: Any, v_pages: Any, dense_k: torch.Tensor,
                         dense_v: torch.Tensor, target_pages: torch.Tensor
                         ) -> Tuple[Any, Any]:
    """Scatter the first n rows of a dense bucket prefill cache
    (``dense_k`` / ``dense_v`` [L, Bp, bucket, Hkv, D]) into the pages
    ``target_pages`` [n, bucket / ps] names, in place, through
    :func:`pool_insert_pages` (the row-bucketed and prefix waves' insert).
    ``bucket`` must be a whole number of pages."""
    L, ps = pool_data(k_pages).shape[0], pool_data(k_pages).shape[2]
    n, chunks = target_pages.shape
    if dense_k.shape[2] != chunks * ps:
        raise ValueError(f"a bucket of {dense_k.shape[2]} is not {chunks} "
                         f"pages of {ps}")
    flat = target_pages.reshape(-1)
    for pool, dense in ((k_pages, dense_k), (v_pages, dense_v)):
        pool_insert_pages(pool, flat, dense[:, :n].reshape(
            (L, n * chunks, ps) + tuple(dense.shape[3:])))
    return k_pages, v_pages


def pool_gather_pages(pool: Any, ids, host: Optional[Callable] = None
                      ) -> Any:
    """RAW payload of pages ``ids`` across all layers, in host memory at
    storage width (the warm tier's spill format): int8 data plus f32
    scales for a :class:`QuantPool`, the pool's dtype verbatim otherwise,
    so :func:`pool_insert_raw` of the payload restores the same bytes.

    One batched gather on the pool's device, then one copy into a CPU
    tensor that ``host(shape, dtype)`` gives (the warm store's slab,
    :meth:`ops.host_pool.HostPageStore.host_tensor`), or a new pageable
    one without ``host``. Into page-locked memory the copy from the card
    is ``non_blocking``, only enqueued on the current stream: the caller
    records an event after it and waits on the event before anything
    reads the payload. Returns ``(data [L, n, ps, Hkv, D], scale [L, n,
    Hkv])`` for a quantized pool, else one ``[L, n, ps, Hkv, D]`` tensor;
    None when ``host`` has no room."""
    data = pool_data(pool)
    idx = torch.as_tensor(list(ids), dtype=torch.long, device=data.device)

    def to_host(t: torch.Tensor) -> Optional[torch.Tensor]:
        src = t.index_select(1, idx)
        out = (host(tuple(src.shape), src.dtype) if host is not None
               else torch.empty(src.shape, dtype=src.dtype))
        if out is not None:
            out.copy_(src, non_blocking=src.device.type == "cuda"
                      and out.is_pinned())
        return out

    if isinstance(pool, QuantPool):
        out = to_host(pool.data)
        scale = to_host(pool.scale) if out is not None else None
        return None if scale is None else (out, scale)
    return to_host(pool)


def pool_insert_raw(pool: Any, flat_ids: torch.Tensor, payload: Any) -> Any:
    """Reinsert a :func:`pool_gather_pages` payload at pages ``flat_ids``
    [n], in place (``index_copy_`` into the pool's own tensors: a captured
    decode graph keeps reading the same storage). The payload is at
    storage width, so the exact bytes that left the pool come back (no
    requantization). A page-locked payload is copied ``non_blocking``:
    the caller keeps it alive until an event recorded after this call has
    passed."""
    idx = flat_ids.long()

    def put(dst: torch.Tensor, src: torch.Tensor) -> None:
        dst.index_copy_(1, idx, src.to(dst.device, dst.dtype,
                                       non_blocking=src.is_pinned()))

    if isinstance(pool, QuantPool):
        put(pool.data, payload[0])
        put(pool.scale, payload[1])
    else:
        put(pool, payload)
    return pool


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

    #: data shards of the pool (``ShardedPageAllocator``: more than one)
    n_shards = 1

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
        self._rebuild_free()
        # the memory accountant's residency ledger: page alloc / free
        # stamps written inside this allocator's critical sections (the
        # shared null pool under SWARMDB_MEMPROF=0)
        from ..obs.memprof import memprof

        self.mem = memprof().pool(self.stats)

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

    # -- free-list geometry (the pieces the sharded subclass swaps) ---------

    # swarmlint: holds[self._lock]
    def _rebuild_free(self) -> None:
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))

    # swarmlint: holds[self._lock]
    def _take(self, slot_id: int, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages ``slot_id`` may use; None if uncoverable."""
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    # swarmlint: holds[self._lock]
    def _give(self, page_ids: List[int]) -> None:
        self._free.extend(page_ids)

    def _check_prefix(self, slot_id: int, prefix_pages: List[int]) -> None:
        """Referenced (not owned) pages must be addressable by the slot:
        no constraint on one pool."""

    # -- data-axis hooks (trivial on one pool) -------------------------------

    def shard_of(self, slot_id: int) -> int:
        return 0

    def usable_prefix(self, slot_id: int, hits: List[int]) -> int:
        """How many of ``hits`` (a prefix chain, in order) the slot may
        reference: all of them on one pool."""
        return len(hits)

    def evictable(self, slot_id: int) -> Optional[Callable[[int], bool]]:
        """Which cached pages an eviction on behalf of ``slot_id`` should
        take (None: any)."""
        return None

    def allocate(self, slot_id: int, n: int) -> Optional[np.ndarray]:
        """Take n pages for a slot; None if the pool can't cover it.
        Returns the slot's FULL page-table row (maxp wide, trash-padded)."""
        return self.allocate_with_prefix(slot_id, [], n)

    # swarmlint: borrows[page]: prefix_pages
    def allocate_with_prefix(self, slot_id: int, prefix_pages: List[int],
                             n_fresh: int) -> Optional[np.ndarray]:
        """Row = ``prefix_pages`` (prefix-cache pages the slot only
        REFERENCES; retirement does not free them) followed by ``n_fresh``
        newly owned pages. None if the pool can't cover the fresh part."""
        with self._lock:
            if slot_id in self._by_slot:
                raise RuntimeError(f"slot {slot_id} already holds pages")
            self._check_prefix(slot_id, prefix_pages)
            fresh = self._take(slot_id, n_fresh)
            if fresh is None:
                return None
            self.pages_allocated_total += len(fresh)
            self.mem.page_alloc(fresh)
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
            self._give(page_ids)
            self.mem.page_free(page_ids)

    def reserve(self, n: int) -> List[int]:
        """Withdraw up to ``n`` free pages from circulation (the serving
        chaos harness's pool squeeze). No table row references them;
        ``add_free`` returns them, and a reset() reclaims them with the
        generation."""
        with self._lock:
            out = [self._free.pop() for _ in range(min(n, len(self._free)))]
            self.mem.page_alloc(out)
            return out

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
                    self._give(list(reversed(sp.pages)))
                    self.mem.page_free(sp.pages)

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
            self._rebuild_free()
            self._by_slot.clear()
            self._pending_free.clear()
            self.mem.pool_reset()


class ShardedPageAllocator(PageAllocator):
    """The slot-affine page pool of the paged engine over a data axis
    (``parallel/serving.py``), the JAX package's allocator of that name.

    Global page ids are striped per data shard: shard ``k`` owns ``[k *
    Pl, (k + 1) * Pl)`` (``Pl = pages_per_shard``) and slot ``s`` belongs
    to shard ``s // (batch / n_shards)``, so every page a slot's table row
    names lives in its shard's sub-pool, which the shard's rank holds.
    Id ``k * Pl`` is shard k's trash page, never handed out: a rank
    localizes its rows as ``clip(table - k * Pl, 0, Pl - 1)``, mapping its
    own ids to ``[1, Pl)`` and trash or zeroed entries to its local trash
    page 0. A foreign id would localize to a wrong page, so none may enter
    a row: ``usable_prefix`` trims prefix hits at the first foreign page
    and ``allocate_with_prefix`` raises on one."""

    def __init__(self, pages_per_shard: int, n_shards: int, page_size: int,
                 max_seq: int, batch: int) -> None:
        if n_shards < 1 or batch % n_shards:
            raise ValueError(
                f"batch {batch} must divide over n_shards {n_shards}")
        if pages_per_shard < 2:
            raise ValueError("need >= 2 pages per shard (one is trash)")
        # the geometry first: the base's __init__ calls _rebuild_free
        self.n_shards = n_shards
        self.pages_per_shard = pages_per_shard
        self.slots_per_shard = batch // n_shards
        super().__init__(pages_per_shard * n_shards, page_size, max_seq,
                         batch)

    # swarmlint: holds[self._lock]
    def _rebuild_free(self) -> None:
        pl = self.pages_per_shard
        self._free_by_shard: List[List[int]] = [
            list(range((k + 1) * pl - 1, k * pl, -1))
            for k in range(self.n_shards)]

    # swarmlint: holds[self._lock]
    def _take(self, slot_id: int, n: int) -> Optional[List[int]]:
        free = self._free_by_shard[self.shard_of(slot_id)]
        if len(free) < n:
            return None
        return [free.pop() for _ in range(n)]

    # swarmlint: holds[self._lock]
    def _give(self, page_ids: List[int]) -> None:
        for p in page_ids:
            self._free_by_shard[self.shard_of_page(p)].append(p)

    def _check_prefix(self, slot_id: int, prefix_pages: List[int]) -> None:
        shard = self.shard_of(slot_id)
        if any(self.shard_of_page(p) != shard for p in prefix_pages):
            # an engine bug: usable_prefix must have trimmed these
            raise RuntimeError(
                f"slot {slot_id} (shard {shard}) referencing foreign-"
                f"shard prefix pages {prefix_pages}")

    def shard_of(self, slot_id: int) -> int:
        return min(self.n_shards - 1, slot_id // self.slots_per_shard)

    def shard_of_page(self, page_id: int) -> int:
        return min(self.n_shards - 1, page_id // self.pages_per_shard)

    def slot_capacity(self) -> int:
        # a slot draws from its own shard's sub-pool only
        return self.pages_per_shard - 1

    def evictable(self, slot_id: int) -> Optional[Callable[[int], bool]]:
        # only same-shard cache pages can cover this slot's shortfall
        shard = self.shard_of(slot_id)
        return lambda p: self.shard_of_page(p) == shard

    def usable_prefix(self, slot_id: int, hits: List[int]) -> int:
        """Trim a prefix match at the first page outside the slot's shard
        (its rank cannot address it)."""
        shard = self.shard_of(slot_id)
        n = 0
        for p in hits:
            if self.shard_of_page(p) != shard:
                break
            n += 1
        return n

    def can_allocate(self, n: int) -> bool:
        with self._lock:
            return any(len(f) >= n for f in self._free_by_shard)

    def free_count(self, slot_id: Optional[int] = None) -> int:
        with self._lock:
            if slot_id is None:
                return sum(len(f) for f in self._free_by_shard)
            return len(self._free_by_shard[self.shard_of(slot_id)])

    def reserve(self, n: int) -> List[int]:
        """As the base's, taking from each shard in turn."""
        with self._lock:
            out: List[int] = []
            while len(out) < n and any(self._free_by_shard):
                for free in self._free_by_shard:
                    if free and len(out) < n:
                        out.append(free.pop())
            self.mem.page_alloc(out)
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "free_pages": sum(len(f) for f in self._free_by_shard),
                "free_by_shard": [len(f) for f in self._free_by_shard],
                "live_slots": len(self._by_slot),
                "page_size": self.page_size,
                "n_shards": self.n_shards,
                "pages_allocated_total": self.pages_allocated_total,
                "pages_freed_total": self.pages_freed_total,
            }
