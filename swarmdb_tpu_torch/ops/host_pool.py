"""Warm-tier host page store: the middle rung of the conversation-state
hierarchy (device pool -> host memory -> log replay).

The counterpart of ``swarmdb_tpu/ops/host_pool.py``. Pages demoted out of
the device pool land here as raw storage-width payloads
(:func:`ops.paged_kv.pool_gather_pages`: int8 data plus f32 scales on a
quantized pool, the pool's dtype verbatim otherwise), keyed by
conversation. Promotion pops the entry; eviction out of this store is the
warm -> cold transition (the conversation then re-prefills from the
broker log).

Capacity is byte-priced: ``SWARMDB_TIER_WARM_MB`` (default 256; 0 turns
the warm tier off, every demotion then falls through to cold). The store
is plain LRU over conversations: who gets demoted is decided on the device
side (``backend/tiering.py``); once spilled, recency is the only signal.

The store owns one host buffer of its capacity (the slab), page-locked
when the pool lives on the card, so the page-locked memory a process
holds for the warm tier is the configured capacity and no demotion pays
for page-locking. A demotion's copy lands in tensors carved out of the
slab (:meth:`HostPageStore.host_tensor`, first fit, evicting the least
recently used entries while a payload does not fit); promotion's copy
back (``pool_insert_raw``) reads them asynchronously on the engine's
stream. A carved tensor gives its bytes back to the slab when it is
garbage, so a popped payload keeps them for as long as a copy may still
read it.

``SWARMDB_TIER_ZSTD=1`` compresses payloads at rest, with zstd where the
``zstandard`` package is installed and zlib otherwise (the same seam and
the same bytes as the JAX package's store; a bf16 tensor is compressed as
its raw bytes). The codec is resolved per store, at construction.

Thread-safe: the engine thread puts payloads in, the service thread
(``_rolling_plan``) pops them out.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.sync import make_lock


def warm_capacity_bytes() -> int:
    """``SWARMDB_TIER_WARM_MB`` in bytes (default 256 MiB; 0 disables the
    warm tier)."""
    try:
        mb = float(os.environ.get("SWARMDB_TIER_WARM_MB", "256"))
    except ValueError:
        mb = 256.0
    return max(0, int(mb * (1 << 20)))


def _resolve_codec() -> Optional[Tuple[str, Any, Any]]:
    """(name, compress, decompress) under ``SWARMDB_TIER_ZSTD=1``, else
    None: zstd (level 3) when importable, zlib (level 3) otherwise."""
    if os.environ.get("SWARMDB_TIER_ZSTD", "0") != "1":
        return None
    try:
        import zstandard  # type: ignore

        comp = zstandard.ZstdCompressor(level=3)
        deco = zstandard.ZstdDecompressor()
        return ("zstd", comp.compress, deco.decompress)
    except Exception:
        import zlib

        return ("zlib", lambda b: zlib.compress(b, 3), zlib.decompress)


class _Packed(NamedTuple):
    """One compressed tensor: its blob and what rebuilds it."""

    blob: bytes
    dtype: torch.dtype
    shape: Tuple[int, ...]
    raw_nbytes: int
    pinned: bool


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _pack_tensor(t: torch.Tensor, compress: Any) -> _Packed:
    return _Packed(compress(_raw_bytes(t)), t.dtype, tuple(t.shape),
                   t.numel() * t.element_size(), t.is_pinned())


def _pack(payload: Any, compress: Any) -> Any:
    if isinstance(payload, tuple):
        return tuple(_pack_tensor(p, compress) for p in payload)
    return _pack_tensor(payload, compress)


def _unpack_tensor(p: _Packed, decompress: Any,
                   host: Callable[..., Optional[torch.Tensor]]
                   ) -> torch.Tensor:
    flat = torch.frombuffer(bytearray(decompress(p.blob)), dtype=torch.uint8)
    t = flat.view(p.dtype).reshape(p.shape)
    out = host(p.shape, p.dtype) if p.pinned else None
    if out is None:  # no room in the slab: a pageable copy still serves
        return t
    out.copy_(t)
    return out


def _unpack(payload: Any, decompress: Any, host: Any) -> Any:
    if isinstance(payload, _Packed):
        return _unpack_tensor(payload, decompress, host)
    if isinstance(payload, tuple):
        return tuple(_unpack_tensor(p, decompress, host)
                     if isinstance(p, _Packed) else p for p in payload)
    return payload


def _is_packed(payload: Any) -> bool:
    if isinstance(payload, _Packed):
        return True
    return (isinstance(payload, tuple)
            and any(isinstance(p, _Packed) for p in payload))


def _payload_bytes(payload: Any) -> int:
    if isinstance(payload, _Packed):
        return len(payload.blob)
    if isinstance(payload, tuple):
        return sum(_payload_bytes(p) for p in payload)
    return payload.numel() * payload.element_size()


class WarmEntry(NamedTuple):
    """One spilled conversation: raw k / v payloads of ``n_pages`` pages
    covering ``length`` tokens (promotion reserves exactly ``n_pages``
    device pages), ``nbytes`` as stored (compressed, under the codec)."""

    k: Any
    v: Any
    n_pages: int
    length: int
    nbytes: int


#: slab extents start at multiples of this many bytes (any dtype's view)
_ALIGN = 512


class _Slab:
    """One host buffer carved into byte extents, first fit; an extent
    given back merges with its free neighbours. ``free`` holds [offset,
    size] pairs in offset order."""

    def __init__(self, nbytes: int, pinned: bool, label: str) -> None:
        self.nbytes = nbytes
        self.pinned = pinned
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
        self.free: List[List[int]] = [[0, nbytes]] if nbytes else []
        self.lock = make_lock(f"host_pool.{label}.slab")

    def take(self, n: int) -> Optional[int]:
        with self.lock:
            for i, (off, size) in enumerate(self.free):
                if size >= n:
                    if size == n:
                        del self.free[i]
                    else:
                        self.free[i] = [off + n, size - n]
                    return off
        return None

    def give(self, off: int, n: int) -> None:
        with self.lock:
            free = self.free
            i = 0
            while i < len(free) and free[i][0] < off:
                i += 1
            free.insert(i, [off, n])
            if i + 1 < len(free) and off + n == free[i + 1][0]:
                free[i][1] += free.pop(i + 1)[1]
            if i > 0 and free[i - 1][0] + free[i - 1][1] == off:
                free[i - 1][1] += free.pop(i)[1]

    def in_use(self) -> int:
        with self.lock:
            return self.nbytes - sum(size for _, size in self.free)


class HostPageStore:
    """LRU byte-capped map: conversation key -> :class:`WarmEntry`, over
    one slab of ``capacity_bytes`` (page-locked when ``pinned``)."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 label: str = "warm", pinned: bool = False) -> None:
        self.capacity_bytes = (warm_capacity_bytes()
                               if capacity_bytes is None
                               else int(capacity_bytes))
        self.label = label
        self._slab = _Slab(self.capacity_bytes // _ALIGN * _ALIGN, pinned,
                           label)
        self._lock = make_lock(f"host_pool.{label}")
        self._entries: "OrderedDict[Any, WarmEntry]" = OrderedDict()
        self._bytes = 0
        self._puts = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._codec = _resolve_codec()
        self._raw_in = 0     # uncompressed bytes offered to the codec
        self._comp_in = 0    # compressed bytes stored

    def host_tensor(self, shape: Tuple[int, ...], dtype: torch.dtype,
                    evict: bool = False) -> Tuple[Optional[torch.Tensor],
                                                  List[Any]]:
        """A tensor of ``shape`` and ``dtype`` carved out of the slab, and
        the keys evicted to make room for it (with ``evict``, least
        recently used first, while it does not fit: warm -> cold
        transitions for the caller to count). None when the slab cannot
        hold it. Its bytes go back to the slab when the tensor is
        garbage."""
        n = -(-max(1, _numel(shape) * _itemsize(dtype)) // _ALIGN) * _ALIGN
        evicted: List[Any] = []
        while True:
            off = self._slab.take(n)
            if off is not None:
                break
            if not evict or self._codec is not None:
                # compressed entries live outside the slab: evicting them
                # makes no room
                return None, evicted
            with self._lock:
                if not self._entries:
                    return None, evicted
                victim, ventry = self._entries.popitem(last=False)
                self._bytes -= ventry.nbytes
                self._evictions += 1
            evicted.append(victim)
            del ventry  # its tensors' bytes go back to the slab
        t = self._slab.buf[off:off + n]
        t = t[:_numel(shape) * _itemsize(dtype)].view(dtype).view(shape)
        weakref.finalize(t, self._slab.give, off, n)
        return t, evicted

    def slab_stats(self) -> Dict[str, Any]:
        """The slab's size, its bytes in use (stored entries and payloads
        still in flight) and whether it is page-locked."""
        return {"bytes": self._slab.nbytes, "in_use": self._slab.in_use(),
                "pinned": self._slab.pinned}

    def put(self, key: Any, k_payload: Any, v_payload: Any,
            n_pages: int, length: int) -> List[Any]:
        """Store a demoted conversation (replacing an entry of the same
        key) and return the keys evicted to make room: warm -> cold
        transitions for the caller to count. An entry larger than the
        whole store is not kept and ``[key]`` comes back."""
        raw = _payload_bytes(k_payload) + _payload_bytes(v_payload)
        nbytes = raw
        if self._codec is not None:
            _, compress, _ = self._codec
            k_payload = _pack(k_payload, compress)
            v_payload = _pack(v_payload, compress)
            nbytes = _payload_bytes(k_payload) + _payload_bytes(v_payload)
            with self._lock:
                self._raw_in += raw
                self._comp_in += nbytes
        entry = WarmEntry(k_payload, v_payload, int(n_pages), int(length),
                          nbytes)
        evicted: List[Any] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            if nbytes > self.capacity_bytes:
                return [key]
            while self._bytes + nbytes > self.capacity_bytes and self._entries:
                victim, ventry = self._entries.popitem(last=False)
                self._bytes -= ventry.nbytes
                self._evictions += 1
                evicted.append(victim)
            self._entries[key] = entry
            self._bytes += nbytes
            self._puts += 1
        return evicted

    def pop(self, key: Any) -> Optional[WarmEntry]:
        """Remove and return the entry (promotion consumes it), inflated
        outside the lock when it was compressed."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                self._misses += 1
                return None
            self._bytes -= entry.nbytes
            self._hits += 1
        if _is_packed(entry.k) or _is_packed(entry.v):
            codec = self._codec or _resolve_codec()
            if codec is None:  # the env var went off mid-life
                import zlib

                decompress: Any = zlib.decompress
            else:
                decompress = codec[2]
            def host(shape, dtype):
                return self.host_tensor(shape, dtype)[0]

            k = _unpack(entry.k, decompress, host)
            v = _unpack(entry.v, decompress, host)
            entry = WarmEntry(k, v, entry.n_pages, entry.length,
                              _payload_bytes(k) + _payload_bytes(v))
        return entry

    def has(self, key: Any) -> bool:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)  # arrival interest = touch
                return True
            return False

    def drop(self, key: Any) -> bool:
        """Discard without counting a hit or miss."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._bytes -= entry.nbytes
            return True

    def page_count(self) -> int:
        with self._lock:
            return sum(e.n_pages for e in self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "entries": len(self._entries),
                "pages": sum(e.n_pages for e in self._entries.values()),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "puts": self._puts,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "codec": self._codec[0] if self._codec else None,
            }
            if self._comp_in > 0:
                out["raw_bytes_in"] = self._raw_in
                out["compressed_bytes_in"] = self._comp_in
                out["compress_ratio"] = round(self._raw_in / self._comp_in,
                                              3)
            return out
