"""The serving paths' attention kernels: wrappers, plain versions and
launch counts.

Counterparts of the eight Pallas kernels of
``swarmdb_tpu/ops/attention_pallas.py``: three over plain (f32 / bf16)
pages, three over int8 pages with f32 scales per (page, KV head), and two
over a dense slot cache:

- ``ragged_paged_prefill_attention`` / ``..._quant``: packed ragged
  prefill over a wave (``csrc/ragged_prefill.cu`` /
  ``ragged_prefill_quant.cu``; the TPU kernels are
  ``_ragged_prefill_kernel`` / ``..._quant``).
- ``paged_decode_gqa_attention_chunked`` / ``..._quant``: two-segment paged
  decode, frozen pool + chunk buffer (``csrc/paged_decode_chunked.cu`` /
  ``paged_decode_chunked_quant.cu``; ``_paged_chunk_attn_kernel`` /
  ``..._quant``).
- ``paged_decode_gqa_attention`` / ``..._quant``: single-step paged decode
  over the live pages (``csrc/paged_decode.cu`` / ``paged_decode_quant.cu``;
  ``_paged_attn_kernel`` / ``..._quant``).
- ``decode_gqa_attention_chunked`` / ``decode_gqa_attention``: the dense
  engine's two-segment and single-step decode over a ``[B, S, Hkv, D]``
  slot cache (``csrc/dense_decode_chunked.cu`` / ``dense_decode.cu``;
  ``_dense_chunk_attn_kernel`` / ``_decode_attn_kernel``), the same loops
  over each slot's contiguous lane instead of its page-table row.

Each operand keeps its own type: the query (and so the output), the chunk
buffer and the packed suffix are float32 or bfloat16 each; the pages and
the dense cache are float32 / bfloat16, or (pages only) int8 with float32
scales. Everything is computed in
float32, as the Pallas kernels do. Each wrapper checks device, dtype, shape
and contiguity, then runs the plain PyTorch version when the tensors lie on
the CPU, and launches its CUDA kernel when they lie on a CUDA device --
there is no fallback from one to the other. ``LAUNCHES`` counts kernel
launches (never plain-version calls) under the kernel's name, which is also
its library's (``ops/build.py``) and, prefixed with ``swarm_``, its entry
point's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build
from .layers import (gqa_attention_chunked_reference,
                     gqa_attention_reference,
                     ragged_prefill_attention_reference)
from .paged_kv import QuantPool, paged_gather_kv

#: Kernel launches per kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {name: 0 for name in build.KERNELS}

_FLOAT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in csrc/*.cuh
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_args(floats: Dict[str, torch.Tensor],
                pages: Dict[str, torch.Tensor],
                ints: Dict[str, torch.Tensor],
                scales: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.device:
    """One device, contiguous tensors, and the types each kernel takes:
    ``floats`` float32 or bfloat16 each; ``pages`` float32 or bfloat16
    alike, or int8 when ``scales`` (float32) are given; ``ints`` int32."""
    dev = next(iter(floats.values())).device
    scales = scales or {}
    for name, t in {**floats, **pages, **ints, **scales}.items():
        _check(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in floats.items():
        _check(t.dtype in _FLOAT_CODE, "attention kernels take float32 or "
               f"bfloat16 for {name}, got {t.dtype}")
    page_dtypes = {t.dtype for t in pages.values()}
    _check(len(page_dtypes) == 1,
           f"K and V pages differ in dtype: {sorted(map(str, page_dtypes))}")
    page_dtype = page_dtypes.pop()
    if scales:
        _check(page_dtype == torch.int8,
               f"quantized pages must be int8, got {page_dtype}")
        for name, t in scales.items():
            _check(t.dtype == torch.float32,
                   f"{name} must be float32, got {t.dtype}")
    else:
        _check(page_dtype in _FLOAT_CODE, "attention kernels take float32 "
               f"or bfloat16 pages (int8 through the _quant wrappers), got "
               f"{page_dtype}")
    for name, t in ints.items():
        _check(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _check(dev.type in ("cpu", "cuda"),
           f"attention kernels run on cpu or cuda, not {dev.type}")
    return dev


def _check_pools(k_pages, v_pages, k_scale, v_scale, D: int) -> None:
    _check(v_pages.shape == k_pages.shape and k_pages.dim() == 4
           and k_pages.shape[3] == D,
           "K/V pools must be [P, ps, Hkv, D] alike")
    if k_scale is not None:
        want = tuple(k_pages.shape[0:1]) + tuple(k_pages.shape[2:3])
        _check(tuple(k_scale.shape) == want and tuple(v_scale.shape) == want,
               f"page scales must be [P, Hkv] = {list(want)}")


def _cuda_ready(D: int, *tensors: torch.Tensor) -> None:
    _check(D in _HEAD_DIMS, f"head dim {D} has no kernel instance "
           f"(built: {_HEAD_DIMS})")
    for t in tensors:
        _check(D * t.element_size() % 16 == 0,
               "rows must be whole 16-byte vectors")


def _launch(kernel: str, sig: str, dev: torch.device, *args) -> None:
    """Call ``swarm_<kernel>`` of library ``kernel`` on the current stream
    of ``dev`` (the stream is the last argument of every entry point);
    ``sig`` spells the other arguments' C types (p pointer, i int, f
    float). Raises on a refused launch; counts the launch."""
    lib = build.load(kernel)
    entry = f"swarm_{kernel}"
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in sig + "p"]
    with torch.cuda.device(dev):
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        err = getattr(lib, f"{entry}_error")
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: cuda error {code} "
                           f"({err(code).decode()})")
    LAUNCHES[kernel] += 1


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


def _pool(pages: torch.Tensor, scale: Optional[torch.Tensor]):
    return pages if scale is None else QuantPool(pages, scale)


# --------------------------------------------------------------- prefill


def ragged_prefill_plain(
    q: torch.Tensor,           # [W, Hq, D] packed query stream
    sfx_k: torch.Tensor,       # [W, Hkv, D]
    sfx_v: torch.Tensor,
    k_pages,                   # [P, ps, Hkv, D], or a QuantPool
    v_pages,
    row_tables: torch.Tensor,  # [R, maxp] int32
    starts: torch.Tensor,      # [R] int32
    lens: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the ragged prefill kernels: the dense reference
    (``layers.ragged_prefill_attention_reference``, which dequantizes a
    quantized pool) with the kernels' output contract -- stream positions
    no row owns are zero."""
    W = q.shape[0]
    R = row_tables.shape[0]
    x = torch.arange(W, device=q.device)
    st = starts.long()[:, None]
    own = (x[None, :] >= st) & (x[None, :] < st + lens.long()[:, None])
    owned = own.any(dim=0)
    tok_row = torch.where(owned, own.int().argmax(dim=0),
                          torch.full_like(x, R))
    out = ragged_prefill_attention_reference(
        q, sfx_k, sfx_v, k_pages, v_pages, row_tables, starts, lens,
        prefix_lens, tok_row, window=window)
    return torch.where(owned[:, None, None], out, torch.zeros_like(out))


def ragged_prefill_quant_plain(q, sfx_k, sfx_v, k_pages, k_scale, v_pages,
                               v_scale, row_tables, starts, lens,
                               prefix_lens, *, window=None) -> torch.Tensor:
    """Plain version of the int8 ragged prefill kernel."""
    return ragged_prefill_plain(
        q, sfx_k, sfx_v, QuantPool(k_pages, k_scale),
        QuantPool(v_pages, v_scale), row_tables, starts, lens, prefix_lens,
        window=window)


def _ragged_prefill(q, sfx_k, sfx_v, k_pages, k_scale, v_pages, v_scale,
                    row_tables, starts, lens, prefix_lens, window):
    quant = k_scale is not None
    dev = _check_args(
        {"q": q, "sfx_k": sfx_k, "sfx_v": sfx_v},
        {"k_pages": k_pages, "v_pages": v_pages},
        {"row_tables": row_tables, "starts": starts, "lens": lens,
         "prefix_lens": prefix_lens},
        {"k_scale": k_scale, "v_scale": v_scale} if quant else None)
    W, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    R, maxp = row_tables.shape
    _check(sfx_k.shape == (W, Hkv, D) and sfx_v.shape == (W, Hkv, D),
           f"suffix K/V must be [{W}, {Hkv}, {D}]")
    _check(sfx_k.dtype == sfx_v.dtype, "suffix K and V differ in dtype")
    _check_pools(k_pages, v_pages, k_scale, v_scale, D)
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _check(starts.shape == (R,) and lens.shape == (R,)
           and prefix_lens.shape == (R,), f"descriptors must be [{R}]")
    if dev.type == "cpu":
        return ragged_prefill_plain(
            q, sfx_k, sfx_v, _pool(k_pages, k_scale), _pool(v_pages, v_scale),
            row_tables, starts, lens, prefix_lens, window=window)
    _cuda_ready(D, q, sfx_k, k_pages)
    out = torch.zeros_like(q)
    ptrs = [q.data_ptr(), sfx_k.data_ptr(), sfx_v.data_ptr(),
            k_pages.data_ptr()]
    ptrs += [k_scale.data_ptr(), v_pages.data_ptr(), v_scale.data_ptr()] \
        if quant else [v_pages.data_ptr()]
    ptrs += [row_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
             prefix_lens.data_ptr(), out.data_ptr()]
    shape = [W, R, Hq, Hkv, D, P, ps, maxp, int(window or 0)]
    codes = [_FLOAT_CODE[q.dtype], _FLOAT_CODE[sfx_k.dtype]]
    if quant:
        _launch("ragged_prefill_quant", "ii" + "p" * 12 + "i" * 9 + "f", dev,
                *codes, *ptrs, *shape, _scale(D))
    else:
        _launch("ragged_prefill", "iii" + "p" * 10 + "i" * 9 + "f", dev,
                _FLOAT_CODE[k_pages.dtype], *codes, *ptrs, *shape, _scale(D))
    return out


def ragged_paged_prefill_attention(
    q: torch.Tensor,
    sfx_k: torch.Tensor,
    sfx_v: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    row_tables: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged paged prefill attention over a packed wave and a plain pool;
    [W, Hq, D] in q.dtype, zero where no row owns the position. The kernel
    on CUDA tensors, ``ragged_prefill_plain`` on CPU tensors."""
    return _ragged_prefill(q, sfx_k, sfx_v, k_pages, None, v_pages, None,
                           row_tables, starts, lens, prefix_lens, window)


def ragged_paged_prefill_attention_quant(
    q: torch.Tensor,
    sfx_k: torch.Tensor,       # [W, Hkv, D] full precision
    sfx_v: torch.Tensor,
    k_pages: torch.Tensor,     # [P, ps, Hkv, D] int8
    k_scale: torch.Tensor,     # [P, Hkv] float32
    v_pages: torch.Tensor,
    v_scale: torch.Tensor,
    row_tables: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged paged prefill attention over int8 prefix pages; as
    ``ragged_paged_prefill_attention`` otherwise."""
    return _ragged_prefill(q, sfx_k, sfx_v, k_pages, k_scale, v_pages,
                           v_scale, row_tables, starts, lens, prefix_lens,
                           window)


# -------------------------------------------------------- chunked decode


def paged_decode_chunked_plain(
    q: torch.Tensor,           # [B, Hq, D]
    k_pages,                   # [P, ps, Hkv, D], or a QuantPool
    v_pages,
    page_table: torch.Tensor,  # [B, maxp] int32
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D]
    chunk_v: torch.Tensor,
    starts: torch.Tensor,      # [B] int32
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the two-segment decode kernels: gather each slot's
    pages into a dense view (dequantized for a quantized pool), then the
    two-segment attention (``layers.gqa_attention_chunked_reference``)."""
    kg, vg = paged_gather_kv(k_pages, v_pages, page_table)
    return decode_chunked_plain(q, kg, vg, chunk_k, chunk_v, starts, step,
                                window=window)


def paged_decode_chunked_quant_plain(q, k_pages, k_scale, v_pages, v_scale,
                                     page_table, chunk_k, chunk_v, starts,
                                     step, *, window=None) -> torch.Tensor:
    """Plain version of the int8 two-segment decode kernel."""
    return paged_decode_chunked_plain(
        q, QuantPool(k_pages, k_scale), QuantPool(v_pages, v_scale),
        page_table, chunk_k, chunk_v, starts, step, window=window)


def _paged_decode_chunked(q, k_pages, k_scale, v_pages, v_scale, page_table,
                          chunk_k, chunk_v, starts, step, window):
    quant = k_scale is not None
    dev = _check_args(
        {"q": q, "chunk_k": chunk_k, "chunk_v": chunk_v},
        {"k_pages": k_pages, "v_pages": v_pages},
        {"page_table": page_table, "starts": starts},
        {"k_scale": k_scale, "v_scale": v_scale} if quant else None)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    Kc = chunk_k.shape[1]
    _check_pools(k_pages, v_pages, k_scale, v_scale, D)
    _check(chunk_k.shape == (B, Kc, Hkv, D) and chunk_v.shape == chunk_k.shape,
           f"chunk buffers must be [{B}, Kc, {Hkv}, {D}]")
    _check(chunk_k.dtype == chunk_v.dtype, "chunk K and V differ in dtype")
    _check(page_table.shape[0] == B and starts.shape == (B,),
           f"page_table and starts must cover {B} slots")
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    step = int(step)
    _check(0 <= step < Kc, f"step {step} outside the chunk of {Kc}")
    if dev.type == "cpu":
        return paged_decode_chunked_plain(
            q, _pool(k_pages, k_scale), _pool(v_pages, v_scale), page_table,
            chunk_k, chunk_v, starts, step, window=window)
    _cuda_ready(D, q, chunk_k, k_pages)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k_pages.data_ptr()]
    ptrs += [k_scale.data_ptr(), v_pages.data_ptr(), v_scale.data_ptr()] \
        if quant else [v_pages.data_ptr()]
    ptrs += [page_table.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
             starts.data_ptr()]
    rest = [step, int(window or 0), _scale(D), out.data_ptr(), B, Hq, Hkv, D,
            P, ps, maxp, Kc]
    codes = [_FLOAT_CODE[q.dtype], _FLOAT_CODE[chunk_k.dtype]]
    if quant:
        _launch("paged_decode_chunked_quant", "ii" + "p" * 9 + "iifp"
                + "i" * 8, dev, *codes, *ptrs, *rest)
    else:
        _launch("paged_decode_chunked", "iii" + "p" * 7 + "iifp" + "i" * 8,
                dev, _FLOAT_CODE[k_pages.dtype], *codes, *ptrs, *rest)
    return out


def paged_decode_gqa_attention_chunked(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    starts: torch.Tensor,
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment paged decode attention over a plain pool; [B, Hq, D] in
    q.dtype. The kernel on CUDA tensors, ``paged_decode_chunked_plain`` on
    CPU tensors. ``step`` is the index of this step within the chunk (a
    host int)."""
    return _paged_decode_chunked(q, k_pages, None, v_pages, None, page_table,
                                 chunk_k, chunk_v, starts, step, window)


def paged_decode_gqa_attention_chunked_quant(
    q: torch.Tensor,
    k_pages: torch.Tensor,     # [P, ps, Hkv, D] int8
    k_scale: torch.Tensor,     # [P, Hkv] float32
    v_pages: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D] full precision
    chunk_v: torch.Tensor,
    starts: torch.Tensor,
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment paged decode attention over int8 pages; as
    ``paged_decode_gqa_attention_chunked`` otherwise."""
    return _paged_decode_chunked(q, k_pages, k_scale, v_pages, v_scale,
                                 page_table, chunk_k, chunk_v, starts, step,
                                 window)


# ---------------------------------------------------- single-step decode


def paged_decode_plain(
    q: torch.Tensor,           # [B, Hq, D]
    k_pages,                   # [P, ps, Hkv, D], or a QuantPool
    v_pages,
    page_table: torch.Tensor,  # [B, maxp] int32
    lengths: torch.Tensor,     # [B] int32 live positions (position + 1)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the single-step decode kernels: gather each slot's
    pages into a dense view (dequantized for a quantized pool), then the
    dense decode attention (``decode_plain``) at position ``length - 1``.
    A slot of length 0 gives zeros, as the kernels do."""
    kg, vg = paged_gather_kv(k_pages, v_pages, page_table)
    return decode_plain(q, kg, vg, lengths, window=window)


def paged_decode_quant_plain(q, k_pages, k_scale, v_pages, v_scale,
                             page_table, lengths, *, window=None
                             ) -> torch.Tensor:
    """Plain version of the int8 single-step decode kernel."""
    return paged_decode_plain(q, QuantPool(k_pages, k_scale),
                              QuantPool(v_pages, v_scale), page_table,
                              lengths, window=window)


def _paged_decode(q, k_pages, k_scale, v_pages, v_scale, page_table,
                  lengths, window):
    quant = k_scale is not None
    dev = _check_args(
        {"q": q}, {"k_pages": k_pages, "v_pages": v_pages},
        {"page_table": page_table, "lengths": lengths},
        {"k_scale": k_scale, "v_scale": v_scale} if quant else None)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    _check_pools(k_pages, v_pages, k_scale, v_scale, D)
    _check(page_table.shape[0] == B and lengths.shape == (B,),
           f"page_table and lengths must cover {B} slots")
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dev.type == "cpu":
        return paged_decode_plain(q, _pool(k_pages, k_scale),
                                  _pool(v_pages, v_scale), page_table,
                                  lengths, window=window)
    _cuda_ready(D, q, k_pages)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), k_pages.data_ptr()]
    ptrs += [k_scale.data_ptr(), v_pages.data_ptr(), v_scale.data_ptr()] \
        if quant else [v_pages.data_ptr()]
    ptrs += [page_table.data_ptr(), lengths.data_ptr()]
    rest = [int(window or 0), _scale(D), out.data_ptr(), B, Hq, Hkv, D, P,
            ps, maxp]
    if quant:
        _launch("paged_decode_quant", "i" + "p" * 7 + "ifp" + "i" * 7, dev,
                _FLOAT_CODE[q.dtype], *ptrs, *rest)
    else:
        _launch("paged_decode", "ii" + "p" * 5 + "ifp" + "i" * 7, dev,
                _FLOAT_CODE[k_pages.dtype], _FLOAT_CODE[q.dtype], *ptrs,
                *rest)
    return out


def paged_decode_gqa_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-step paged decode attention over a plain pool: each slot's
    query attends its positions < ``lengths``; [B, Hq, D] in q.dtype, zeros
    for a slot of length 0. The kernel on CUDA tensors,
    ``paged_decode_plain`` on CPU tensors."""
    return _paged_decode(q, k_pages, None, v_pages, None, page_table,
                         lengths, window)


def paged_decode_gqa_attention_quant(
    q: torch.Tensor,
    k_pages: torch.Tensor,     # [P, ps, Hkv, D] int8
    k_scale: torch.Tensor,     # [P, Hkv] float32
    v_pages: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-step paged decode attention over int8 pages; as
    ``paged_decode_gqa_attention`` otherwise."""
    return _paged_decode(q, k_pages, k_scale, v_pages, v_scale, page_table,
                         lengths, window)


# ---------------------------------------------------- dense slot cache


def decode_chunked_plain(
    q: torch.Tensor,           # [B, Hq, D]
    cache_k: torch.Tensor,     # [B, S, Hkv, D] dense view (FROZEN)
    cache_v: torch.Tensor,
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D]
    chunk_v: torch.Tensor,
    starts: torch.Tensor,      # [B] int32 chunk start (= position - step)
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the dense two-segment decode kernel: the JAX
    package's einsum form (``layers.gqa_attention_chunked_reference``) at
    position ``start + step``. Also the paged plain versions' core, after
    their page gather."""
    q_pos = (starts.long() + step)[:, None]
    out = gqa_attention_chunked_reference(q[:, None], cache_k, cache_v,
                                          chunk_k, chunk_v, q_pos, step,
                                          window=window)
    return out[:, 0]


def decode_plain(
    q: torch.Tensor,           # [B, Hq, D]
    cache_k: torch.Tensor,     # [B, S, Hkv, D] dense view
    cache_v: torch.Tensor,
    lengths: torch.Tensor,     # [B] int32 live positions (position + 1)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the dense single-step decode kernel: the JAX
    package's einsum form (``layers.gqa_attention_reference``) at position
    ``length - 1``. A slot of length 0 gives zeros, as the kernels do (the
    Pallas kernel returns the lane's mean value row there). Also the paged
    plain versions' core, after their page gather."""
    out = gqa_attention_reference(q[:, None], cache_k, cache_v,
                                  (lengths.long() - 1)[:, None],
                                  window=window)[:, 0]
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros_like(out))


def _check_lanes(cache_k, cache_v, B: int, Hq: int, D: int) -> None:
    _check(cache_k.dim() == 4 and cache_v.shape == cache_k.shape
           and cache_k.shape[0] == B and cache_k.shape[3] == D,
           f"K/V caches must be [{B}, S, Hkv, {D}] alike")
    _check(cache_k.shape[1] > 0, "the cache lanes are empty")
    _check(Hq % cache_k.shape[2] == 0,
           f"Hq={Hq} is not a multiple of Hkv={cache_k.shape[2]}")


def decode_gqa_attention_chunked(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    starts: torch.Tensor,
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment decode attention over a dense slot cache: each slot
    attends its lane at positions < ``starts`` (never past S) plus its
    chunk entries <= ``step`` (a host int); [B, Hq, D] in q.dtype. The
    kernel on CUDA tensors, ``decode_chunked_plain`` on CPU tensors."""
    dev = _check_args({"q": q, "chunk_k": chunk_k, "chunk_v": chunk_v},
                      {"cache_k": cache_k, "cache_v": cache_v},
                      {"starts": starts})
    B, Hq, D = q.shape
    _check_lanes(cache_k, cache_v, B, Hq, D)
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    Kc = chunk_k.shape[1]
    _check(chunk_k.shape == (B, Kc, Hkv, D) and chunk_v.shape == chunk_k.shape,
           f"chunk buffers must be [{B}, Kc, {Hkv}, {D}]")
    _check(chunk_k.dtype == chunk_v.dtype, "chunk K and V differ in dtype")
    _check(starts.shape == (B,), f"starts must cover {B} slots")
    step = int(step)
    _check(0 <= step < Kc, f"step {step} outside the chunk of {Kc}")
    if dev.type == "cpu":
        return decode_chunked_plain(q, cache_k, cache_v, chunk_k, chunk_v,
                                    starts, step, window=window)
    _cuda_ready(D, q, chunk_k, cache_k)
    out = torch.empty_like(q)
    _launch("dense_decode_chunked", "iii" + "p" * 6 + "iifp" + "i" * 6, dev,
            _FLOAT_CODE[cache_k.dtype], _FLOAT_CODE[q.dtype],
            _FLOAT_CODE[chunk_k.dtype], q.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
            starts.data_ptr(), step, int(window or 0), _scale(D),
            out.data_ptr(), B, Hq, Hkv, D, S, Kc)
    return out


def decode_gqa_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-step decode attention over a dense slot cache: each slot's
    query attends its positions < ``lengths`` (never past S); with a
    window, positions at or below length - 1 - window are masked. [B, Hq,
    D] in q.dtype, zeros for a slot of length 0. The kernel on CUDA
    tensors, ``decode_plain`` on CPU tensors."""
    dev = _check_args({"q": q}, {"cache_k": cache_k, "cache_v": cache_v},
                      {"lengths": lengths})
    B, Hq, D = q.shape
    _check_lanes(cache_k, cache_v, B, Hq, D)
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    _check(lengths.shape == (B,), f"lengths must cover {B} slots")
    if dev.type == "cpu":
        return decode_plain(q, cache_k, cache_v, lengths, window=window)
    _cuda_ready(D, q, cache_k)
    out = torch.empty_like(q)
    _launch("dense_decode", "ii" + "p" * 4 + "ifp" + "i" * 5, dev,
            _FLOAT_CODE[cache_k.dtype], _FLOAT_CODE[q.dtype], q.data_ptr(),
            cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            int(window or 0), _scale(D), out.data_ptr(), B, Hq, Hkv, D, S)
    return out
