"""The serving path's two attention kernels: wrappers, plain versions and
launch counts.

Counterparts of two Pallas kernels of ``swarmdb_tpu/ops/attention_pallas.py``:

- ``ragged_paged_prefill_attention``: packed ragged prefill over a wave
  (``csrc/ragged_prefill.cu``; the TPU kernel is ``_ragged_prefill_kernel``).
- ``paged_decode_gqa_attention_chunked``: two-segment paged decode, frozen
  pool + chunk buffer (``csrc/paged_decode_chunked.cu``; the TPU kernel is
  ``_paged_chunk_attn_kernel``).

Each wrapper checks device, dtype, shape and contiguity, then runs the
plain PyTorch version when the tensors lie on the CPU, and launches its
CUDA kernel when they lie on a CUDA device -- there is no fallback from
one to the other. ``LAUNCHES`` counts kernel launches (never plain-version
calls), so a run can show that its main path went through the kernels.
The kernels compile at first use (``ops/build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build
from .layers import gqa_attention_chunked, ragged_prefill_attention_reference
from .paged_kv import paged_gather_kv

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"ragged_prefill": 0, "paged_decode_chunked": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)  # instantiated in csrc/*.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_common(tensors: Dict[str, torch.Tensor],
                  ints: Dict[str, torch.Tensor]) -> torch.device:
    dev = next(iter(tensors.values())).device
    dtype = next(iter(tensors.values())).dtype
    _check(dtype in _DTYPE_CODE,
           f"attention kernels take float32 or bfloat16, got {dtype}")
    for name, t in {**tensors, **ints}.items():
        _check(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in tensors.items():
        _check(t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
    for name, t in ints.items():
        _check(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _check(dev.type in ("cpu", "cuda"),
           f"attention kernels run on cpu or cuda, not {dev.type}")
    return dev


def _cuda_ready(dev: torch.device, D: int, dtype: torch.dtype) -> None:
    _check(D in _HEAD_DIMS, f"head dim {D} has no kernel instance "
           f"(built: {_HEAD_DIMS})")
    _check(D * (2 if dtype == torch.bfloat16 else 4) % 16 == 0,
           "K/V rows must be whole 16-byte vectors")


def _raise_on(code: int, lib: ctypes.CDLL, fn: str) -> None:
    if code != 0:
        err = getattr(lib, f"{fn}_error")
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{fn} launch failed: cuda error {code} "
                           f"({err(code).decode()})")


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


# --------------------------------------------------------------- prefill


def ragged_prefill_plain(
    q: torch.Tensor,           # [W, Hq, D] packed query stream
    sfx_k: torch.Tensor,       # [W, Hkv, D]
    sfx_v: torch.Tensor,
    k_pages: torch.Tensor,     # [P, ps, Hkv, D]
    v_pages: torch.Tensor,
    row_tables: torch.Tensor,  # [R, maxp] int32
    starts: torch.Tensor,      # [R] int32
    lens: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the ragged prefill kernel: the dense reference
    (``layers.ragged_prefill_attention_reference``) with the kernel's
    output contract -- stream positions no row owns are zero."""
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
    """Ragged paged prefill attention over a packed wave; [W, Hq, D] in
    q.dtype, zero where no row owns the position. The kernel on CUDA
    tensors, ``ragged_prefill_plain`` on CPU tensors."""
    dev = _check_common(
        {"q": q, "sfx_k": sfx_k, "sfx_v": sfx_v, "k_pages": k_pages,
         "v_pages": v_pages},
        {"row_tables": row_tables, "starts": starts, "lens": lens,
         "prefix_lens": prefix_lens})
    W, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    R, maxp = row_tables.shape
    _check(sfx_k.shape == (W, Hkv, D) and sfx_v.shape == (W, Hkv, D),
           f"suffix K/V must be [{W}, {Hkv}, {D}]")
    _check(v_pages.shape == k_pages.shape and k_pages.shape[3] == D,
           "K/V pools must be [P, ps, Hkv, D] alike")
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _check(starts.shape == (R,) and lens.shape == (R,)
           and prefix_lens.shape == (R,), f"descriptors must be [{R}]")
    if dev.type == "cpu":
        return ragged_prefill_plain(q, sfx_k, sfx_v, k_pages, v_pages,
                                    row_tables, starts, lens, prefix_lens,
                                    window=window)
    _cuda_ready(dev, D, q.dtype)
    lib = build.load("ragged_prefill")
    fn = lib.swarm_ragged_prefill
    fn.restype = _I
    fn.argtypes = [_I] + [_P] * 10 + [_I] * 9 + [_F, _P]
    out = torch.zeros_like(q)
    with torch.cuda.device(dev):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), sfx_k.data_ptr(),
                  sfx_v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  row_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
                  prefix_lens.data_ptr(), out.data_ptr(), W, R, Hq, Hkv, D,
                  P, ps, maxp, int(window or 0), _scale(D),
                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, lib, "swarm_ragged_prefill")
    LAUNCHES["ragged_prefill"] += 1
    return out


# ---------------------------------------------------------------- decode


def paged_decode_chunked_plain(
    q: torch.Tensor,           # [B, Hq, D]
    k_pages: torch.Tensor,     # [P, ps, Hkv, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp] int32
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D]
    chunk_v: torch.Tensor,
    starts: torch.Tensor,      # [B] int32
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the paged decode kernel: gather each slot's pages
    into a dense view, then the two-segment attention
    (``layers.gqa_attention_chunked``)."""
    kg, vg = paged_gather_kv(k_pages, v_pages, page_table)
    q_pos = (starts.long() + step)[:, None]
    out = gqa_attention_chunked(q[:, None], kg, vg, chunk_k, chunk_v, q_pos,
                                step, window=window)
    return out[:, 0]


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
    """Two-segment paged decode attention; [B, Hq, D] in q.dtype. The
    kernel on CUDA tensors, ``paged_decode_chunked_plain`` on CPU tensors.
    ``step`` is the index of this step within the chunk (a host int)."""
    dev = _check_common(
        {"q": q, "k_pages": k_pages, "v_pages": v_pages, "chunk_k": chunk_k,
         "chunk_v": chunk_v},
        {"page_table": page_table, "starts": starts})
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    Kc = chunk_k.shape[1]
    _check(v_pages.shape == k_pages.shape and k_pages.shape[3] == D,
           "K/V pools must be [P, ps, Hkv, D] alike")
    _check(chunk_k.shape == (B, Kc, Hkv, D) and chunk_v.shape == chunk_k.shape,
           f"chunk buffers must be [{B}, Kc, {Hkv}, {D}]")
    _check(page_table.shape[0] == B and starts.shape == (B,),
           f"page_table and starts must cover {B} slots")
    _check(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    step = int(step)
    _check(0 <= step < Kc, f"step {step} outside the chunk of {Kc}")
    if dev.type == "cpu":
        return paged_decode_chunked_plain(q, k_pages, v_pages, page_table,
                                          chunk_k, chunk_v, starts, step,
                                          window=window)
    _cuda_ready(dev, D, q.dtype)
    lib = build.load("paged_decode_chunked")
    fn = lib.swarm_paged_decode_chunked
    fn.restype = _I
    fn.argtypes = [_I] + [_P] * 7 + [_I, _I, _F, _P] + [_I] * 8 + [_P]
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), page_table.data_ptr(),
                  chunk_k.data_ptr(), chunk_v.data_ptr(), starts.data_ptr(),
                  step, int(window or 0), _scale(D), out.data_ptr(), B, Hq,
                  Hkv, D, P, ps, maxp, Kc,
                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, lib, "swarm_paged_decode_chunked")
    LAUNCHES["paged_decode_chunked"] += 1
    return out
