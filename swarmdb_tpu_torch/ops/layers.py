"""Transformer building blocks in PyTorch.

The counterpart of ``swarmdb_tpu/ops/layers.py`` for the serving paths:
RMSNorm, rotary embeddings (split-half convention, math in fp32), the
Q/K/V projection, SwiGLU; the dense slot cache's write, chunk merge,
prefix-lane composition and prefix attention; the single-step and
two-segment decode attentions over a dense view (the einsum references,
which are also the plain decode versions), the dense ragged-prefill
reference (the plain prefill version), and the dispatchers the Llama
forwards call: the two dense decode attentions and three paged ones, each
of the paged ones taking a plain pool or an int8 ``QuantPool``.

Precision follows the JAX package: matmuls stay in the parameter dtype,
normalisation statistics and softmax run in fp32, attention scores and
probabilities are fp32 and masked with -1e30.

The dispatchers route to ``ops.attention_cuda``: on CUDA tensors its
wrappers launch the hand-written kernels, on CPU tensors they run the
plain versions. Dense prefill attention (T > 1 queries) is the einsum
form on both devices, as in the JAX package. Where the JAX package
returns a new cache array, the port writes the given tensor in place and
says so. The JAX package's TPU pad-to-8 of tiny ragged waves is gone: the
CUDA kernel tiles queries within each row, so no sublane quantum applies.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .paged_kv import _dequantize_pages, is_quantized, pool_data

_NEG = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm with fp32 statistics, output in x.dtype."""
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * weight


def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2], fp32."""
    exponent = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim)
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, T, 1, D/2] fp32, for positions [B, T].
    Computed once per forward and reused by every layer."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * inv_freq      # [B, T, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotary embedding on x [B, T, H, D]: the pairs (x[..., :D/2],
    x[..., D/2:]) rotate (split-half, as HF Llama)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv_proj(h: torch.Tensor, lp: Dict[str, torch.Tensor], l: int,
             n_heads: int, n_kv_heads: int, head_dim: int,
             cos: torch.Tensor, sin: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q/K/V projections of layer ``l`` (stacked weights ``lp[...][l]``),
    head split and RoPE. h [B, T, dim] -> q [B, T, Hq, D], k/v [B, T, Hkv,
    D]."""
    B, T = h.shape[0], h.shape[1]
    q = torch.matmul(h, lp["wq"][l]).reshape(B, T, n_heads, head_dim)
    k = torch.matmul(h, lp["wk"][l]).reshape(B, T, n_kv_heads, head_dim)
    v = torch.matmul(h, lp["wv"][l]).reshape(B, T, n_kv_heads, head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ gate) * (x @ up) @ down."""
    g = F.silu(torch.matmul(x, w_gate))
    u = torch.matmul(x, w_up)
    return torch.matmul(g * u, w_down)


def write_kv_cache(
    cache_k: torch.Tensor,     # [B, S, Hkv, D] one layer of the slot cache
    cache_v: torch.Tensor,
    k: torch.Tensor,           # [B, T, Hkv, D]
    v: torch.Tensor,
    positions: torch.Tensor,   # [B, T] absolute positions per row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V into per-slot cache rows at absolute positions (each
    row at its own offset: continuous batching).

    - T == S (a prefill filling its whole temp cache): returns the fresh
      K/V in the cache dtype; the caches are not touched.
    - Otherwise the caches are written IN PLACE (the JAX package returns
      new arrays) and returned. T == 1 (decode) is one gather + select +
      scatter with one column per row, so no host sync; the general T a
      masked scatter. Positions outside [0, S) write nothing, as the JAX
      package's positional mask and dropping scatter.
    """
    B, S = cache_k.shape[0], cache_k.shape[1]
    T = k.shape[1]
    if T == S:
        return k.to(cache_k.dtype), v.to(cache_v.dtype)
    pos = positions.to(cache_k.device).long()
    ok = (pos >= 0) & (pos < S)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, T)
    for cache, new in ((cache_k, k), (cache_v, v)):
        if T == 1:
            col = pos.clamp(0, S - 1)
            cache[rows, col] = torch.where(ok[..., None, None],
                                           new.to(cache.dtype),
                                           cache[rows, col])
        else:
            cache[rows[ok], pos[ok]] = new[ok].to(cache.dtype)
    return cache_k, cache_v


def gqa_attention_reference(
    q: torch.Tensor,           # [B, T, Hq, D]
    cache_k: torch.Tensor,     # [B, S, Hkv, D] dense view
    cache_v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query attention over a dense cache view, causal by absolute
    position (entries at positions <= the query's are live); with a
    window, entries at or below position - window are masked. Scores and
    softmax in fp32, the probabilities rounded to the value dtype before
    the value product (the JAX package's einsum form). Returns [B, T, Hq,
    D] in q.dtype."""
    B, S = cache_k.shape[0], cache_k.shape[1]
    T, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv = cache_k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, cache_k.float())
    scores = scores / math.sqrt(D)
    qpos = q_positions.long()[:, :, None]                # [B, T, 1]
    kv_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = kv_pos <= qpos
    if window is not None:
        mask = mask & (kv_pos > qpos - window)
    scores = torch.where(mask[:, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd",
                       probs.to(cache_v.dtype).float(), cache_v.float())
    return out.reshape(q.shape).to(q.dtype)


def gqa_attention_chunked_reference(
    q: torch.Tensor,           # [B, 1, Hq, D] decode query
    cache_k: torch.Tensor,     # [B, S, Hkv, D] FROZEN prefix (dense view)
    cache_v: torch.Tensor,
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D] this chunk's K so far
    chunk_v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, 1] absolute position of the query
    step: int,                 # index of this step in the chunk
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment decode attention (the JAX package's einsum form):
    frozen cache + in-chunk buffer under one fp32 softmax. The frozen
    segment is valid strictly below the chunk's start (``q_position -
    step``), the chunk segment up to and including ``step``. Returns [B, 1,
    Hq, D] in q.dtype."""
    B, S = cache_k.shape[0], cache_k.shape[1]
    Kc = chunk_k.shape[1]
    Hq, Hkv = q.shape[2], cache_k.shape[2]
    G = Hq // Hkv
    D = q.shape[-1]
    dev = q.device

    qg = q.reshape(B, 1, Hkv, G, D).float()
    s_f = torch.einsum("btkgd,bskd->bkgts", qg, cache_k.float())
    s_c = torch.einsum("btkgd,bskd->bkgts", qg, chunk_k.float())
    scale = 1.0 / (D ** 0.5)

    qpos = q_positions.long()
    start = qpos - step                                  # [B, 1]
    kv_pos = torch.arange(S, device=dev)[None, None, :]
    valid_f = kv_pos < start[:, :, None]                 # [B, 1, S]
    if window is not None:
        valid_f = valid_f & (kv_pos > (qpos[:, :, None] - window))
    j = torch.arange(Kc, device=dev)[None, None, :]
    valid_c = (j <= step).expand(B, 1, Kc)
    if window is not None:
        valid_c = valid_c & ((start[:, :, None] + j)
                             > (qpos[:, :, None] - window))

    s_f = torch.where(valid_f[:, None, None], s_f * scale, _NEG)
    s_c = torch.where(valid_c[:, None, None], s_c * scale, _NEG)
    p = torch.softmax(torch.cat([s_f, s_c], dim=-1), dim=-1)
    p_f = p[..., :S].to(cache_v.dtype).float()
    p_c = p[..., S:].to(chunk_v.dtype).float()
    out = torch.einsum("bkgts,bskd->btkgd", p_f, cache_v.float())
    out = out + torch.einsum("bkgts,bskd->btkgd", p_c, chunk_v.float())
    return out.reshape(q.shape).to(q.dtype)


def merge_chunk_kv(
    cache_k: torch.Tensor,     # [L, B, S, Hkv, D] slot cache
    cache_v: torch.Tensor,
    chunk_k: torch.Tensor,     # [L, B, Kc, Hkv, D] the finished chunk
    chunk_v: torch.Tensor,
    start_positions: torch.Tensor,  # [B] position of chunk step 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a finished chunk's K/V into the slot cache IN PLACE, once per
    chunk: row b's entry j lands at column ``start_b + j``; columns >= S
    are dropped (the engine dispatches whole chunks and retires on
    max_seq when it reads the block, so a chunk may overshoot its lane).

    The JAX package has two numerically identical forms (a one-hot
    einsum + select, and a dropping scatter, ``merge_chunk_kv_scatter``);
    the port has one, under both names: a collision-free scatter in which
    each row writes the Kc columns of its window clamped inside the lane,
    taking the chunk entry where a column is one and its own frozen value
    elsewhere. Returns the caches."""
    L, B, S = cache_k.shape[0], cache_k.shape[1], cache_k.shape[2]
    Kc = chunk_k.shape[2]
    if Kc > S:  # entries past S never land
        chunk_k, chunk_v, Kc = chunk_k[:, :, :S], chunk_v[:, :, :S], S
    dev = cache_k.device
    st = start_positions.to(dev).long()
    lo = torch.clamp(st, min=0, max=S - Kc)                 # [B]
    cols = lo[:, None] + torch.arange(Kc, device=dev)       # [B, Kc] in lane
    src = cols - st[:, None]                                # chunk entry
    take = ((src >= 0) & (src < Kc))[None, :, :, None, None]
    idx = src.clamp(0, Kc - 1)
    rows = torch.arange(B, device=dev)[:, None]
    for cache, chunk in ((cache_k, chunk_k), (cache_v, chunk_v)):
        fresh = chunk[:, rows, idx].to(cache.dtype)         # [L, B, Kc, ...]
        cache[:, rows, cols] = torch.where(take, fresh, cache[:, rows, cols])
    return cache_k, cache_v


#: The JAX package's scatter form of the merge; the same function here.
merge_chunk_kv_scatter = merge_chunk_kv


def compose_prefix_lane(
    pool_k: torch.Tensor,      # [L, P, ps, Hkv, D] prefix page pool
    pool_v: torch.Tensor,
    prefix_table: torch.Tensor,  # [Bp, PP] int32 page ids per row
    prefix_lens: torch.Tensor,   # [Bp] int32 reused tokens per row
    sfx_k: torch.Tensor,       # [L, Bp, T, Hkv, D] suffix K (stacked)
    sfx_v: torch.Tensor,
    lane_pages: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row KV lane images for the dense prefix path: lane[b, j] is the
    reused prefix page content for j < prefix_lens[b], the suffix K/V
    placed at absolute position prefix_lens[b] + t, and zeros past the
    prompt (unreachable under the engine's write-before-read invariant).
    A gather where the JAX package uses a one-hot einsum; both are exact.
    Returns lane_k, lane_v [L, Bp, lane_pages * ps, Hkv, D] in the pool's
    dtype."""
    L, ps = pool_k.shape[0], pool_k.shape[2]
    Bp, PP = prefix_table.shape
    T = sfx_k.shape[2]
    Pt, lane_t = PP * ps, lane_pages * ps
    dev = pool_k.device
    tab = prefix_table.to(dev).long()
    j = torch.arange(lane_t, device=dev)[None, :]           # [1, lane_t]
    plen = prefix_lens.to(dev).long()[:, None]              # [Bp, 1]
    t = j - plen                                            # suffix index
    in_prefix = (j < plen)[None, :, :, None, None]
    in_sfx = ((t >= 0) & (t < T))[None, :, :, None, None]
    tidx = t.clamp(0, T - 1)
    rows = torch.arange(Bp, device=dev)[:, None]

    def lane(pool, fresh):
        pre = pool[:, tab].reshape((L, Bp, Pt) + tuple(pool.shape[3:]))
        if lane_t > Pt:
            pad = pre.new_zeros((L, Bp, lane_t - Pt) + tuple(pre.shape[3:]))
            pre = torch.cat([pre, pad], dim=2)
        else:
            pre = pre[:, :, :lane_t]
        suf = fresh[:, rows, tidx].to(pool.dtype)           # [L, Bp, lane_t]
        suf = torch.where(in_sfx, suf, torch.zeros((), dtype=pool.dtype,
                                                   device=dev))
        return torch.where(in_prefix, pre, suf)

    return lane(pool_k, sfx_k), lane(pool_v, sfx_v)


def gqa_attention_prefix(
    q: torch.Tensor,           # [B, T, Hq, D] suffix queries
    prefix_k: torch.Tensor,    # [B, Pt, Hkv, D] gathered prefix K
    prefix_v: torch.Tensor,
    suffix_k: torch.Tensor,    # [B, T, Hkv, D] this call's K
    suffix_v: torch.Tensor,
    prefix_lens: torch.Tensor,  # [B] int32 valid prefix length per row
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment prefill attention for prefix-cache reuse: row b's
    suffix token t (absolute position prefix_lens[b] + t) attends the
    reused prefix (positions < prefix_lens[b]; gather padding beyond is
    masked) plus the suffix causally, under one fp32 softmax. Plain
    PyTorch, as the JAX package computes it outside any Pallas kernel.
    Returns [B, T, Hq, D] in q.dtype."""
    B, T = q.shape[0], q.shape[1]
    Pt = prefix_k.shape[1]
    Hq, Hkv = q.shape[2], prefix_k.shape[2]
    D = q.shape[-1]
    dev = q.device

    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).float()
    s_p = torch.einsum("btkgd,bskd->bkgts", qg, prefix_k.float())
    s_s = torch.einsum("btkgd,bskd->bkgts", qg, suffix_k.float())
    scale = 1.0 / (D ** 0.5)

    plen = prefix_lens.to(dev).long()[:, None, None]        # [B, 1, 1]
    ar = torch.arange(T, device=dev)
    kv_pos = torch.arange(Pt, device=dev)[None, None, :]
    valid_p = (kv_pos < plen).expand(B, T, Pt)
    j = ar[None, None, :]
    valid_s = (j <= ar[None, :, None]).expand(B, T, T)      # causal
    if window is not None:
        lo = plen + ar[None, :, None] - window              # [B, T, 1]
        valid_p = valid_p & (kv_pos > lo)
        valid_s = valid_s & ((plen + j) > lo)
    s_p = torch.where(valid_p[:, None, None], s_p * scale, _NEG)
    s_s = torch.where(valid_s[:, None, None], s_s * scale, _NEG)
    p = torch.softmax(torch.cat([s_p, s_s], dim=-1), dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd",
                       p[..., :Pt].to(prefix_v.dtype).float(),
                       prefix_v.float())
    out = out + torch.einsum("bkgts,bskd->btkgd",
                             p[..., Pt:].to(suffix_v.dtype).float(),
                             suffix_v.float())
    return out.reshape(q.shape).to(q.dtype)


def ragged_prefill_attention_reference(
    q: torch.Tensor,           # [W, Hq, D] packed query stream
    sfx_k: torch.Tensor,       # [W, Hkv, D] packed suffix K
    sfx_v: torch.Tensor,
    k_pages: Any,              # [P, ps, Hkv, D] single layer, either kind
    v_pages: Any,
    row_tables: torch.Tensor,  # [R, maxp] int32
    starts: torch.Tensor,      # [R] stream offset per row
    lens: torch.Tensor,        # [R] suffix length per row (0 = dead)
    prefix_lens: torch.Tensor,  # [R] tokens already in the pages
    tok_row: torch.Tensor,     # [W] owning row per token (>= R = pad)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dense reference for ragged paged prefill (port of the JAX
    package's ``ragged_prefill_attention_reference``). Every packed token
    attends its own row's prefix pages (gathered dense, positions
    ``0..prefix_lens[r]``) plus the row's suffix tokens causally; one fp32
    softmax spans both segments. A quantized pool is dequantized to f32
    after the table gather. Padding tokens (row id >= R) produce garbage
    the caller discards. Returns [W, Hq, D]."""
    W, Hq, D = q.shape
    Hkv = sfx_k.shape[1]
    G = Hq // Hkv
    R, maxp = row_tables.shape
    ps = pool_data(k_pages).shape[1]
    Pt = maxp * ps
    dev = q.device

    tok_row = tok_row.long()
    starts = starts.long()
    prefix_lens = prefix_lens.long()
    row = torch.clamp(tok_row, 0, R - 1)
    tables = row_tables.long()
    if is_quantized(k_pages):
        kp = _dequantize_pages(k_pages.data[tables], k_pages.scale[tables])
        vp = _dequantize_pages(v_pages.data[tables], v_pages.scale[tables])
    else:
        kp, vp = k_pages[tables], v_pages[tables]
    kp = kp.reshape(R, Pt, Hkv, D)
    vp = vp.reshape(R, Pt, Hkv, D)
    kp_t = kp[row].float()                               # [W, Pt, Hkv, D]
    vp_t = vp[row]

    qg = q.reshape(W, Hkv, G, D).float()
    s_p = torch.einsum("wkgd,wpkd->wkgp", qg, kp_t)
    s_s = torch.einsum("wkgd,xkd->wkgx", qg, sfx_k.float())
    scale = 1.0 / (D ** 0.5)

    x = torch.arange(W, device=dev)
    q_abs = prefix_lens[row] + x - starts[row]           # [W]
    p_pos = torch.arange(Pt, device=dev)
    valid_p = p_pos[None, :] < prefix_lens[row][:, None]  # [W, Pt]
    if window is not None:
        valid_p = valid_p & (p_pos[None, :] > (q_abs[:, None] - window))
    same = tok_row[:, None] == tok_row[None, :]          # [W, W]
    valid_s = same & (x[None, :] <= x[:, None])          # packed causal
    if window is not None:
        valid_s = valid_s & (x[None, :] > (x[:, None] - window))

    s_p = torch.where(valid_p[:, None, None, :], s_p * scale, _NEG)
    s_s = torch.where(valid_s[:, None, None, :], s_s * scale, _NEG)
    p = torch.softmax(torch.cat([s_p, s_s], dim=-1), dim=-1)
    out = torch.einsum("wkgp,wpkd->wkgd",
                       p[..., :Pt].to(vp_t.dtype).float(), vp_t.float())
    out = out + torch.einsum("wkgx,xkd->wkgd",
                             p[..., Pt:].to(sfx_v.dtype).float(),
                             sfx_v.float())
    return out.reshape(W, Hq, D).to(q.dtype)


def gqa_attention(
    q: torch.Tensor,           # [B, T, Hq, D]
    cache_k: torch.Tensor,     # [B, S, Hkv, D] one layer of the slot cache
    cache_v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query attention over the dense slot cache, causal by
    absolute position; the cache already holds this call's K/V. A decode
    step (T == 1) goes to the dense single-step decode kernel (each slot
    attends its positions < q_position + 1) on CUDA, its plain version on
    CPU; a prefill (T > 1) is the einsum form on both devices, as in the
    JAX package. Returns [B, T, Hq, D] in q.dtype."""
    if q.shape[1] != 1:
        return gqa_attention_reference(q, cache_k, cache_v, q_positions,
                                       window=window)
    from .attention_cuda import decode_gqa_attention

    lengths = (q_positions[:, 0] + 1).to(torch.int32)
    out = decode_gqa_attention(q[:, 0].contiguous(), cache_k, cache_v,
                               lengths, window=window)
    return out[:, None]


def gqa_attention_chunked(
    q: torch.Tensor,           # [B, 1, Hq, D] decode query
    cache_k: torch.Tensor,     # [B, S, Hkv, D] FROZEN slot cache layer
    cache_v: torch.Tensor,
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D] this chunk's K so far
    chunk_v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, 1] absolute position of the query
    step: int,                 # index of this step in the chunk
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment decode attention over the dense slot cache + chunk
    buffer: the dense two-segment decode kernel on CUDA, its plain version
    (``gqa_attention_chunked_reference``) on CPU. The frozen segment ends
    at the chunk's start (``q_position - step``). Returns [B, 1, Hq, D]."""
    from .attention_cuda import decode_gqa_attention_chunked

    starts = (q_positions[:, 0] - step).to(torch.int32)
    out = decode_gqa_attention_chunked(q[:, 0].contiguous(), cache_k,
                                       cache_v, chunk_k, chunk_v, starts,
                                       step, window=window)
    return out[:, None]


_SMEM_CODES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}
# estimates computed while this thread captured a CUDA graph, recorded by
# flush_static_smem once the capture is over
_smem_deferred = threading.local()


def _record_static_smem(kernel: str, key: str, q: torch.Tensor,
                        pages: Any, **dtypes: torch.Tensor) -> None:
    """Fold a CUDA kernel's shared memory per block at this launch's dims
    (``analysis.kernelcheck.estimate_smem``, against the device's opt-in
    limit) into the device-time profiler under ``key``, as the JAX
    package's ``_record_static_vmem`` folds its VMEM estimate. On the card
    only, with the profiler on, at a key's first dispatch; a dispatch
    inside a graph capture defers the record to ``flush_static_smem``
    after it. ``q`` is the query ([.., Hq, D]), ``pages`` the pool or
    dense cache, ``dtypes`` the other operands by role (``chunk``,
    ``suffix``). Accounting never raises into the dispatch."""
    if q.device.type != "cuda":
        return
    from ..obs.profiler import profiler

    prof = profiler()
    if not prof.enabled or prof.has_vmem_estimate(key):
        return
    try:
        from ..analysis.kernelcheck import estimate_smem, smem_budget

        kd = pool_data(pages)
        props = torch.cuda.get_device_properties(q.device)
        dims = {"Hq": q.shape[-2], "Hkv": kd.shape[-2], "D": q.shape[-1],
                "page": _SMEM_CODES[kd.dtype], "q": _SMEM_CODES[q.dtype],
                "W": q.shape[0], "sms": props.multi_processor_count}
        dims.update({role: _SMEM_CODES[t.dtype] for role, t in
                     dtypes.items()})
        est = estimate_smem(kernel, dims)
        if est is None:
            return
        rec = (key, est, smem_budget(device=q.device))
    except (KeyError, RuntimeError):
        # a dtype no kernel takes (its wrapper raises below), or a device
        # query that failed: accounting never breaks the dispatch
        return
    if torch.cuda.is_current_stream_capturing():
        pending = getattr(_smem_deferred, "items", None)
        if pending is None:
            pending = _smem_deferred.items = []
        pending.append(rec)
        return
    prof.record_vmem_estimate(*rec)


def flush_static_smem() -> None:
    """Record the estimates this thread's last graph capture deferred
    (``backend.decode_graphs.ChunkRunner.capture`` calls it after the
    capture)."""
    pending = getattr(_smem_deferred, "items", None)
    if not pending:
        return
    from ..obs.profiler import profiler

    prof = profiler()
    for rec in pending:
        prof.record_vmem_estimate(*rec)
    pending.clear()


def paged_attention_dispatch(
    q: torch.Tensor,           # [B, 1, Hq, D] decode query
    k_pages: Any,              # [P, ps, Hkv, D] single layer, either kind
    v_pages: Any,
    page_table: torch.Tensor,  # [B, maxp] int32
    q_positions: torch.Tensor,  # [B, 1] position of the query
    *,
    window: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-step decode attention over the paged pool, whose pages
    already hold this step's token: each slot attends its positions
    ``< q_position + 1``. The single-step decode kernels on CUDA (the
    int8 one for a ``QuantPool``), their plain versions (page gather +
    ``gqa_attention_reference``) on CPU. ``out`` ([B, Hq, D]), when
    given, is the buffer the kernel writes (the kernel sanitizer's
    canary-filled one). Returns [B, 1, Hq, D]."""
    from .attention_cuda import (paged_decode_gqa_attention,
                                 paged_decode_gqa_attention_quant)

    lengths = (q_positions[:, 0] + 1).to(torch.int32)
    quant = is_quantized(k_pages)
    kernel = "paged_decode_quant" if quant else "paged_decode"
    _record_static_smem(kernel, f"kernel:{kernel}", q[:, 0], k_pages)
    if quant:
        res = paged_decode_gqa_attention_quant(
            q[:, 0], k_pages.data, k_pages.scale, v_pages.data,
            v_pages.scale, page_table, lengths, window=window, out=out)
    else:
        res = paged_decode_gqa_attention(q[:, 0], k_pages, v_pages,
                                         page_table, lengths, window=window,
                                         out=out)
    return res[:, None]


def paged_attention_dispatch_chunked(
    q: torch.Tensor,           # [B, 1, Hq, D] decode query
    k_pages: Any,              # [P, ps, Hkv, D] single layer (FROZEN)
    v_pages: Any,
    page_table: torch.Tensor,  # [B, maxp] int32
    chunk_k: torch.Tensor,     # [B, Kc, Hkv, D]
    chunk_v: torch.Tensor,
    starts: torch.Tensor,      # [B] int32 chunk start (= position - step)
    step: int,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Two-segment decode attention over the paged pool + chunk buffer:
    the paged-decode kernels on CUDA (the int8 one for a ``QuantPool``),
    their plain version (page gather + ``gqa_attention_chunked_reference``)
    on CPU.
    Returns [B, 1, Hq, D]."""
    from .attention_cuda import (paged_decode_gqa_attention_chunked,
                                 paged_decode_gqa_attention_chunked_quant)

    quant = is_quantized(k_pages)
    kernel = "paged_decode_chunked_quant" if quant else "paged_decode_chunked"
    _record_static_smem(kernel, f"kernel:{kernel}", q[:, 0], k_pages,
                        chunk=chunk_k)
    if quant:
        out = paged_decode_gqa_attention_chunked_quant(
            q[:, 0], k_pages.data, k_pages.scale, v_pages.data,
            v_pages.scale, page_table, chunk_k, chunk_v, starts, step,
            window=window)
    else:
        out = paged_decode_gqa_attention_chunked(
            q[:, 0], k_pages, v_pages, page_table, chunk_k, chunk_v, starts,
            step, window=window)
    return out[:, None]


def ragged_prefill_dispatch(
    q: torch.Tensor,           # [W, Hq, D] packed query stream
    sfx_k: torch.Tensor,       # [W, Hkv, D]
    sfx_v: torch.Tensor,
    k_pages: Any,              # [P, ps, Hkv, D] single layer, either kind
    v_pages: Any,
    row_tables: torch.Tensor,  # [R, maxp] int32
    starts: torch.Tensor,      # [R] int32
    lens: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    window: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged prefill attention over the paged pool: the ragged
    prefill kernels on CUDA (prefix pages read in place; the int8 one for
    a ``QuantPool``), their plain version on CPU. Returns [W, Hq, D];
    positions no row owns are zero, or keep what ``out`` (the buffer the
    kernel writes, when given) held there."""
    from .attention_cuda import (ragged_paged_prefill_attention,
                                 ragged_paged_prefill_attention_quant)

    quant = is_quantized(k_pages)
    _record_static_smem(
        "ragged_prefill_quant" if quant else "ragged_prefill",
        f"prefill.ragged[w{q.shape[0]}]", q, k_pages, suffix=sfx_k)
    if quant:
        return ragged_paged_prefill_attention_quant(
            q, sfx_k, sfx_v, k_pages.data, k_pages.scale, v_pages.data,
            v_pages.scale, row_tables, starts, lens, prefix_lens,
            window=window, out=out)
    return ragged_paged_prefill_attention(
        q, sfx_k, sfx_v, k_pages, v_pages, row_tables, starts, lens,
        prefix_lens, window=window, out=out)


def kerncheck_enabled() -> bool:
    """The kernel sanitizer's flag (``SWARMDB_KERNCHECK``,
    :mod:`swarmdb_tpu_torch.obs.kerncheck`)."""
    return os.environ.get("SWARMDB_KERNCHECK", "0") not in ("", "0")


def attention_dispatchers() -> Tuple[Optional[Callable],
                                     Optional[Callable]]:
    """The (ragged prefill, single-step paged decode) dispatchers an
    engine's forwards call, picked when the engine is built: under
    ``SWARMDB_KERNCHECK=1`` the kernel sanitizer's checked wrappers
    (descriptor audit, output canary, parity against the plain version on
    every eager call); otherwise None, None: the forwards call the plain
    dispatchers themselves."""
    if not kerncheck_enabled():
        return None, None
    from ..obs import kerncheck

    return (kerncheck.checked_ragged_prefill_dispatch(
                ragged_prefill_dispatch),
            kerncheck.checked_paged_attention_dispatch(
                paged_attention_dispatch))
