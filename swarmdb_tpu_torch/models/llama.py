"""Llama-3 model family on the serving paths, in PyTorch.

The counterpart of ``swarmdb_tpu/models/llama.py`` for the functions the
single-lane engines run: parameter init; for the paged engine the pool
(plain or int8), the packed ragged prefill forward, the two-segment
chunked decode forward with its once-per-chunk page merge and the
single-step paged decode forward (``SWARMDB_CHUNKED=0``); for the dense
engine the ``[L, B, S, Hkv, D]`` slot cache, the bucketed ``forward``
(prefill, and single-step decode), the prefix-cache suffix forwards over a
side page pool (``forward_prefix_pages`` / ``forward_prefix_lane``) and
the chunked decode ``forward_chunked`` with its once-per-chunk merge.

Parameters are a plain dict with the JAX package's keys and layouts:
per-layer weights stacked ``[L, ...]``, projections stored ``[in, out]``
(``x @ w``). The JAX package's ``lax.scan`` over layers is a Python loop
over ``L`` that indexes the stacked tensors. The pool is read through its
per-layer view ``pool_layer(pool, l)`` (``[P, ps, Hkv, D]``, contiguous,
with its ``[P, Hkv]`` scales for an int8 pool), so the page tables need no
per-layer offset.

Matmuls run in the parameter dtype; normalisation, RoPE and attention
softmax run in fp32; logits are fp32 (bf16 products summed in fp32, as the
JAX package's ``preferred_element_type=float32``). The attention query and
the chunk buffer enter the attention in their own dtype, whatever the
pool's: the kernels read each operand in its own type and compute in fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.layers import (
    compose_prefix_lane,
    gqa_attention,
    gqa_attention_chunked,
    gqa_attention_prefix,
    merge_chunk_kv,
    paged_attention_dispatch,
    paged_attention_dispatch_chunked,
    qkv_proj,
    ragged_prefill_dispatch,
    rms_norm,
    rope_cos_sin,
    swiglu,
    write_kv_cache,
)
from ..ops.paged_kv import (init_paged_kv_cache, paged_gather_kv,
                            paged_write_chunk, paged_write_decode, pool_data,
                            pool_dtype, pool_layer)
from ..utils.device import DeviceLike, resolve_device
from .configs import ModelConfig

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------- init


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random init from ``seed`` with a ``torch.Generator`` on the target
    device: normal / sqrt(fan_in), norms at one. Same shapes and keys as
    the JAX package (its values differ: the two frameworks' generators
    differ; tests carry JAX weights over with ``utils.convert``). Stacked
    weights are filled one layer at a time, so the fp32 draw never needs
    more than one layer of scratch."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE config; Mixtral is not ported yet "
            "(ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape, fan_in, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=dev)
        scale = 1.0 / (fan_in ** 0.5)
        for part in (out if stacked else [out]):
            draw = torch.randn(part.shape, generator=gen, device=dev,
                               dtype=torch.float32)
            part.copy_(draw.mul_(scale))
        return out

    params: Params = {
        "embed": dense((cfg.vocab_size, D), D, stacked=False),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=dtype, device=dev),
            "wq": dense((L, D, Hq * hd), D),
            "wk": dense((L, D, Hkv * hd), D),
            "wv": dense((L, D, Hkv * hd), D),
            "wo": dense((L, Hq * hd, D), Hq * hd),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=dev),
            "w_gate": dense((L, D, F), D),
            "w_up": dense((L, D, F), D),
            "w_down": dense((L, F, D), F),
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size), D, stacked=False)
    return params


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None) -> KVCache:
    """The dense engine's slot cache: zeros (k, v), each [L, batch,
    max_seq, Hkv, D], bf16 by default as in the JAX package."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_prefix_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> KVCache:
    """The dense engine's side page pool for the prefix cache: zeros (k,
    v), each [L, num_pages, page_size, Hkv, D] (page 0 = trash)."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     num_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Block-paged KV pool {"k", "v", "page_table"} (ops/paged_kv.py);
    ``dtype=None`` resolves SWARMDB_KV_DTYPE (bf16 default);
    ``torch.int8`` gives ``QuantPool`` entries."""
    return init_paged_kv_cache(
        cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
        batch, max_seq, dtype, resolve_device(device))


def init_chunk_kv(cfg: ModelConfig, batch: int, chunk: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk K/V buffer of the two-segment decode: zeros
    [L, B, Kc, Hkv, D] each, bf16 by default as in the JAX package (an f32
    pool then sees this chunk's K/V rounded to bf16 until the merge)."""
    shape = (cfg.n_layers, batch, chunk, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


# ------------------------------------------------------------------- forward


_MM_OUT_DTYPE: Dict[torch.device, bool] = {}


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits of ``x @ head``. bf16 operands are multiplied exactly
    and summed in fp32: ``torch.mm(..., out_dtype=float32)`` where the
    installed PyTorch has it for the device, else an fp32 product of the
    widened operands (the same sums, one widened copy of the head)."""
    if x.dtype == torch.float32 and head.dtype == torch.float32:
        return torch.matmul(x, head)
    if _MM_OUT_DTYPE.get(x.device, True):
        try:
            out = torch.mm(x, head, out_dtype=torch.float32)
            _MM_OUT_DTYPE[x.device] = True
            return out
        except (TypeError, RuntimeError, NotImplementedError):
            _MM_OUT_DTYPE[x.device] = False
    return torch.matmul(x.float(), head.float())


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward_ragged_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [W] packed token stream (rows concatenated)
    tok_row: torch.Tensor,     # [W] owning wave row (>= R = padding)
    tok_pos: torch.Tensor,     # [W] absolute position within the row
    row_tables: torch.Tensor,  # [R, maxp] int32 page ids per row
    starts: torch.Tensor,      # [R] int32 row offset in the stream
    lens: torch.Tensor,        # [R] int32 row token count (0 = dead row)
    prefix_lens: torch.Tensor,  # [R] int32 tokens already in the row's pages
    pool_k: Any,               # [L, P, ps, Hkv, D] main page pool, or int8
    pool_v: Any,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed ragged prefill forward: one token stream per admission wave,
    each token attending its own row's prefix pages in place plus the
    row's suffix causally (``layers.ragged_prefill_dispatch``). Returns
    (fp32 logits [R, V] at each row's last live token, sfx_k, sfx_v
    [L, W, Hkv, D] in the pool's logical dtype, stream order, for
    ``paged_kv.paged_write_ragged``). The pool is only read."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    W = tokens.shape[0]
    L = pool_data(pool_k).shape[0]
    kdt, vdt = pool_dtype(pool_k), pool_dtype(pool_v)
    x = params["embed"][tokens.long()][None]             # [1, W, dim]
    cos, sin = rope_cos_sin(tok_pos[None], cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    sfx_k, sfx_v = [], []
    for l in range(L):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        # suffix K/V in the pool's logical dtype BEFORE attention: what
        # this wave attends equals what later waves and decodes read back
        # (up to quantization, for an int8 pool)
        ks = k[0].to(kdt).contiguous()
        vs = v[0].to(vdt).contiguous()
        attn = ragged_prefill_dispatch(
            q[0].contiguous(), ks, vs, pool_layer(pool_k, l),
            pool_layer(pool_v, l), row_tables, starts, lens, prefix_lens,
            window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(W, -1), lp["wo"][l])[None]
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
        sfx_k.append(ks)
        sfx_v.append(vs)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last_w = starts.long() + torch.clamp(lens.long() - 1, min=0)  # dead -> 0
    logits = _logits(x[0, last_w], _head(params))
    return logits, torch.stack(sfx_k), torch.stack(sfx_v)


def forward_paged_chunked(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, 1]
    positions: torch.Tensor,   # [B, 1]
    cache: Dict[str, Any],     # {"k","v","page_table"}: FROZEN
    chunk_kv: Tuple[torch.Tensor, torch.Tensor],  # [L, B, Kc, Hkv, D]
    step: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step of the two-segment chunked decode: the pool stays
    frozen for the chunk's K steps, this step's K/V lands in the chunk
    buffer at index ``step`` (written in place), and attention spans the
    live pages + the chunk buffer under one softmax
    (``layers.paged_attention_dispatch_chunked``). Returns (fp32 logits
    [B, 1, V], chunk_kv)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    x = params["embed"][tokens.long()]                   # [B, 1, dim]
    B = x.shape[0]
    table = cache["page_table"]
    hk, hv = chunk_kv
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    starts = (positions[:, 0] - step).to(torch.int32)
    lp = params["layers"]
    for l in range(pool_data(cache["k"]).shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        hk[l][:, step] = k[:, 0].to(hk.dtype)
        hv[l][:, step] = v[:, 0].to(hv.dtype)
        attn = paged_attention_dispatch_chunked(
            q.contiguous(), pool_layer(cache["k"], l),
            pool_layer(cache["v"], l), table, hk[l], hv[l], starts, step,
            window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(B, 1, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, 0], _head(params))[:, None]
    return logits, (hk, hv)


def forward_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, 1] one decode step
    positions: torch.Tensor,   # [B, 1] absolute position per slot
    cache: Dict[str, Any],     # {"k","v","page_table"}: written in place
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-step paged decode forward (``SWARMDB_CHUNKED=0``): in every
    layer the step's K/V is written into its page first
    (``paged_kv.paged_write_decode``; a requant window for an int8 pool),
    then each slot attends its pages up to and including its position
    (``layers.paged_attention_dispatch``). Returns (fp32 logits [B, 1, V],
    the cache)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    x = params["embed"][tokens.long()]                   # [B, 1, dim]
    B = x.shape[0]
    table = cache["page_table"]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    for l in range(pool_data(cache["k"]).shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        kp, vp = pool_layer(cache["k"], l), pool_layer(cache["v"], l)
        paged_write_decode(kp, vp, k, v, positions, table)
        attn = paged_attention_dispatch(q.contiguous(), kp, vp, table,
                                        positions, window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(B, 1, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, 0], _head(params))[:, None]
    return logits, cache


def merge_paged_chunk(cache: Dict[str, Any],
                      chunk_kv: Tuple[torch.Tensor, torch.Tensor],
                      start_positions: torch.Tensor) -> Dict[str, Any]:
    """Fold a finished chunk's K/V into the page pool, in place: one bulk
    write per chunk (``paged_kv.paged_write_chunk``)."""
    hk, hv = chunk_kv
    paged_write_chunk(cache["k"], cache["v"], hk, hv, start_positions,
                      cache["page_table"])
    return cache


# -------------------------------------------------------------- dense engine


def _final_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  logits_at: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 logits [B, T, V] of the final hidden states, or [B, V] at each
    row's ``logits_at`` index (the LM head only where it is sampled)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        return _logits(x[rows, logits_at.long()], _head(params))
    B, T = x.shape[0], x.shape[1]
    return _logits(x.reshape(B * T, -1), _head(params)).reshape(B, T, -1)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, T]
    positions: torch.Tensor,   # [B, T] absolute positions per row
    cache: KVCache,            # ([L, B, S, Hkv, D], ...): written in place
    logits_at: Optional[torch.Tensor] = None,  # [B] row indices into T
) -> Tuple[torch.Tensor, KVCache]:
    """One forward pass over the dense slot cache, for mixed prefill and
    decode rows: each row's positions are its own absolute offsets and
    attention masks by position (``layers.gqa_attention``; a decode step,
    T == 1, goes to the dense single-step decode kernel). Every layer's
    K/V go into the cache first, in place (with T == S, a prefill over
    its whole temp cache, the cache simply takes them). Returns (fp32
    logits [B, T, V], or [B, V] at each row's ``logits_at`` index, the
    cache)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    ck, cv = cache
    B, T = tokens.shape
    full = T == ck.shape[2]
    x = params["embed"][tokens.long()]                   # [B, T, dim]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    for l in range(ck.shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        kl, vl = write_kv_cache(ck[l], cv[l], k, v, positions)
        if full:  # the write handed back the fresh K/V: keep them
            ck[l].copy_(kl)
            cv[l].copy_(vl)
        attn = gqa_attention(q, kl, vl, positions, window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(B, T, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
    return _final_logits(params, cfg, x, logits_at), cache


def forward_chunked(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, 1] one decode step
    positions: torch.Tensor,   # [B, 1] absolute positions
    cache: KVCache,            # FROZEN during the chunk
    chunk_kv: Tuple[torch.Tensor, torch.Tensor],  # [L, B, Kc, Hkv, D]
    step: int,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step of the dense engine's chunked decode: the slot
    cache stays frozen for the chunk's K steps, this step's K/V goes into
    the chunk buffer at index ``step`` (in place), and attention spans
    each slot's lane below its chunk start plus the chunk buffer under
    one softmax (``layers.gqa_attention_chunked``, the dense two-segment
    kernel on the card). Returns (fp32 logits [B, 1, V], chunk_kv)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    ck, cv = cache
    hk, hv = chunk_kv
    x = params["embed"][tokens.long()]                   # [B, 1, dim]
    B = x.shape[0]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    for l in range(ck.shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        hk[l][:, step] = k[:, 0].to(hk.dtype)
        hv[l][:, step] = v[:, 0].to(hv.dtype)
        attn = gqa_attention_chunked(q, ck[l], cv[l], hk[l], hv[l],
                                     positions, step,
                                     window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(B, 1, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, 0], _head(params))[:, None]
    return logits, (hk, hv)


def merge_chunk(cache: KVCache, chunk_kv: Tuple[torch.Tensor, torch.Tensor],
                start_positions: torch.Tensor) -> KVCache:
    """Fold a finished chunk's K/V into the slot cache, in place, once per
    chunk (``layers.merge_chunk_kv``; columns past the lane dropped)."""
    ck, cv = cache
    hk, hv = chunk_kv
    merge_chunk_kv(ck, cv, hk, hv, start_positions)
    return cache


#: The JAX package's scatter-form merge, numerically identical to its
#: einsum form; the port has one merge under both names.
merge_chunk_scatter = merge_chunk


def forward_prefix_pages(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [Bp, T] suffix tokens (padded)
    prefix_table: torch.Tensor,  # [Bp, PP] int32 prefix-pool page ids
    prefix_lens: torch.Tensor,   # [Bp] int32 reused prefix length (tokens)
    pool_k: Any,                 # [L, P, ps, Hkv, D] page pool, or int8
    pool_v: Any,
    logits_at: Optional[torch.Tensor] = None,  # [Bp] row indices into T
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix-cache suffix prefill core: compute only the suffix tokens,
    each row attending its reused prefix pages (gathered per layer;
    dequantized for an int8 pool) plus the suffix causally
    (``layers.gqa_attention_prefix``). The pool is only read. Returns
    (fp32 logits [Bp, T, V], or [Bp, V] with ``logits_at``, sfx_k, sfx_v
    [L, Bp, T, Hkv, D] in the gathered pages' dtype)."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name!r} is MoE; not ported yet")
    Bp, T = tokens.shape
    L = pool_data(pool_k).shape[0]
    x = params["embed"][tokens.long()]
    positions = (prefix_lens.long()[:, None]
                 + torch.arange(T, device=x.device)[None])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    sfx_k, sfx_v = [], []
    for l in range(L):
        kp, vp = paged_gather_kv(pool_layer(pool_k, l), pool_layer(pool_v, l),
                                 prefix_table)
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        ks, vs = k.to(kp.dtype), v.to(vp.dtype)
        attn = gqa_attention_prefix(q, kp, vp, ks, vs, prefix_lens,
                                    window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(Bp, T, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu(h2, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])
        sfx_k.append(ks)
        sfx_v.append(vs)
    logits = _final_logits(params, cfg, x, logits_at)
    return logits, torch.stack(sfx_k), torch.stack(sfx_v)


def forward_prefix_lane(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [Bp, T] suffix tokens (padded)
    prefix_table: torch.Tensor,  # [Bp, PP] int32 prefix-pool page ids
    prefix_lens: torch.Tensor,   # [Bp] int32 reused prefix length (tokens)
    pool_k: torch.Tensor,        # [L, P, ps, Hkv, D] side page pool
    pool_v: torch.Tensor,
    lane_pages: int,             # output lane length in pages
    logits_at: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-cache prefix prefill: ``forward_prefix_pages`` plus each
    row's lane image (``layers.compose_prefix_lane``: prefix pages, then
    the suffix at its positions), ready for one slot-cache insert.
    Returns (fp32 logits, lane_k, lane_v [L, Bp, lane_pages * ps, Hkv,
    D])."""
    logits, sfx_k, sfx_v = forward_prefix_pages(
        params, cfg, tokens, prefix_table, prefix_lens, pool_k, pool_v,
        logits_at=logits_at)
    lane_k, lane_v = compose_prefix_lane(pool_k, pool_v, prefix_table,
                                         prefix_lens, sfx_k, sfx_v,
                                         lane_pages)
    return logits, lane_k, lane_v
