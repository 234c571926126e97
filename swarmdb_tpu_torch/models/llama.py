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
The paged engine's row-bucketed prefill (``SWARMDB_RAGGED_PREFILL=0``, or
a model without a ragged forward) runs ``forward`` over a temp cache and
its paged prefix prefill ``forward_prefix_pages`` over the main pool.

The dense engine's forwards (``forward``, ``forward_chunked``; the merge
needs nothing) also run tensor-parallel: with ``tp`` (a
``parallel.collectives.Axis``) on one rank's share of the weights
(``param_plan``) and of the slot cache (``cache_plan``), meeting the other
ranks in the collectives of the section comment above ``_heads``.

Every forward but the ragged one takes the layer's feed-forward as
``ffn`` (SwiGLU by default): ``models.mixtral`` runs these same layer
bodies with its routed MoE block, as the JAX package's Mixtral forwards
repeat Llama's around theirs.

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

from typing import Any, Callable, Dict, Optional, Tuple

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
                dtype: torch.dtype = torch.bfloat16,
                keep: Optional[Callable[[str, torch.Tensor],
                                        torch.Tensor]] = None) -> Params:
    """Random init from ``seed`` with a ``torch.Generator`` on the target
    device: normal / sqrt(fan_in), norms at one. Same shapes and keys as
    the JAX package (its values differ: the two frameworks' generators
    differ; tests carry JAX weights over with ``utils.convert``). Stacked
    weights are filled one layer at a time, so the fp32 draw never needs
    more than one layer of scratch.

    ``keep(key, tensor)`` (a dotted key, ``"layers.wq"``) is applied to
    each leaf as soon as it is drawn, and its result is kept: a tensor-
    parallel rank keeps its slice (``parallel.mesh.shard_leaf``), so the
    peak is one whole leaf, and every rank draws the very weights a single
    process draws."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE config: use models.mixtral")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kept = keep or (lambda _key, t: t)

    def dense(key, shape, fan_in, stacked=True):
        return kept(key, random_weight(gen, shape, fan_in, dtype, dev,
                                       stacked))

    def ones(key, shape):
        return kept(key, torch.ones(shape, dtype=dtype, device=dev))

    # drawn in this order whatever ``keep`` does: the generator's stream
    # is the same in every process
    params: Params = {
        "embed": dense("embed", (cfg.vocab_size, D), D, stacked=False),
        "layers": {
            "attn_norm": ones("layers.attn_norm", (L, D)),
            "wq": dense("layers.wq", (L, D, Hq * hd), D),
            "wk": dense("layers.wk", (L, D, Hkv * hd), D),
            "wv": dense("layers.wv", (L, D, Hkv * hd), D),
            "wo": dense("layers.wo", (L, Hq * hd, D), Hq * hd),
            "mlp_norm": ones("layers.mlp_norm", (L, D)),
            "w_gate": dense("layers.w_gate", (L, D, F), D),
            "w_up": dense("layers.w_up", (L, D, F), D),
            "w_down": dense("layers.w_down", (L, F, D), F),
        },
        "final_norm": ones("final_norm", (D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (D, cfg.vocab_size), D,
                                  stacked=False)
    return params


def param_plan(cfg: ModelConfig, model_axis: str = "model") -> Params:
    """The shard plan for tensor parallelism over ``model_axis`` (the
    counterpart of the JAX package's ``param_specs``): each leaf's
    (dim, axis), or None (held whole). Megatron-style: Q/K/V, gate and up
    split their output features (columns), O and down their input
    features (rows), so each block needs one sum over the axis; the
    embedding and the head split the vocab."""
    m = model_axis
    plan: Params = {
        "embed": (0, m),
        "layers": {
            "attn_norm": None,
            "wq": (2, m),
            "wk": (2, m),
            "wv": (2, m),
            "wo": (1, m),
            "mlp_norm": None,
            "w_gate": (2, m),
            "w_up": (2, m),
            "w_down": (1, m),
        },
        "final_norm": None,
    }
    if not cfg.tie_embeddings:
        plan["lm_head"] = (1, m)
    return plan


def cache_plan(model_axis: str = "model",
               data_axis: Optional[str] = None) -> Tuple[Any, Any]:
    """The dense slot cache's plan (and the chunk buffer's: both are
    [L, B, S, Hkv, D]): K and V split their KV heads over ``model_axis``,
    and with ``data_axis`` their slots over it too, each leaf then
    ``((1, data_axis), (3, model_axis))``: the JAX package's
    ``cache_specs``. A data rank's engine builds its block of slots
    itself (``Engine(data_axis=)``); a paged pool splits its pages the
    same way (``ops.paged_kv.ShardedPageAllocator``)."""
    leaf = (3, model_axis)
    if data_axis is not None:
        leaf = ((1, data_axis), leaf)
    return leaf, leaf


def random_weight(gen: torch.Generator, shape: Tuple[int, ...],
                  fan_in: int, dtype: torch.dtype, device: torch.device,
                  stacked: bool = True) -> torch.Tensor:
    """normal(0, 1) / sqrt(fan_in) in ``dtype`` on ``device``, drawn from
    ``gen`` in fp32 one trailing matrix at a time when ``stacked`` (a
    [L, E, D, F] expert stack draws L * E matrices of [D, F]), so the fp32
    scratch is one matrix, never the whole stack."""
    out = torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / (fan_in ** 0.5)
    parts = out.view(-1, *shape[-2:]) if stacked else [out]
    for part in parts:
        draw = torch.randn(part.shape, generator=gen, device=device,
                           dtype=torch.float32)
        part.copy_(draw.mul_(scale))
    return out


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None,
                  kv_heads: Optional[int] = None) -> KVCache:
    """The dense engine's slot cache: zeros (k, v), each [L, batch,
    max_seq, Hkv, D], bf16 by default as in the JAX package. ``kv_heads``
    (default the config's) is a tensor-parallel rank's share."""
    shape = (cfg.n_layers, batch, max_seq, kv_heads or cfg.n_kv_heads,
             cfg.head_dim)
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
                  device: DeviceLike = None,
                  kv_heads: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk K/V buffer of the two-segment decode: zeros
    [L, B, Kc, Hkv, D] each, bf16 by default as in the JAX package (an f32
    pool then sees this chunk's K/V rounded to bf16 until the merge).
    ``kv_heads`` as in ``init_kv_cache``."""
    shape = (cfg.n_layers, batch, chunk, kv_heads or cfg.n_kv_heads,
             cfg.head_dim)
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


#: A layer's feed-forward: (normed hidden [B, T, dim], stacked layer
#: weights, layer index) -> [B, T, dim]. The forwards below take one as
#: ``ffn``: SwiGLU by default, the routed MoE block from models.mixtral.
FFN = Callable[[torch.Tensor, Dict[str, torch.Tensor], int], torch.Tensor]


def swiglu_ffn(h: torch.Tensor, lp: Dict[str, torch.Tensor], l: int
               ) -> torch.Tensor:
    """Layer ``l``'s dense SwiGLU MLP."""
    return swiglu(h, lp["w_gate"][l], lp["w_up"][l], lp["w_down"][l])


def _ffn_of(cfg: ModelConfig, ffn: Optional[FFN]) -> FFN:
    """The forward's feed-forward: ``ffn`` if given, else SwiGLU. A MoE
    config has no SwiGLU weights: its forwards are models.mixtral's."""
    if ffn is not None:
        return ffn
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE config: use models.mixtral")
    return swiglu_ffn


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
    *,
    attention: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed ragged prefill forward: one token stream per admission wave,
    each token attending its own row's prefix pages in place plus the
    row's suffix causally (``layers.ragged_prefill_dispatch``). Returns
    (fp32 logits [R, V] at each row's last live token, sfx_k, sfx_v
    [L, W, Hkv, D] in the pool's logical dtype, stream order, for
    ``paged_kv.paged_write_ragged``). The pool is only read. Llama only:
    models.mixtral has no ragged forward, as in the JAX package (its paged
    engine prefills in row-bucketed waves). ``attention`` replaces the
    dispatcher (the engine's pick: ``layers.attention_dispatchers``)."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r} is a MoE config: models.mixtral has no ragged "
            "prefill forward")
    attention = attention or ragged_prefill_dispatch
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
        attn = attention(
            q[0].contiguous(), ks, vs, pool_layer(pool_k, l),
            pool_layer(pool_v, l), row_tables, starts, lens, prefix_lens,
            window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(W, -1), lp["wo"][l])[None]
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu_ffn(h2, lp, l)
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
    *,
    ffn: Optional[FFN] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step of the two-segment chunked decode: the pool stays
    frozen for the chunk's K steps, this step's K/V lands in the chunk
    buffer at index ``step`` (written in place), and attention spans the
    live pages + the chunk buffer under one softmax
    (``layers.paged_attention_dispatch_chunked``). Returns (fp32 logits
    [B, 1, V], chunk_kv)."""
    ffn = _ffn_of(cfg, ffn)
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
        x = x + ffn(h2, lp, l)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, 0], _head(params))[:, None]
    return logits, (hk, hv)


def forward_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, 1] one decode step
    positions: torch.Tensor,   # [B, 1] absolute position per slot
    cache: Dict[str, Any],     # {"k","v","page_table"}: written in place
    *,
    ffn: Optional[FFN] = None,
    attention: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-step paged decode forward (``SWARMDB_CHUNKED=0``): in every
    layer the step's K/V is written into its page first
    (``paged_kv.paged_write_decode``; a requant window for an int8 pool),
    then each slot attends its pages up to and including its position
    (``layers.paged_attention_dispatch``, or ``attention``, the engine's
    pick). Returns (fp32 logits [B, 1, V], the cache)."""
    ffn = _ffn_of(cfg, ffn)
    attention = attention or paged_attention_dispatch
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
        attn = attention(q.contiguous(), kp, vp, table, positions,
                         window=cfg.sliding_window)
        x = x + torch.matmul(attn.reshape(B, 1, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + ffn(h2, lp, l)
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


# Tensor parallelism (``tp``, a ``parallel.collectives.Axis``; None on one
# process): the dense engine's forwards run on one rank's share of the
# weights (``param_plan``) and of the slot cache (``cache_plan``), read
# their head counts off the weights (Hq / m and Hkv / m; the group size G
# is unchanged, so the decode kernels run as they are on the rank's
# heads), and meet the other ranks in four places: the embedding (a
# masked lookup into the vocab share, summed), after ``wo`` and after
# ``w_down`` (each a sum of the row-split products), and the logits (the
# vocab shares gathered). Every rank then holds the same logits.


def _heads(cfg: ModelConfig, lp: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(Hq, Hkv) of the weights at hand: the config's, or a tensor-
    parallel rank's share."""
    hd = cfg.head_dim
    return lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd


def _embed(params: Params, tokens: torch.Tensor, tp) -> torch.Tensor:
    if tp is None:
        return params["embed"][tokens.long()]
    return tp.embed(params["embed"], tokens)


def _reduce(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-split product summed over the model axis (itself on one
    process)."""
    return y if tp is None else tp.all_reduce(y)


def _vocab(logits: torch.Tensor, tp) -> torch.Tensor:
    """The rank's vocab share of the logits gathered whole."""
    return logits if tp is None else tp.gather_last(logits)


def _final_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  logits_at: Optional[torch.Tensor], tp=None) -> torch.Tensor:
    """fp32 logits [B, T, V] of the final hidden states, or [B, V] at each
    row's ``logits_at`` index (the LM head only where it is sampled)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        return _vocab(_logits(x[rows, logits_at.long()], _head(params)), tp)
    B, T = x.shape[0], x.shape[1]
    logits = _vocab(_logits(x.reshape(B * T, -1), _head(params)), tp)
    return logits.reshape(B, T, -1)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, T]
    positions: torch.Tensor,   # [B, T] absolute positions per row
    cache: KVCache,            # ([L, B, S, Hkv, D], ...): written in place
    logits_at: Optional[torch.Tensor] = None,  # [B] row indices into T
    *,
    ffn: Optional[FFN] = None,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One forward pass over the dense slot cache, for mixed prefill and
    decode rows: each row's positions are its own absolute offsets and
    attention masks by position (``layers.gqa_attention``; a decode step,
    T == 1, goes to the dense single-step decode kernel). Every layer's
    K/V go into the cache first, in place (with T == S, a prefill over
    its whole temp cache, the cache simply takes them). Returns (fp32
    logits [B, T, V], or [B, V] at each row's ``logits_at`` index, the
    cache). ``tp``: one rank's share of a tensor-parallel forward (the
    section comment above)."""
    ffn = _ffn_of(cfg, ffn)
    ck, cv = cache
    B, T = tokens.shape
    full = T == ck.shape[2]
    x = _embed(params, tokens, tp)                       # [B, T, dim]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    Hq, Hkv = _heads(cfg, lp)
    for l in range(ck.shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, Hq, Hkv, cfg.head_dim, cos, sin)
        kl, vl = write_kv_cache(ck[l], cv[l], k, v, positions)
        if full:  # the write handed back the fresh K/V: keep them
            ck[l].copy_(kl)
            cv[l].copy_(vl)
        attn = gqa_attention(q, kl, vl, positions, window=cfg.sliding_window)
        x = x + _reduce(torch.matmul(attn.reshape(B, T, -1), lp["wo"][l]),
                        tp)
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + _reduce(ffn(h2, lp, l), tp)
    return _final_logits(params, cfg, x, logits_at, tp), cache


def forward_chunked(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, 1] one decode step
    positions: torch.Tensor,   # [B, 1] absolute positions
    cache: KVCache,            # FROZEN during the chunk
    chunk_kv: Tuple[torch.Tensor, torch.Tensor],  # [L, B, Kc, Hkv, D]
    step: int,
    *,
    ffn: Optional[FFN] = None,
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step of the dense engine's chunked decode: the slot
    cache stays frozen for the chunk's K steps, this step's K/V goes into
    the chunk buffer at index ``step`` (in place), and attention spans
    each slot's lane below its chunk start plus the chunk buffer under
    one softmax (``layers.gqa_attention_chunked``, the dense two-segment
    kernel on the card). Returns (fp32 logits [B, 1, V], chunk_kv).
    ``tp`` as in ``forward``."""
    ffn = _ffn_of(cfg, ffn)
    ck, cv = cache
    hk, hv = chunk_kv
    x = _embed(params, tokens, tp)                       # [B, 1, dim]
    B = x.shape[0]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    lp = params["layers"]
    Hq, Hkv = _heads(cfg, lp)
    for l in range(ck.shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, Hq, Hkv, cfg.head_dim, cos, sin)
        hk[l][:, step] = k[:, 0].to(hk.dtype)
        hv[l][:, step] = v[:, 0].to(hv.dtype)
        attn = gqa_attention_chunked(q, ck[l], cv[l], hk[l], hv[l],
                                     positions, step,
                                     window=cfg.sliding_window)
        x = x + _reduce(torch.matmul(attn.reshape(B, 1, -1), lp["wo"][l]),
                        tp)
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + _reduce(ffn(h2, lp, l), tp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _vocab(_logits(x[:, 0], _head(params)), tp)[:, None]
    return logits, (hk, hv)


def merge_chunk(cache: KVCache, chunk_kv: Tuple[torch.Tensor, torch.Tensor],
                start_positions: torch.Tensor) -> KVCache:
    """Fold a finished chunk's K/V into the slot cache, in place, once per
    chunk (``layers.merge_chunk_kv``; columns past the lane dropped). A
    tensor-parallel rank merges its own KV heads: no collective."""
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
    *,
    ffn: Optional[FFN] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix-cache suffix prefill core: compute only the suffix tokens,
    each row attending its reused prefix pages (gathered per layer;
    dequantized for an int8 pool) plus the suffix causally
    (``layers.gqa_attention_prefix``). The pool is only read. Returns
    (fp32 logits [Bp, T, V], or [Bp, V] with ``logits_at``, sfx_k, sfx_v
    [L, Bp, T, Hkv, D] in the gathered pages' dtype)."""
    ffn = _ffn_of(cfg, ffn)
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
        x = x + ffn(h2, lp, l)
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
    *,
    ffn: Optional[FFN] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-cache prefix prefill: ``forward_prefix_pages`` plus each
    row's lane image (``layers.compose_prefix_lane``: prefix pages, then
    the suffix at its positions), ready for one slot-cache insert.
    Returns (fp32 logits, lane_k, lane_v [L, Bp, lane_pages * ps, Hkv,
    D])."""
    logits, sfx_k, sfx_v = forward_prefix_pages(
        params, cfg, tokens, prefix_table, prefix_lens, pool_k, pool_v,
        logits_at=logits_at, ffn=ffn)
    lane_k, lane_v = compose_prefix_lane(pool_k, pool_v, prefix_table,
                                         prefix_lens, sfx_k, sfx_v,
                                         lane_pages)
    return logits, lane_k, lane_v


# ----------------------------------------------------- pipeline parallelism


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def param_plan_pp(cfg: ModelConfig, pipe_axis: str = "pipe") -> Params:
    """The shard plan of pipeline parallelism (the JAX package's
    ``param_specs_pp``): the stacked [L, ...] layer weights split their
    layer dim over ``pipe_axis`` (each stage holds L / pipe consecutive
    layers); the embedding, the norms and the head whole."""
    plan: Params = {
        "embed": None,
        "layers": {k: (0, pipe_axis) for k in _LAYER_KEYS},
        "final_norm": None,
    }
    if not cfg.tie_embeddings:
        plan["lm_head"] = None
    return plan


def _prefill_layers(cfg: ModelConfig, lp: Dict[str, torch.Tensor],
                    x: torch.Tensor, positions: torch.Tensor,
                    attend: Callable) -> Tuple[torch.Tensor, list, list]:
    """The stacked layers ``lp`` over a prefill without a cache: each
    layer's attention is ``attend(q, k, v)`` over the call's own K/V.
    Returns (x, [K per layer], [V per layer])."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    B, T = x.shape[0], x.shape[1]
    ks, vs = [], []
    for l in range(lp["attn_norm"].shape[0]):
        h = rms_norm(x, lp["attn_norm"][l], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, l, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cos, sin)
        attn = attend(q, k, v)
        x = x + torch.matmul(attn.reshape(B, T, -1), lp["wo"][l])
        h2 = rms_norm(x, lp["mlp_norm"][l], cfg.norm_eps)
        x = x + swiglu_ffn(h2, lp, l)
        ks.append(k)
        vs.append(v)
    return x, ks, vs


def forward_pipelined(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, T], the same on every stage
    positions: torch.Tensor,   # [B, T]
    axis,                      # parallel.collectives.Axis: the pipe axis
    *,
    microbatches: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Pipeline-parallel prefill, GPipe style (the JAX package's
    ``forward_pipelined``): this rank is stage ``axis.index`` and holds
    its L / P layers (``param_plan_pp``); the batch splits into M
    microbatches that flow through the stage ring over M + P - 1 steps,
    each step one hand-off to the next stage (``axis.shift``). Stage 0
    embeds; at steady state every stage computes a different microbatch,
    and a stage skips the edge steps where it holds none (the JAX
    program computes masked garbage there; nothing of it is kept). The
    last stage's post-norm activations are summed over the axis (zeros
    elsewhere), then every rank applies the head.

    Returns fp32 logits [B, T, V] (the same on every rank) and this
    stage's prompt K/V [L / P, B, T, Hkv, D]. Raises the JAX package's
    ``ValueError`` for a MoE config, n_layers % P and B % M. The prefill
    path only: decode keeps the model and data axes."""
    if cfg.is_moe:
        raise ValueError(f"{cfg.name!r} is MoE; PP is dense-only for now")
    n_stages = axis.size
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by pipe={n_stages}")
    B, T = tokens.shape
    M = microbatches or min(B, max(2, n_stages))
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    Bm, stage = B // M, axis.index
    lp = params["layers"]
    dtype, dev = params["embed"].dtype, params["embed"].device
    mb_tok = tokens.reshape(M, Bm, T)
    mb_pos = positions.reshape(M, Bm, T)
    state = torch.zeros((Bm, T, cfg.dim), dtype=dtype, device=dev)
    act = torch.zeros((M, Bm, T, cfg.dim), dtype=dtype, device=dev)
    ks_all: list = [None] * M
    vs_all: list = [None] * M

    def attend(q, k, v, pos):
        return gqa_attention(q, k, v, pos, window=cfg.sliding_window)

    for t in range(M + n_stages - 1):
        m = t - stage                     # the microbatch here now
        if 0 <= m < M:
            x = (params["embed"][mb_tok[m].long()] if stage == 0
                 else state)
            x, ks, vs = _prefill_layers(
                cfg, lp, x, mb_pos[m],
                lambda q, k, v, pos=mb_pos[m]: attend(q, k, v, pos))
            ks_all[m], vs_all[m] = torch.stack(ks), torch.stack(vs)
            if stage == n_stages - 1:
                act[m] = rms_norm(x, params["final_norm"], cfg.norm_eps)
        else:
            x = state
        state = axis.shift(x)
    # the activations live on the last stage only (zeros elsewhere): one
    # sum over the axis gives them to every stage, which applies the head
    axis.all_reduce(act)
    logits = _logits(act.reshape(B * T, cfg.dim), _head(params))
    ks_out = torch.stack(ks_all, 1).reshape(-1, B, T, cfg.n_kv_heads,
                                            cfg.head_dim)
    vs_out = torch.stack(vs_all, 1).reshape(-1, B, T, cfg.n_kv_heads,
                                            cfg.head_dim)
    return logits.reshape(B, T, -1), (ks_out, vs_out)


# ------------------------------------------- sequence-parallel long prefill


def forward_seq_parallel(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [B, T / n] this rank's block of the prompt
    positions: torch.Tensor,   # [B, T / n] its absolute positions
    axis,                      # parallel.collectives.Axis: the ring
) -> Tuple[torch.Tensor, KVCache]:
    """Long-prompt prefill with the sequence split over ``axis`` (the JAX
    package's ``forward_seq_parallel``, whose default ring is the data
    axis): each rank holds its block of T / n tokens, and every layer's
    attention is ``ops.ring_attention`` over the ring, so a rank's peak
    memory is O(T / n) and no [T, T] scores exist. Every rank of the axis
    calls it together, each with its own block.

    Returns this rank's block of the fp32 logits [B, T / n, V] and of the
    prompt K/V [L, B, T / n, Hkv, D] (its rows of the slot cache a dense
    forward over the whole prompt writes)."""
    from ..ops.ring_attention import ring_attention

    if cfg.is_moe:
        raise ValueError(f"{cfg.name!r} is MoE; the sequence-parallel "
                         "prefill is dense-only")
    x = params["embed"][tokens.long()]
    x, ks, vs = _prefill_layers(
        cfg, params["layers"], x, positions,
        lambda q, k, v: ring_attention(q, k, v, positions, positions, axis,
                                       window=cfg.sliding_window))
    logits = _final_logits(params, cfg, x, None)
    return logits, (torch.stack(ks), torch.stack(vs))
