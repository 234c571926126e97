"""Mixtral-style sparse Mixture-of-Experts family, in PyTorch.

The counterpart of ``swarmdb_tpu/models/mixtral.py``: the Llama skeleton
(stacked layers, GQA attention with per-row positions, the same caches and
pools) with the dense FFN replaced by a top-k routed MoE block. The layer
bodies are ``models.llama``'s, run with ``moe_block`` as their ``ffn``;
this module adds the block, the parameters and the entry points under the
JAX module's names. Mixtral has no ragged prefill forward (nor has the
JAX package's): the paged engine prefills it in row-bucketed waves
(``forward`` over a temp cache) and prefix waves (``forward_prefix_pages``).

The block's two dispatch forms (``SWARMDB_MOE_DISPATCH``, default
``scatter``) make the same routing decisions and give the same values:

- ``scatter``: each (token, choice) is written into its expert's queue
  ``[E, C, D]`` and gathered back, gate-weighted -- O(N k D) movement.
- ``einsum``: the capacity-based one-hot dispatch and combine tensors
  ``[N, E, C]`` (the form the JAX package shards over an expert axis).

Routing follows the JAX block exactly, since a different token dropped
gives a different reply: router logits in fp32 over every row of the call
(padding rows and idle decode slots included: they take capacity),
``C = max(1, int(N * k * capacity_factor / E))``, top-k in descending
order, softmax over the selected logits only, each choice's place in its
expert's queue a running count over the token-major flattening ``[N * k,
E]``, choices at or past ``C`` dropped (the residual carries them), and
the gates cast to the activations' dtype before they weigh the experts'
outputs. The expert products ``[E, C, D] x [E, D, F]`` are plain batched
matrix products (``torch.bmm``), as they are XLA matmuls, not Pallas
kernels, in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import DeviceLike, resolve_device
from . import llama
from .configs import ModelConfig
from .llama import (  # noqa: F401  (shared caches and chunk helpers)
    init_chunk_kv,
    init_kv_cache,
    init_paged_cache,
    init_prefix_pool,
    merge_chunk,
    merge_chunk_scatter,
    merge_paged_chunk,
    random_weight,
)

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]

DEFAULT_CAPACITY_FACTOR = 2.0


def _check_moe(cfg: ModelConfig) -> None:
    if not cfg.is_moe:
        raise ValueError(f"{cfg.name!r} is dense; use models.llama")


# ---------------------------------------------------------------------- init


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random init from ``seed`` with a ``torch.Generator`` on the target
    device: normal / sqrt(fan_in), norms at one, the JAX package's keys
    and shapes (its values differ; tests carry JAX weights over with
    ``utils.convert``). Stacked weights are drawn one matrix at a time
    (``llama.random_weight``): the fp32 scratch of an expert stack is one
    expert's [D, F], never the [L, E, D, F] stack."""
    _check_moe(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, Fd, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape, fan_in, stacked=True):
        return random_weight(gen, shape, fan_in, dtype, dev, stacked)

    return {
        "embed": dense((cfg.vocab_size, D), D, stacked=False),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=dtype, device=dev),
            "wq": dense((L, D, Hq * hd), D),
            "wk": dense((L, D, Hkv * hd), D),
            "wv": dense((L, D, Hkv * hd), D),
            "wo": dense((L, Hq * hd, D), Hq * hd),
            "mlp_norm": torch.ones((L, D), dtype=dtype, device=dev),
            "router": dense((L, D, E), D),
            "w_gate": dense((L, E, D, Fd), D),
            "w_up": dense((L, E, D, Fd), D),
            "w_down": dense((L, E, Fd, D), Fd),
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": dense((D, cfg.vocab_size), D, stacked=False),
    }


# ---------------------------------------------------------------- MoE block


def _default_dispatch() -> str:
    """The dispatch form when the caller names none: ``SWARMDB_MOE_DISPATCH``
    (default ``scatter``), read at every call."""
    return os.environ.get("SWARMDB_MOE_DISPATCH", "scatter")


def moe_block(
    x: torch.Tensor,           # [B, T, D]
    router_w: torch.Tensor,    # [D, E]
    w_gate: torch.Tensor,      # [E, D, F]
    w_up: torch.Tensor,        # [E, D, F]
    w_down: torch.Tensor,      # [E, F, D]
    top_k: int,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    dispatch: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN with capacity-based dispatch. Returns
    (output [B, T, D] in x.dtype, the mean expert load [E] for balance
    metrics). ``dispatch`` is ``scatter`` or ``einsum`` (None reads
    ``SWARMDB_MOE_DISPATCH``); both give the same routing and values."""
    B, T, D = x.shape
    E = router_w.shape[-1]
    N = B * T
    C = max(1, int(N * top_k * capacity_factor / E))
    if dispatch is None:
        dispatch = _default_dispatch()
    if dispatch not in ("scatter", "einsum"):
        raise ValueError(f"MoE dispatch {dispatch!r}: expected 'scatter' "
                         "or 'einsum'")

    xf = x.reshape(N, D)
    logits = torch.matmul(xf.float(), router_w.float())           # [N, E]
    top_logits, top_idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    gates = torch.softmax(top_logits, dim=-1)                      # [N, k]
    assign = F.one_hot(top_idx, E)                                 # [N, k, E]
    # place of each (token, choice) in its expert's queue: a running count
    # over the token-major flattening (token n's k choices, then n + 1's)
    flat = assign.reshape(N * top_k, E)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)
    pos = pos.reshape(N, top_k)
    within = pos < C
    load = assign.sum(1).float().mean(0)                           # [E]

    if dispatch == "scatter":
        # one flat queue of E * C rows plus a sink row for the choices
        # over capacity: (expert, place) pairs below C are unique, so only
        # the sink is written twice, and it is dropped
        e_idx = top_idx.reshape(-1)
        keep = within.reshape(-1)
        row = torch.where(keep, e_idx * C + pos.reshape(-1),
                          torch.full_like(e_idx, E * C))
        tok = torch.arange(N, device=x.device).repeat_interleave(top_k)
        queue = x.new_zeros((E * C + 1, D))
        queue[row] = xf[tok]
        xe = queue[:E * C].view(E, C, D)
        ye = _experts(xe, w_gate, w_up, w_down).view(E * C, D)
        # each choice reads its row back (a clamped row past capacity,
        # masked to zero), weighted by its gate in x.dtype
        back = e_idx * C + torch.clamp(pos.reshape(-1), max=C - 1)
        w = (keep.float() * gates.reshape(-1)).to(x.dtype)
        yk = ye[back] * w[:, None]
        y = x.new_zeros((N, D)).index_add_(0, tok, yk)
        return y.reshape(B, T, D), load

    # dispatch [N, E, C] (0/1) and combine [N, E, C] (gate-weighted); a
    # place past capacity has no column, so its one-hot row is zero
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).float()
    disp_k = (assign.float()[:, :, :, None] * pos_oh[:, :, None, :]
              * within[:, :, None, None])                          # [N,k,E,C]
    dispatch_t = disp_k.sum(1)
    combine = (disp_k * gates[:, :, None, None]).sum(1)
    xe = torch.einsum("nd,nec->ecd", xf, dispatch_t.to(x.dtype))
    ye = _experts(xe, w_gate, w_up, w_down)
    y = torch.einsum("ecd,nec->nd", ye, combine.to(x.dtype))
    return y.reshape(B, T, D), load


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its queue: [E, C, D] -> [E, C, D]."""
    g = F.silu(torch.bmm(xe, w_gate))
    u = torch.bmm(xe, w_up)
    return torch.bmm(g * u, w_down)


def _moe_ffn(cfg: ModelConfig, dispatch: Optional[str]) -> llama.FFN:
    """The llama layer bodies' ``ffn`` for this config: layer ``l``'s MoE
    block (the load aux is for direct ``moe_block`` callers)."""
    def ffn(h: torch.Tensor, lp: Dict[str, torch.Tensor], l: int
            ) -> torch.Tensor:
        out, _load = moe_block(h, lp["router"][l], lp["w_gate"][l],
                               lp["w_up"][l], lp["w_down"][l],
                               top_k=cfg.experts_per_token,
                               dispatch=dispatch)
        return out
    return ffn


# ------------------------------------------------------------------- forward


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            logits_at: Optional[torch.Tensor] = None,
            moe_dispatch: Optional[str] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """``llama.forward`` with the MoE block: the dense engine's bucketed
    prefill (``logits_at``) and single-step decode (T == 1, kernel 8 on
    the card), and the paged engine's row-bucketed prefill over a temp
    cache."""
    _check_moe(cfg)
    return llama.forward(params, cfg, tokens, positions, cache,
                         logits_at=logits_at,
                         ffn=_moe_ffn(cfg, moe_dispatch))


def forward_prefix_pages(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, prefix_table: torch.Tensor,
                         prefix_lens: torch.Tensor, pool_k: Any, pool_v: Any,
                         logits_at: Optional[torch.Tensor] = None,
                         moe_dispatch: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix-cache suffix prefill over a plain or int8 pool
    (``llama.forward_prefix_pages``) with the MoE block. Returns (fp32
    logits, sfx_k, sfx_v [L, Bp, T, Hkv, D])."""
    _check_moe(cfg)
    return llama.forward_prefix_pages(
        params, cfg, tokens, prefix_table, prefix_lens, pool_k, pool_v,
        logits_at=logits_at, ffn=_moe_ffn(cfg, moe_dispatch))


def forward_prefix_lane(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, prefix_table: torch.Tensor,
                        prefix_lens: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, lane_pages: int,
                        logits_at: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-cache prefix prefill (``llama.forward_prefix_lane``) with the
    MoE block. Returns (fp32 logits, lane_k, lane_v)."""
    _check_moe(cfg)
    return llama.forward_prefix_lane(
        params, cfg, tokens, prefix_table, prefix_lens, pool_k, pool_v,
        lane_pages, logits_at=logits_at, ffn=_moe_ffn(cfg, None))


def forward_paged_chunked(params: Params, cfg: ModelConfig,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          cache: Dict[str, Any],
                          chunk_kv: Tuple[torch.Tensor, torch.Tensor],
                          step: int, moe_dispatch: Optional[str] = None
                          ) -> Tuple[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Two-segment chunked decode step over the paged pool
    (``llama.forward_paged_chunked``: kernel 2, or 5 over int8 pages)
    with the MoE block."""
    _check_moe(cfg)
    return llama.forward_paged_chunked(params, cfg, tokens, positions, cache,
                                       chunk_kv, step,
                                       ffn=_moe_ffn(cfg, moe_dispatch))


def forward_chunked(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: KVCache,
                    chunk_kv: Tuple[torch.Tensor, torch.Tensor], step: int,
                    moe_dispatch: Optional[str] = None
                    ) -> Tuple[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Two-segment chunked decode step over the dense slot cache
    (``llama.forward_chunked``: kernel 7) with the MoE block."""
    _check_moe(cfg)
    return llama.forward_chunked(params, cfg, tokens, positions, cache,
                                 chunk_kv, step,
                                 ffn=_moe_ffn(cfg, moe_dispatch))


def forward_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: Dict[str, Any],
                  moe_dispatch: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-step paged decode (``llama.forward_paged``: kernel 3, or 6
    over int8 pages) with the MoE block."""
    _check_moe(cfg)
    return llama.forward_paged(params, cfg, tokens, positions, cache,
                               ffn=_moe_ffn(cfg, moe_dispatch))
