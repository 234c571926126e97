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

Over a mesh (``parallel/serving.py``; the JAX package's ``param_specs``
and GSPMD, here ``param_plan`` and explicit collectives): attention splits
over the model axis as Llama's does, and the expert stacks split E over
the expert axis and F over the model axis. The block then runs, on each
rank, its F slice of its own experts' queues only: a choice whose expert
lives on another rank contributes zeros here, and one all-reduce over the
expert axis (``expert``) sums the ranks' gate-weighted outputs, each row a
sum of at most k non-zero terms. The model axis's partial sums over F are
summed by the all-reduce the Llama layer bodies already issue after the
feed-forward. Every rank of a data group routes from the same
activations (an all-reduce hands each rank the same bits), so their
routing agrees without a collective.

Over a data axis the rows a call counts follow the JAX function it
mirrors (``Rows``): where that function is a GSPMD program over the whole
call (the dense engine's decode steps and prefill waves, the sharded paged
engine's prefix waves), C and every choice's place in its queue count the
global call in its global row order, so a rank's routing needs the other
ranks' expert choices: one all-reduce over the data axis of each token's
top-k ids per MoE layer. Where it is ``shard_map`` (the sharded paged
engine's decode, chunk and packed waves), a rank's rows are the call.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

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
                dtype: torch.dtype = torch.bfloat16,
                keep: Optional[Callable[[str, torch.Tensor],
                                        torch.Tensor]] = None) -> Params:
    """Random init from ``seed`` with a ``torch.Generator`` on the target
    device: normal / sqrt(fan_in), norms at one, the JAX package's keys
    and shapes (its values differ; tests carry JAX weights over with
    ``utils.convert``). Stacked weights are drawn one matrix at a time
    (``llama.random_weight``): the fp32 scratch of an expert stack is one
    expert's [D, F], never the [L, E, D, F] stack. ``keep(key, tensor)``
    as in ``llama.init_params``: a rank of a mesh keeps its slice of each
    leaf as soon as it is drawn, so every rank holds the weights one
    process draws."""
    _check_moe(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, D, Fd, E = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.n_experts
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kept = keep or (lambda _key, t: t)

    def dense(key, shape, fan_in, stacked=True):
        return kept(key, random_weight(gen, shape, fan_in, dtype, dev,
                                       stacked))

    def ones(key, shape):
        return kept(key, torch.ones(shape, dtype=dtype, device=dev))

    # drawn in this order whatever ``keep`` does
    return {
        "embed": dense("embed", (cfg.vocab_size, D), D, stacked=False),
        "layers": {
            "attn_norm": ones("layers.attn_norm", (L, D)),
            "wq": dense("layers.wq", (L, D, Hq * hd), D),
            "wk": dense("layers.wk", (L, D, Hkv * hd), D),
            "wv": dense("layers.wv", (L, D, Hkv * hd), D),
            "wo": dense("layers.wo", (L, Hq * hd, D), Hq * hd),
            "mlp_norm": ones("layers.mlp_norm", (L, D)),
            "router": dense("layers.router", (L, D, E), D),
            "w_gate": dense("layers.w_gate", (L, E, D, Fd), D),
            "w_up": dense("layers.w_up", (L, E, D, Fd), D),
            "w_down": dense("layers.w_down", (L, E, Fd, D), Fd),
        },
        "final_norm": ones("final_norm", (D,)),
        "lm_head": dense("lm_head", (D, cfg.vocab_size), D, stacked=False),
    }


def param_plan(cfg: ModelConfig, model_axis: str = "model",
               expert_axis: str = "expert") -> Params:
    """The shard plan over ``model_axis`` and ``expert_axis`` (the
    counterpart of the JAX package's ``param_specs``): attention as
    Llama's (``llama.param_plan``: Q/K/V on their output features, O on
    its rows, the embedding and the head on the vocab), the expert stacks
    E over the expert axis and F over the model axis (``w_gate`` / ``w_up``
    [L, E, D, F] on dims 1 and 3, ``w_down`` [L, E, F, D] on dims 1 and 2),
    the router and the norms whole."""
    _check_moe(cfg)
    m, e = model_axis, expert_axis
    return {
        "embed": (0, m),
        "layers": {
            "attn_norm": None,
            "wq": (2, m),
            "wk": (2, m),
            "wv": (2, m),
            "wo": (1, m),
            "mlp_norm": None,
            "router": None,
            "w_gate": ((1, e), (3, m)),
            "w_up": ((1, e), (3, m)),
            "w_down": ((1, e), (2, m)),
        },
        "final_norm": None,
        "lm_head": (1, m),
    }


# ---------------------------------------------------------------- MoE block


def _default_dispatch() -> str:
    """The dispatch form when the caller names none: ``SWARMDB_MOE_DISPATCH``
    (default ``scatter``), read at every call."""
    return os.environ.get("SWARMDB_MOE_DISPATCH", "scatter")


class Rows:
    """Which rows of a global call a data rank's rows are, for a call
    whose JAX counterpart is a GSPMD program over the whole call (module
    docstring): ``axis`` the data axis (``parallel.collectives.Axis``),
    ``ids`` [R] int64 on the rank's device, each local row's index in the
    call (-1: a row run only so the rank meets the collectives, counted
    nowhere), ``n`` the call's rows. The ranks' rows together cover each
    row of the call once."""

    def __init__(self, axis, ids: torch.Tensor, n: int) -> None:
        self.axis = axis
        self.ids = ids
        self.n = int(n)

    def choices(self, top_idx: torch.Tensor, T: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every token's top-k expert ids over the whole call [n * T, k]
        (-1 where no rank counted the token), gathered by one all-reduce
        over the data axis (each token's ids from its one rank, zeros from
        the others); this rank's tokens' places in it [R * T]; and which
        of them are counted [R * T]."""
        dev, k = top_idx.device, top_idx.shape[-1]
        R, N = self.ids.shape[0], self.n * T
        tok = (self.ids[:, None] * T
               + torch.arange(T, device=dev)[None]).reshape(-1)
        counted = (self.ids[:, None] >= 0).expand(R, T).reshape(-1)
        # one sink row past the call takes the uncounted tokens' writes
        buf = torch.zeros((N + 1, k), dtype=torch.int32, device=dev)
        buf[torch.where(counted, tok, N)] = top_idx.to(torch.int32) + 1
        self.axis.all_reduce(buf)
        return buf[:N].long() - 1, torch.clamp(tok, min=0), counted


def moe_block(
    x: torch.Tensor,           # [B, T, D]
    router_w: torch.Tensor,    # [D, E]
    w_gate: torch.Tensor,      # [E, D, F] (or this rank's [E / ep, D, F / m])
    w_up: torch.Tensor,        # [E, D, F]
    w_down: torch.Tensor,      # [E, F, D]
    top_k: int,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    dispatch: Optional[str] = None,
    *,
    expert=None,
    rows: Optional[Rows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN with capacity-based dispatch. Returns
    (output [B, T, D] in x.dtype, the mean expert load [E] of this call's
    rows, for balance metrics). ``dispatch`` is ``scatter`` or ``einsum``
    (None reads ``SWARMDB_MOE_DISPATCH``); both give the same routing and
    values.

    On a mesh: ``expert`` (the expert axis) when the expert weights are
    this rank's E / ep experts (the output is then summed over the axis
    here); ``rows`` when C and the queue places count a global call
    (``Rows``). With F split over a model axis the output is this rank's
    partial sum, for the caller's all-reduce."""
    B, T, D = x.shape
    E = router_w.shape[-1]
    El = w_gate.shape[0]
    if El != E and expert is None:
        raise ValueError(f"{El} of {E} experts on this rank need the "
                         "expert axis")
    lo = 0 if El == E else expert.index * El
    N = B * T
    if dispatch is None:
        dispatch = _default_dispatch()
    if dispatch not in ("scatter", "einsum"):
        raise ValueError(f"MoE dispatch {dispatch!r}: expected 'scatter' "
                         "or 'einsum'")

    xf = x.reshape(N, D)
    logits = torch.matmul(xf.float(), router_w.float())           # [N, E]
    top_logits, top_idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    gates = torch.softmax(top_logits, dim=-1)                      # [N, k]
    experts = torch.arange(E, device=x.device)
    load = (top_idx[..., None] == experts).sum(1).float().mean(0)  # [E]
    # the call's choices: this call's rows, or the global call's
    every, mine, counted = ((top_idx, None, None) if rows is None
                            else rows.choices(top_idx, T))
    C = max(1, int(every.shape[0] * top_k * capacity_factor / E))
    # place of each (token, choice) in its expert's queue: a running count
    # over the token-major flattening (token n's k choices, then n + 1's);
    # a token no rank counted (-1) takes no place
    flat = (every[..., None] == experts).long().reshape(-1, E)
    pos = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)
    pos = pos.reshape(-1, top_k)
    # kept: within capacity, and (on an expert axis) one of this rank's;
    # an uncounted token (a row run only to meet the collectives) none
    local_e = top_idx - lo
    if mine is not None:
        pos = torch.where(counted[:, None], pos[mine], C)
    keep = (pos < C) & (local_e >= 0) & (local_e < El)

    if dispatch == "scatter":
        # one flat queue of El * C rows plus a sink row for the choices
        # not kept here: (expert, place) pairs below C are unique, so only
        # the sink is written twice, and it is dropped
        e_loc = local_e.reshape(-1)
        kept = keep.reshape(-1)
        row = torch.where(kept, e_loc * C + pos.reshape(-1),
                          torch.full_like(e_loc, El * C))
        # each choice's token, without repeat_interleave (older PyTorch
        # builds its repeats tensor on the host: no CUDA graph captures it)
        tok = torch.arange(N * top_k, device=x.device) // top_k
        queue = x.new_zeros((El * C + 1, D))
        queue[row] = xf[tok]
        xe = queue[:El * C].view(El, C, D)
        ye = _experts(xe, w_gate, w_up, w_down).view(El * C, D)
        # each choice reads its row back (a clamped row when not kept,
        # masked to zero), weighted by its gate in x.dtype
        back = (torch.clamp(e_loc, 0, El - 1) * C
                + torch.clamp(pos.reshape(-1), max=C - 1))
        w = (kept.float() * gates.reshape(-1)).to(x.dtype)
        yk = ye[back] * w[:, None]
        y = x.new_zeros((N, D)).index_add_(0, tok, yk)
    else:
        # dispatch [N, El, C] (0/1) and combine [N, El, C] (gate-weighted);
        # a place past capacity has no column, so its one-hot row is zero
        pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).float()
        assign = (local_e[..., None]
                  == torch.arange(El, device=x.device)).float()
        disp_k = (assign[:, :, :, None] * pos_oh[:, :, None, :]
                  * keep[:, :, None, None])                        # [N,k,El,C]
        dispatch_t = disp_k.sum(1)
        combine = (disp_k * gates[:, :, None, None]).sum(1)
        xe = torch.einsum("nd,nec->ecd", xf, dispatch_t.to(x.dtype))
        ye = _experts(xe, w_gate, w_up, w_down)
        y = torch.einsum("ecd,nec->nd", ye, combine.to(x.dtype))
    if El != E:
        expert.all_reduce(y)
    return y.reshape(B, T, D), load


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its queue: [E, C, D] -> [E, C, D]."""
    g = F.silu(torch.bmm(xe, w_gate))
    u = torch.bmm(xe, w_up)
    return torch.bmm(g * u, w_down)


def _moe_ffn(cfg: ModelConfig, dispatch: Optional[str], ep=None,
             rows: Optional[Rows] = None) -> llama.FFN:
    """The llama layer bodies' ``ffn`` for this config: layer ``l``'s MoE
    block over ``ep`` and ``rows`` (``moe_block``; the load aux is for
    direct ``moe_block`` callers)."""
    def ffn(h: torch.Tensor, lp: Dict[str, torch.Tensor], l: int
            ) -> torch.Tensor:
        out, _load = moe_block(h, lp["router"][l], lp["w_gate"][l],
                               lp["w_up"][l], lp["w_down"][l],
                               top_k=cfg.experts_per_token,
                               dispatch=dispatch, expert=ep, rows=rows)
        return out
    return ffn


# ------------------------------------------------------------------- forward


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            logits_at: Optional[torch.Tensor] = None,
            moe_dispatch: Optional[str] = None, *, tp=None, ep=None,
            rows: Optional[Rows] = None) -> Tuple[torch.Tensor, KVCache]:
    """``llama.forward`` with the MoE block: the dense engine's bucketed
    prefill (``logits_at``) and single-step decode (T == 1, kernel 8 on
    the card), and the paged engine's row-bucketed prefill over a temp
    cache. On a mesh: ``tp`` the model axis (``llama.forward``), ``ep``
    the expert axis and ``rows`` the global call's rows (``moe_block``)."""
    _check_moe(cfg)
    return llama.forward(params, cfg, tokens, positions, cache,
                         logits_at=logits_at,
                         ffn=_moe_ffn(cfg, moe_dispatch, ep, rows), tp=tp)


def forward_prefix_pages(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, prefix_table: torch.Tensor,
                         prefix_lens: torch.Tensor, pool_k: Any, pool_v: Any,
                         logits_at: Optional[torch.Tensor] = None,
                         moe_dispatch: Optional[str] = None, *,
                         rows: Optional[Rows] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix-cache suffix prefill over a plain or int8 pool
    (``llama.forward_prefix_pages``) with the MoE block; ``rows``: a data
    rank's rows of a global wave (``moe_block``). Returns (fp32 logits,
    sfx_k, sfx_v [L, Bp, T, Hkv, D])."""
    _check_moe(cfg)
    return llama.forward_prefix_pages(
        params, cfg, tokens, prefix_table, prefix_lens, pool_k, pool_v,
        logits_at=logits_at, ffn=_moe_ffn(cfg, moe_dispatch, rows=rows))


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
                    moe_dispatch: Optional[str] = None, *, tp=None, ep=None,
                    rows: Optional[Rows] = None
                    ) -> Tuple[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Two-segment chunked decode step over the dense slot cache
    (``llama.forward_chunked``: kernel 7) with the MoE block; ``tp``,
    ``ep`` and ``rows`` as in ``forward``."""
    _check_moe(cfg)
    return llama.forward_chunked(params, cfg, tokens, positions, cache,
                                 chunk_kv, step,
                                 ffn=_moe_ffn(cfg, moe_dispatch, ep, rows),
                                 tp=tp)


def forward_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: Dict[str, Any],
                  moe_dispatch: Optional[str] = None, *,
                  attention: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-step paged decode (``llama.forward_paged``: kernel 3, or 6
    over int8 pages) with the MoE block."""
    _check_moe(cfg)
    return llama.forward_paged(params, cfg, tokens, positions, cache,
                               ffn=_moe_ffn(cfg, moe_dispatch),
                               attention=attention)
