"""Per-variant FLOP and byte prices for the device-time profiler.

The JAX engine asks XLA's cost model (``Lowered.cost_analysis()``) for
each compiled variant's FLOPs and bytes at warmup. PyTorch has no
counterpart, so the port prices a variant from the model config and the
variant's static shapes, once, at warmup (``Engine.profile_harvest``):

- **GEMM FLOPs**: 2 x (the matmul weights the call touches) x (tokens of
  the call, padding rows included), the LM head at the rows that take
  logits only. A MoE layer prices its router and its three expert
  ``bmm``s at the capacity the block really runs, ``C = max(1, int(N k
  cf / E))`` over the call's N tokens (``models/mixtral.py``). These
  equal ``torch.utils.flop_counter.FlopCounterMode``'s count of the plain
  forward with its attention left out (``tests/test_torch_profiler.py``).
- **Attention FLOPs**: QK and PV, 4 x Hq x D per query-key pair per
  layer, at the variant's static context: a decode step's row attends
  ``ctx`` keys (the engine's ``max_seq``); a prefill row of ``T``
  suffix tokens over ``P`` prefix tokens attends ``P T + T (T + 1) / 2``
  pairs; a ragged wave of ``W`` tokens is one causal stream of
  ``W (W + 1) / 2``.
- **Bytes**: the GEMM weights read once per forward (a chunk of K steps
  reads them K times), the KV the attention reads at that context and
  the KV the call writes. Activations are left out.

Unlike XLA's model this counts no elementwise work, so the two packages'
FLOPs per variant differ (the test prints both).

Stdlib-only: ``cfg`` is any object with ``ModelConfig``'s fields.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["moe_capacity", "gemm_flops", "weight_bytes", "attention_flops",
           "forward_cost", "decode_chunk_cost"]

#: models/mixtral.py's DEFAULT_CAPACITY_FACTOR
MOE_CAPACITY_FACTOR = 2.0


def moe_capacity(cfg: Any, n_tokens: int,
                 capacity_factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Slots per expert of a MoE block over ``n_tokens`` rows."""
    return max(1, int(n_tokens * cfg.experts_per_token * capacity_factor
                      / cfg.n_experts))


def _attn_proj_params(cfg: Any) -> int:
    """wq, wk, wv and wo of one layer."""
    d, D = cfg.dim, cfg.head_dim
    return d * cfg.n_heads * D * 2 + 2 * d * cfg.n_kv_heads * D


def gemm_flops(cfg: Any, n_tokens: int, head_rows: int) -> int:
    """Matmul FLOPs of one forward over ``n_tokens`` (every row of the
    call) with the LM head at ``head_rows`` rows."""
    L, d = cfg.n_layers, cfg.dim
    per_layer = 2 * n_tokens * _attn_proj_params(cfg)
    if cfg.n_experts:
        E, C = cfg.n_experts, moe_capacity(cfg, n_tokens)
        per_layer += 2 * n_tokens * d * E               # router
        per_layer += 3 * 2 * E * C * d * cfg.ffn_dim    # gate, up, down bmm
    else:
        per_layer += 3 * 2 * n_tokens * d * cfg.ffn_dim
    return L * per_layer + 2 * head_rows * d * cfg.vocab_size


def weight_bytes(cfg: Any, bytes_per_param: int) -> int:
    """Bytes of the matmul weights one forward reads (every expert of a
    MoE layer: its ``bmm``s read all of them)."""
    d = cfg.dim
    per_layer = _attn_proj_params(cfg)
    if cfg.n_experts:
        per_layer += d * cfg.n_experts + 3 * cfg.n_experts * d * cfg.ffn_dim
    else:
        per_layer += 3 * d * cfg.ffn_dim
    return (cfg.n_layers * per_layer + d * cfg.vocab_size) * bytes_per_param


def attention_flops(cfg: Any, pairs: int) -> int:
    """QK and PV FLOPs of ``pairs`` query-key pairs in every layer."""
    return 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * pairs


def forward_cost(cfg: Any, *, rows: int, tokens: int, prefix: int = 0,
                 head_rows: int, ragged: bool = False,
                 bytes_per_param: int, kv_bytes_per_token: int
                 ) -> Dict[str, int]:
    """One prefill call: ``rows`` rows of ``tokens`` suffix tokens each
    over ``prefix`` prefix tokens (a ragged wave: one stream of
    ``tokens``, ``rows`` = 1), the LM head at ``head_rows`` rows. Returns
    {gemm_flops, attention_flops, flops, bytes}."""
    n = rows * tokens
    pairs = rows * (prefix * tokens + tokens * (tokens + 1) // 2)
    if ragged:
        pairs = tokens * (tokens + 1) // 2
    gemm = gemm_flops(cfg, n, head_rows)
    attn = attention_flops(cfg, pairs)
    nbytes = (weight_bytes(cfg, bytes_per_param)
              + (rows * prefix + n) * kv_bytes_per_token)
    return {"gemm_flops": gemm, "attention_flops": attn,
            "flops": gemm + attn, "bytes": nbytes}


def decode_chunk_cost(cfg: Any, *, rows: int, steps: int, ctx: int,
                      bytes_per_param: int, kv_bytes_per_token: int
                      ) -> Dict[str, int]:
    """One decode chunk: ``steps`` single-token forwards over ``rows``
    rows, each row attending ``ctx`` keys per step."""
    gemm = steps * gemm_flops(cfg, rows, rows)
    attn = steps * attention_flops(cfg, rows * ctx)
    nbytes = steps * (weight_bytes(cfg, bytes_per_param)
                      + rows * (ctx + 1) * kv_bytes_per_token)
    return {"gemm_flops": gemm, "attention_flops": attn,
            "flops": gemm + attn, "bytes": nbytes}
