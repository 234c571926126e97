"""Model family configurations.

The registry the serving path builds from: Llama-3-8B, Llama-3-70B,
Mixtral-8x7B and small debug configs. A copy of the JAX package's registry;
architecture constants follow the public model cards.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # MoE (Mixtral-style); n_experts=0 => dense FFN
    n_experts: int = 0
    experts_per_token: int = 2
    # Mistral-style sliding-window attention; None = full causal.
    # (Mixtral-8x7B's official config disables it — null — so the
    # registry entry keeps None; the plumbing exists for windowed configs.)
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    vocab_size=128_256,
    dim=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    ffn_dim=14_336,
    rope_theta=500_000.0,
)

LLAMA3_70B = ModelConfig(
    name="llama3-70b",
    vocab_size=128_256,
    dim=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    ffn_dim=28_672,
    rope_theta=500_000.0,
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32_000,
    dim=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    ffn_dim=14_336,
    norm_eps=1e-5,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    n_experts=8,
    experts_per_token=2,
)

# Small configs for tests / CPU drives / the single-chip bench.
TINY_DEBUG = ModelConfig(
    name="tiny-debug",
    vocab_size=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    ffn_dim=128,
    max_seq_len=256,
    rope_theta=10_000.0,
)

TINY_MOE = ModelConfig(
    name="tiny-moe",
    vocab_size=512,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    ffn_dim=128,
    max_seq_len=256,
    rope_theta=10_000.0,
    n_experts=4,
    experts_per_token=2,
)

# ~1B-class config for meaningful single-chip benchmarking without 8B HBM cost.
LLAMA_1B_BENCH = ModelConfig(
    name="llama-1b-bench",
    vocab_size=32_000,
    dim=2048,
    n_layers=16,
    n_heads=16,
    n_kv_heads=8,
    ffn_dim=5632,
    max_seq_len=4096,
    rope_theta=500_000.0,
)

REGISTRY = {
    c.name: c
    for c in (LLAMA3_8B, LLAMA3_70B, MIXTRAL_8X7B, TINY_DEBUG, TINY_MOE, LLAMA_1B_BENCH)
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}")
    cfg = REGISTRY[name]
    return replace(cfg, **overrides) if overrides else cfg
