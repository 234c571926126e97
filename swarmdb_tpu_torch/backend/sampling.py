"""Token sampling with per-slot parameters and per-slot random streams.

The counterpart of ``swarmdb_tpu/backend/sampling.py``. Every decode step
samples for B slots at once, each slot with its own temperature / top-k /
top-p and its own key; greedy rows (temperature 0) take the argmax.

Randomness reproduces ``jax.random`` bit for bit, so a request with
``generation.seed`` gets the same tokens from both packages: the key of a
slot is two uint32 words (the explicit generator state), the key of a step
is ``fold_in(key, position)``, and a draw is the Gumbel-max of
``jax.random.categorical``, all on the Threefry-2x32 hash written here in
integer tensor ops. The bit layout is the one ``jax.random`` uses with
``jax_threefry_partitionable=True`` (its default): the random bits of
element i of a draw of n elements are ``x0 ^ x1`` of
``threefry2x32(key, (i >> 32, i & 0xffffffff))``. uint32 words are held in
int64 tensors and masked after every add and shift.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request knobs. temperature=0 means greedy (argmax).

    ``stop`` is host-side: the serving layer watches decoded text, cancels
    the engine request at the first match and truncates the reply."""

    temperature: float = 0.0
    top_k: int = 0        # 0 = disabled
    top_p: float = 1.0    # 1.0 = disabled
    max_new_tokens: int = 128
    stop: tuple = ()      # stop strings (each ends generation when seen)
    seed: "int | None" = None  # per-request PRNG seed (None = engine default)


# ------------------------------------------------------------- threefry


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on uint32 words held in int64 tensors;
    all four operands broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys [..., 2] (uint32 words in
    int64), data [...] non-negative ints below 2**32 -> new keys."""
    zero = torch.zeros_like(data, dtype=torch.int64)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], zero,
                          data.to(torch.int64) & _M32)
    return torch.stack([y0, y1], dim=-1)


def key_from_seed(seed: int) -> Tuple[int, int]:
    """The two key words of ``jax.random.PRNGKey(seed)`` (a 64-bit seed
    split high/low; seeds below 2**32 give (0, seed))."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32, s & _M32)


def make_slot_keys(seed: int, batch: int) -> np.ndarray:
    """[B, 2] uint32 base keys, ``fold_in(PRNGKey(seed), i)`` for slot i."""
    base = torch.tensor(key_from_seed(seed), dtype=torch.int64)
    keys = fold_in(base.expand(batch, 2), torch.arange(batch))
    return keys.numpy().astype(np.uint32)


def _random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] uint32 draws (in int64) of ``jax.random.bits`` per key row."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & _M32)
    return y0 ^ y1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] fp32 standard Gumbel noise of ``jax.random.gumbel`` (its
    default low-range mode): -log(-log(u)), u uniform in [tiny, 1)."""
    bits = _random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # f * (maxval - minval) + minval with maxval - minval == 1.0 in fp32
    u = torch.clamp(f + _F32_TINY, min=_F32_TINY)
    return -torch.log(-torch.log(u))


# -------------------------------------------------------------- sampling


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log P(token) under the RAW model distribution (before temperature /
    filtering). [B, V], [B] -> [B] fp32."""
    ls = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(ls, 1, tokens.long()[:, None])[:, 0]


def sample_tokens(
    logits: torch.Tensor,       # [B, V] fp32
    base_keys: torch.Tensor,    # [B, 2] per-slot keys (uint32 words, int64)
    positions: torch.Tensor,    # [B] current position (the fold value)
    temperature: torch.Tensor,  # [B] fp32; 0 => greedy
    top_k: torch.Tensor,        # [B] int; 0 => off
    top_p: torch.Tensor,        # [B] fp32; 1.0 => off
    *,
    use_filters: bool = True,
    assume_greedy: bool = False,
) -> torch.Tensor:
    """Sample one token per row; greedy rows take argmax. Filtering:
    temperature-scale -> top-k mask -> top-p (nucleus) mask -> categorical.
    ``use_filters`` / ``assume_greedy`` are the engine's per-chunk
    switches (the host knows every live slot's params). Returns [B]
    int32."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    if assume_greedy:
        return greedy.to(torch.int32)
    temperature = temperature.float()
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    step_keys = fold_in(base_keys.long(), positions)
    if use_filters:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        k_eff = torch.clamp(torch.where(top_k > 0, top_k.long(),
                                        torch.full_like(top_k.long(), V)),
                            1, V)
        kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
        keep_k = scaled >= kth
        probs_sorted = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs_sorted, dim=-1)
        in_nucleus = (cum - probs_sorted) < top_p.float()[:, None]
        in_nucleus[:, 0] = True  # the argmax survives any top_p
        cutoff = torch.amin(torch.where(in_nucleus, sorted_desc,
                                        float("inf")), dim=-1, keepdim=True)
        keep_p = scaled >= cutoff
        scaled = torch.where(keep_k & keep_p, scaled, float("-inf"))
    sampled = torch.argmax(gumbel(step_keys, V) + scaled, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
