"""Peaks, percentiles and the work a request needs.

Work is counted from the traffic alone (prompt lengths, what each prompt
shares with its conversation's previous prompt and reply, tokens served)
and from the configuration's sizes, never from the program's counters.
Causal attention counts each query against the keys at and before it.
A byte is counted once: a decode step reads its context's K and V once.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

from .weights import Dims, active_params

#: NVIDIA H100 SXM, data sheet, dense: bf16 tensor-core FLOP/s and HBM3
#: bytes/s. The card's power limit is printed beside every run.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: bytes of one bf16 element of the served K/V, activations and weights
BF16 = 2


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile ``p`` (0-100) over every value."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


def median(values: Sequence[float]) -> float:
    return statistics.median(values)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (``statistics.quantiles``'
    default method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def attn_flops(d: Dims, keys: int) -> float:
    """Attention FLOPs of one query over ``keys`` keys in every layer:
    its scores and its weighted sum."""
    return 4.0 * d.heads * d.head_dim * keys * d.layers


@dataclass
class Work:
    """What one request needs of the model: prefill of its new prompt
    tokens (positions ``reused ..`` of a ``prompt``-token prompt) and
    ``served`` generated tokens."""

    prompt: int
    reused: int
    served: int

    def prefill_flops(self, d: Dims) -> float:
        p = active_params(d)
        new = self.prompt - self.reused
        keys = sum(range(self.reused + 1, self.prompt + 1))
        return (2.0 * p["body"] * new + 4.0 * d.heads * d.head_dim
                * d.layers * keys + 2.0 * p["head"])

    def decode_flops(self, d: Dims, j: int) -> float:
        """Served token j (1 ..) comes from a step over position
        ``prompt + j - 1``: the body, its attention and the head."""
        p = active_params(d)
        return (2.0 * (p["body"] + p["head"])
                + attn_flops(d, self.prompt + j))

    def decode_attn(self, d: Dims, j: int) -> Tuple[float, float]:
        """(FLOPs, bytes) of served token j's step's attention: its query
        against ``prompt + j`` keys, each key's K and V read once."""
        keys = self.prompt + j
        return (attn_flops(d, keys),
                keys * d.layers * 2 * d.kv_heads * d.head_dim * BF16)

    def prefill_attn(self, d: Dims) -> Tuple[float, float]:
        """(FLOPs, bytes) of the prefill attention of the new tokens: each
        new query against the keys at and before it; Q read, O written,
        each key's K and V read once."""
        new = self.prompt - self.reused
        keys = sum(range(self.reused + 1, self.prompt + 1))
        per_layer = (2 * new * d.heads * d.head_dim
                     + 2 * self.prompt * d.kv_heads * d.head_dim) * BF16
        return 4.0 * d.heads * d.head_dim * d.layers * keys, \
            per_layer * d.layers


def least_seconds(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card needs and what bounds it."""
    tf, tb = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (tf, "flops") if tf >= tb else (tb, "bytes")


def token_times(first: float, done: float, served: int) -> List[float]:
    """When each served token j = 0 .. served - 1 came: the first at
    ``first``, the rest evenly up to ``done``."""
    if served <= 1:
        return [first] * served
    step = (done - first) / (served - 1)
    return [first + j * step for j in range(served)]


def inside(t: float, lo: float, hi: float) -> bool:
    return lo <= t < hi


def count_in(times: Iterable[float], lo: float, hi: float) -> int:
    return sum(1 for t in times if lo <= t < hi)


def ratio(num: float, den: float) -> Optional[float]:
    return num / den if den > 0 else None
