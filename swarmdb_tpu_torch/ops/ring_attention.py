"""Ring attention: causal attention with K/V split over a mesh axis.

The counterpart of ``swarmdb_tpu/ops/ring_attention.py``. A prompt longer
than one device's budget is split over an axis of ranks: each rank holds
one Q/K/V chunk, and the K/V chunks rotate around the ring
(``parallel.collectives.Axis.shift``, the JAX package's ``lax.ppermute``)
while attention accumulates online (flash-style running max and
denominator), so no rank ever holds the full [T, T] scores or the full
K/V. Each rank calls ``ring_attention`` with its own chunk; every rank of
the axis must call it together.

Causality is by global position: each chunk carries its absolute
positions, so the mask is exact however the chunks are laid out.

The JAX package computes this with XLA einsums and no Pallas kernel; so
does the port, with plain PyTorch products (no library attention): the
operands multiply in their own dtype and sum in fp32, the softmax state
is fp32 throughout, and the output comes back in q's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ring_attention"]


def _block_attend(
    q: torch.Tensor,        # [B, Tq, Hq, D]
    k: torch.Tensor,        # [B, Tk, Hkv, D]
    v: torch.Tensor,        # [B, Tk, Hkv, D]
    q_pos: torch.Tensor,    # [B, Tq]
    kv_pos: torch.Tensor,   # [B, Tk]
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block of masked attention: (weighted values ``o`` [B, Hkv, G,
    Tq, D], the exp-sum ``l`` and the running max ``m`` [B, Hkv, G, Tq],
    -inf where no key of the block is visible) for online-softmax
    merging, all fp32."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(D)))
    visible = kv_pos[:, None, :] <= q_pos[:, :, None]          # [B, Tq, Tk]
    if window is not None:
        visible &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    mask = visible[:, None, None]                               # [B,1,1,Tq,Tk]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(-1)                                         # [B,Hkv,G,Tq]
    # fully masked rows (no visible key in this block) give no NaN
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(-1)
    # the weights enter the value product in v's dtype, as in the JAX
    # package's einsum (bf16 operands, fp32 sums)
    o = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).float(), v.float())
    return o, l, torch.where(finite, m, torch.full_like(m, float("-inf")))


def _merge(acc, block):
    """Two online-softmax states as one."""
    o, l, m = acc
    o_b, l_b, m_b = block
    m_new = torch.maximum(m, m_b)
    m_new_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
    zero = torch.zeros_like(m)
    s_old = torch.where(torch.isfinite(m), torch.exp(m - m_new_safe), zero)
    s_blk = torch.where(torch.isfinite(m_b), torch.exp(m_b - m_new_safe),
                        zero)
    return (o * s_old[..., None] + o_b * s_blk[..., None],
            l * s_old + l_b * s_blk, m_new)


def ring_attention(
    q: torch.Tensor,        # [B, Tq, Hq, D] this rank's query chunk
    k: torch.Tensor,        # [B, Tk, Hkv, D] this rank's key chunk
    v: torch.Tensor,        # [B, Tk, Hkv, D] this rank's value chunk
    q_pos: torch.Tensor,    # [B, Tq] global positions of the queries
    kv_pos: torch.Tensor,   # [B, Tk] global positions of the keys
    axis,                   # parallel.collectives.Axis: the ring
    window: Optional[int] = None,   # sliding window (None: full causal)
) -> torch.Tensor:
    """Causal GQA attention across the ring of ``axis``'s ranks: this
    rank's chunk first, then each other rank's as it arrives (size - 1
    rotations; the last block is attended without one, since a last
    rotation would only bring the chunks home). Returns [B, Tq, Hq, D] in
    q's dtype."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    dev = q.device
    acc = (torch.zeros((B, Hkv, G, Tq, D), dtype=torch.float32, device=dev),
           torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=dev),
           torch.full((B, Hkv, G, Tq), float("-inf"), dtype=torch.float32,
                      device=dev))
    k_cur, v_cur, pos_cur = k, v, kv_pos
    for _ in range(axis.size - 1):
        acc = _merge(acc, _block_attend(q, k_cur, v_cur, q_pos, pos_cur,
                                        window))
        k_cur = axis.shift(k_cur)
        v_cur = axis.shift(v_cur)
        pos_cur = axis.shift(pos_cur)
    o, l, _ = _merge(acc, _block_attend(q, k_cur, v_cur, q_pos, pos_cur,
                                        window))
    out = o / torch.clamp(l, min=1e-30)[..., None]              # [B,Hkv,G,Tq,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D)
    return out.to(q.dtype)
