"""The plain reference: prompts rendered again and logits recomputed.

Written from the published descriptions, not from the program, and it
imports nothing of it:

- ``ByteTokenizer``: UTF-8 bytes shifted by 3, ids 0 / 1 / 2 pad / bos /
  eos (the tokenizer SwarmDB serves with when no vocabulary is given).
- ``render_prompt``: the prompt SwarmDB's serving service builds for a
  message: the two agents' conversation so far, one ``sender: text`` line
  each in send order, then the new message's line and the answering
  agent's cue (a tool call renders ``sender [tool-call]: text`` and cues
  ``receiver [tool-result]:``), joined by newlines, after a bos.
- ``Reference``: the forward pass of Mistral-7B (RMSNorm, grouped-query
  attention with split-half RoPE, SwiGLU) and of Mixtral (the same with a
  dropless top-k routed MoE: softmax over the chosen experts' router
  logits), in float32 with TF32 off, over the bf16 weights as drawn.
  With ``precision="fp8"`` every linear layer multiplies e4m3 copies of
  its operands (per-row activation and per-column weight scales): the
  control the comparison must fail.

A served request is judged by teacher forcing: the reference runs once
over the prompt and the served tokens, and each served token's gap is the
distance from the reference's best logit at that position down to the
served token's logit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .weights import Dims

#: Queries per block of the reference's attention (bounds its scores).
ATTN_BLOCK = 1024


class ByteTokenizer:
    pad_id, bos_id, eos_id = 0, 1, 2
    offset = 3

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [b + self.offset for b in text.encode("utf-8")]
        return [self.bos_id] + ids if bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self.offset for i in ids
                     if self.offset <= i < 256 + self.offset)
        return data.decode("utf-8", "replace")


TOKENIZER = ByteTokenizer()


def render_prompt(history: Sequence[Tuple[str, str]], kind: str,
                  sender: str, receiver: str, text: str) -> List[int]:
    """Token ids of the prompt for a message ``text`` from ``sender`` to
    ``receiver`` after ``history`` ((sender, text) of each earlier message
    of the pair, in send order). ``kind`` is ``chat`` or
    ``function_call``."""
    lines = [f"{s}: {t}" for s, t in history]
    if kind == "function_call":
        lines += [f"{sender} [tool-call]: {text}",
                  f"{receiver} [tool-result]:"]
    else:
        lines += [f"{sender}: {text}", f"{receiver}:"]
    return TOKENIZER.encode("\n".join(lines))


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 while the reference runs."""
    cuda_mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_mm
        torch.backends.cudnn.allow_tf32 = cudnn


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (its amax maps to 448, e4m3's largest)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The forward pass over ``weights`` (the dict ``weights.draw``
    makes), in float32 or in the fp8 control's precision."""

    def __init__(self, d: Dims, weights: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.d, self.w, self.precision = d, weights, precision

    # ------------------------------------------------------------ pieces

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [N, in] float32 times the stored weight w [in, out]."""
        w = w.float()
        if self.precision == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.d.eps)
        return x * inv * g.float()

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Split-half rotary embedding of x [T, H, hd] at positions [T]."""
        hd = x.shape[-1]
        inv = 1.0 / (self.d.theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal grouped-query attention, q [T, Hq, hd], k / v [T, Hkv,
        hd] -> [T, Hq * hd], in blocks of queries."""
        T, Hq, hd = q.shape
        rep = Hq // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [Hq, T, hd]
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        qh = q.transpose(0, 1)
        out = torch.empty_like(qh)
        keys = torch.arange(T, device=q.device)
        for a in range(0, T, ATTN_BLOCK):
            b = min(T, a + ATTN_BLOCK)
            s = (qh[:, a:b] @ k[:, :b].transpose(1, 2)) / math.sqrt(hd)
            allowed = keys[None, :b] <= keys[a:b, None]
            if self.d.window:
                allowed &= keys[None, :b] > keys[a:b, None] - self.d.window
            s = s.masked_fill(~allowed, float("-inf"))
            out[:, a:b] = torch.softmax(s, -1) @ v[:, :b]
        return out.transpose(0, 1).reshape(T, Hq * hd)

    def _ffn(self, h: torch.Tensor, lw: Dict, l: int) -> torch.Tensor:
        if not self.d.moe:
            return self._mm(F.silu(self._mm(h, lw["w_gate"][l]))
                            * self._mm(h, lw["w_up"][l]), lw["w_down"][l])
        logits = h @ lw["router"][l].float()
        top, idx = torch.topk(logits, self.d.top_k, dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(h)
        for e in range(self.d.experts):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            x = h[rows]
            y = self._mm(F.silu(self._mm(x, lw["w_gate"][l, e]))
                         * self._mm(x, lw["w_up"][l, e]), lw["w_down"][l, e])
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
        return out

    # ----------------------------------------------------------- forward

    @torch.no_grad()
    def logits(self, tokens: Sequence[int], first: int) -> torch.Tensor:
        """float32 logits [len(tokens) - first, V] of the positions
        ``first ..`` of one sequence, attending causally from position 0."""
        d, w = self.d, self.w
        dev = w["embed"].device
        ids = torch.tensor(list(tokens), dtype=torch.long, device=dev)
        pos = torch.arange(len(ids), device=dev)
        T, hd = len(ids), d.head_dim
        lw = w["layers"]
        with exact_float32():
            x = w["embed"][ids].float()
            for l in range(d.layers):
                h = self._norm(x, lw["attn_norm"][l])
                q = self._rope(self._mm(h, lw["wq"][l]).view(T, d.heads, hd),
                               pos)
                k = self._rope(
                    self._mm(h, lw["wk"][l]).view(T, d.kv_heads, hd), pos)
                v = self._mm(h, lw["wv"][l]).view(T, d.kv_heads, hd)
                x = x + self._mm(self._attention(q, k, v), lw["wo"][l])
                x = x + self._ffn(self._norm(x, lw["mlp_norm"][l]), lw, l)
            x = self._norm(x[first:], w["final_norm"])
            return self._mm(x, w["lm_head"])


def served_gaps(ref: Reference, prompt: Sequence[int],
                served: Sequence[int],
                control: Optional[Reference] = None
                ) -> Tuple[float, Optional[float]]:
    """(the widest gap of a served token below the reference's best
    logit, and with ``control`` the widest gap of the token the control
    puts first at each of the same positions), over one request's served
    tokens (an eos that ended it included)."""
    if not served:
        return 0.0, (0.0 if control is not None else None)
    seq = list(prompt) + list(served[:-1])
    first = len(prompt) - 1
    lg = ref.logits(seq, first)
    tgt = torch.tensor(list(served), device=lg.device)
    best = lg.max(-1).values
    gap = float((best - lg.gather(1, tgt[:, None])[:, 0]).max())
    if control is None:
        return gap, None
    pick = control.logits(seq, first).argmax(-1)
    cgap = float((best - lg.gather(1, pick[:, None])[:, 0]).max())
    return gap, cgap
