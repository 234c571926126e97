"""A configuration's sizes and its seeded weights.

``Dims`` reads a configuration file (the model's published ``config.json``
keys, as the files under ``configs/`` hold them). ``draw`` makes the
weights from the run's seed on the device, in the dict layout the program
serves (stacked ``[L, ...]`` per-layer leaves, projections ``[in, out]``),
in a few large in-place draws in the served dtype. The same seed gives the
same weights, so the reference draws them again rather than reading what
the program holds. Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

#: Elements filled by one ``normal_`` call: large enough that a model is a
#: few dozen calls, small enough that no call needs a large scratch.
DRAW_ELEMS = 1 << 28


@dataclass(frozen=True)
class Dims:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    eps: float
    theta: float
    experts: int = 0
    top_k: int = 0
    window: Any = None

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def moe(self) -> bool:
        return self.experts > 0

    @classmethod
    def of(cls, conf: Dict[str, Any]) -> "Dims":
        """The sizes of a configuration file (published key names)."""
        if conf.get("tie_word_embeddings", False):
            raise ValueError("tied embeddings are not drawn by this harness")
        return cls(
            vocab=int(conf["vocab_size"]), hidden=int(conf["hidden_size"]),
            layers=int(conf["num_hidden_layers"]),
            heads=int(conf["num_attention_heads"]),
            kv_heads=int(conf["num_key_value_heads"]),
            ffn=int(conf["intermediate_size"]),
            eps=float(conf["rms_norm_eps"]),
            theta=float(conf["rope_theta"]),
            experts=int(conf.get("num_local_experts", 0)),
            top_k=int(conf.get("num_experts_per_tok", 0)),
            window=conf.get("sliding_window"))


def torch_seed(seed: int) -> int:
    """A run's seed (any whole number) as a generator seed."""
    return int(seed) % (1 << 63)


def draw(d: Dims, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, Any]:
    """Weights from ``seed``: normal(0, 1 / fan_in) matrices, norms at
    one, drawn in place on ``device`` in ``dtype``, always in this order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    L, D, F, E = d.layers, d.hidden, d.ffn, d.experts
    hd = d.head_dim

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(-1, shape[-1])
        step = max(1, DRAW_ELEMS // shape[-1])
        for i in range(0, rows.shape[0], step):
            rows[i:i + step].normal_(0.0, fan_in ** -0.5, generator=gen)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones((L, D)),
        "wq": normal((L, D, d.heads * hd), D),
        "wk": normal((L, D, d.kv_heads * hd), D),
        "wv": normal((L, D, d.kv_heads * hd), D),
        "wo": normal((L, d.heads * hd, D), d.heads * hd),
        "mlp_norm": ones((L, D)),
    }
    if d.moe:
        layers["router"] = normal((L, D, E), D)
        layers["w_gate"] = normal((L, E, D, F), D)
        layers["w_up"] = normal((L, E, D, F), D)
        layers["w_down"] = normal((L, E, F, D), F)
    else:
        layers["w_gate"] = normal((L, D, F), D)
        layers["w_up"] = normal((L, D, F), D)
        layers["w_down"] = normal((L, F, D), F)
    return {
        "embed": normal((d.vocab, D), D),
        "layers": layers,
        "final_norm": ones((D,)),
        "lm_head": normal((D, d.vocab), D),
    }


def active_params(d: Dims) -> Dict[str, int]:
    """Parameters one token runs through, by part: each layer's attention
    projections and its feed-forward (Mixtral: the router and ``top_k`` of
    its experts), and the LM head."""
    hd = d.head_dim
    attn = d.hidden * (d.heads + 2 * d.kv_heads) * hd + d.heads * hd * d.hidden
    expert = 3 * d.hidden * d.ffn
    ffn = (d.hidden * d.experts + d.top_k * expert) if d.moe else expert
    return {"body": d.layers * (attn + ffn), "head": d.hidden * d.vocab}
