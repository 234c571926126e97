"""The one traffic generator: closed loops of agent sessions.

A mix file (``mixes/<traffic>.json``) holds only parameters:

- ``agents``: agents at once, each in a closed loop (it sends its next
  message when the reply to the last one has arrived);
- ``assistants``: the served agents the sessions talk to;
- ``kind``: ``chat`` or ``function_call`` messages;
- ``turns``: [lo, hi] messages a session sends before its agent opens a
  new session under a new sender id;
- ``first_tokens``, ``later_tokens``, ``reply_tokens``: {``lo``, ``hi``,
  ``dist``} of the first message's length, each later message's length
  (in byte tokens) and each reply's ``max_new_tokens``; ``dist`` is
  ``uniform``, ``loguniform`` or ``lognormal`` (with ``median`` and
  ``sigma``, the heavy tail cut at ``lo`` and ``hi``);
- ``max_prompt_tokens``: a session ends early rather than send a message
  whose prompt would pass this;
- ``start_spread_s``: the agents' first sends are spread evenly over it;
- ``warmup_agents``, ``warmup_reply_tokens``: the warm-up burst's agents
  (each sends one first message at once) and their ``max_new_tokens``.

Sizes are stratified per block of ``agents`` sessions: each block holds
the same quantiles of every size, and the seed only orders them and
writes the text. So every seed offers the same work in another order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

_ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", dtype=np.uint8)


@dataclass
class Session:
    sender: str
    receiver: str
    kind: str
    lengths: List[int]          # each message's length in byte tokens
    replies: List[int]          # each message's max_new_tokens
    texts: List[str] = field(default_factory=list)


def _values(spec: Dict[str, Any], q: np.ndarray) -> np.ndarray:
    lo, hi = int(spec["lo"]), int(spec["hi"])
    dist = spec.get("dist", "uniform")
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        v = float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
    elif dist == "loguniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        v = lo + q * (hi - lo)
    return np.clip(np.rint(v), lo, hi).astype(int)


class Traffic:
    """Sessions of one mix for one seed; ``stream`` separates independent
    streams of one run (the warm-up burst's from the window's)."""

    def __init__(self, mix: Dict[str, Any], seed: int, stream: int = 0):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed) % (1 << 64), stream])
        self._block: List[Session] = []

    def _text(self, n: int) -> str:
        return _ALPHABET[self.rng.integers(0, len(_ALPHABET), n)
                         ].tobytes().decode("ascii")

    def _new_block(self) -> None:
        m, rng = self.mix, self.rng
        n = int(m["agents"])
        q = (np.arange(n) + 0.5) / n
        lo, hi = (int(x) for x in m["turns"])
        turns = lo + np.minimum((rng.permutation(q) * (hi - lo + 1)
                                 ).astype(int), hi - lo)
        first = _values(m["first_tokens"], rng.permutation(q))
        later = [_values(m["later_tokens"], rng.permutation(q))
                 for _ in range(hi - 1)]
        reply = [_values(m["reply_tokens"], rng.permutation(q))
                 for _ in range(hi)]
        who = rng.permutation(n) % int(m["assistants"])
        for i in range(n):
            t = int(turns[i])
            tag = rng.integers(0, 1 << 48)
            self._block.append(Session(
                sender=f"{tag:012x}-user",
                receiver=f"assistant-{who[i]}",
                kind=m.get("kind", "chat"),
                lengths=[int(first[i])] + [int(later[j][i])
                                           for j in range(t - 1)],
                replies=[int(reply[j][i]) for j in range(t)]))

    def next_session(self) -> Session:
        """The next session, with its texts written."""
        if not self._block:
            self._new_block()
        s = self._block.pop(0)
        s.texts = [self._text(n) for n in s.lengths]
        return s
