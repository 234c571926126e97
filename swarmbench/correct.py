"""The comparison that decides ``correct``.

Once the window has closed, every reply due has come (or the drain has
given up on it) and the program has been freed, a run is held to these
numbers, each against its limit in ``limits/<workload>.json``:

- ``unanswered``: messages sent in the window whose reply never reached
  their agent (limit 0);
- ``error_replies``: replies that end in an error, not in ``length`` or
  ``eos`` (limit 0);
- ``misdelivered``: replies an agent received that answer no message it
  is waiting on (limit 0);
- ``reply_mismatch``: replies whose text is not the byte decoding of the
  tokens the service generated for them, or whose metadata counts other
  tokens or another finish (limit 0);
- ``stream_mismatch``: replies whose tokens the benchmark's listener on
  the generation did not hear one for one (limit 0);
- ``stamps_out_of_order``: requests whose stage stamps do not run send <=
  enqueued <= admitted <= first token <= done <= receive (limit 0);
- ``max_logit_gap``: over a sample of the window's finished requests
  drawn from the seed, the longest reply among them, the widest distance
  by which a served token's logit lies below the plain reference's best
  at its position; the reference runs once over each prompt, rendered
  again from the benchmark's own record of the session, with its served
  tokens (limit: between the program's largest reading over a dozen seeds
  and the fp8 control's smallest, ``PERF.md``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import torch

from . import weights
from .reference import TOKENIZER, Reference, served_gaps

Checks = Dict[str, Tuple[float, float]]


def answered(r) -> bool:
    return r.t_recv is not None


def finished(r) -> bool:
    """Answered, and ended by its length or an eos."""
    return answered(r) and r.reason in ("length", "eos")


def stamps_ordered(r) -> bool:
    s = r.stamps
    chain = [r.t_send, s.get("enqueued"), s.get("admitted")]
    if "first_token" in s:
        chain.append(s["first_token"])
    chain += [s.get("done"), r.t_recv]
    if any(t is None for t in chain):
        return False
    return all(a <= b for a, b in zip(chain, chain[1:]))


def reply_matches(r) -> bool:
    if r.served is None:
        return False
    m = r.reply_meta
    return (r.reply_text == TOKENIZER.decode(r.served)
            and m.get("completion_tokens") == len(r.served)
            and m.get("finish_reason") == r.reason)


def pick(reqs: Sequence, n: int, tokens: int, seed: int) -> List:
    """The reference's sample: the request with the most generated
    tokens, then first turns and later turns in turn, drawn from the seed,
    until ``n`` requests and ``tokens`` generated tokens are in."""
    done = [r for r in reqs if answered(r) and r.generated > 0]
    if not done:
        return []
    rng = random.Random(seed)
    longest = max(done, key=lambda r: r.generated)
    pools = [[r for r in done if r.turn == 0 and r is not longest],
             [r for r in done if r.turn > 0 and r is not longest]]
    for p in pools:
        rng.shuffle(p)
    chosen, k = [longest], 0
    while (len(chosen) < n or sum(r.generated for r in chosen) < tokens) \
            and any(pools) and len(chosen) < 4 * n:
        p = pools[k % 2] or pools[(k + 1) % 2]
        chosen.append(p.pop())
        k += 1
    return chosen


def structural(window) -> Dict[str, float]:
    reqs = [r for r in window.requests if r.in_window]
    got = [r for r in reqs if answered(r)]
    return {
        "unanswered": float(len(reqs) - len(got)),
        "error_replies": float(sum(not finished(r) for r in got)),
        "misdelivered": float(window.misdelivered),
        "reply_mismatch": float(sum(not reply_matches(r) for r in got)),
        "stream_mismatch": float(sum(
            len(r.tok_times or ()) != len(r.served or ()) for r in got)),
        "stamps_out_of_order": float(sum(not stamps_ordered(r)
                                         for r in got)),
    }


def logit_gaps(d: weights.Dims, seed: int, device, sample: Sequence,
               control: bool = False) -> List[Tuple[float, float]]:
    """(gap, control gap or nan) per sampled request, over weights drawn
    again from the seed."""
    w = weights.draw(d, seed, device)
    ref = Reference(d, w)
    ctl = Reference(d, w, precision="fp8") if control else None
    out = []
    for r in sample:
        g, c = served_gaps(ref, r.prompt, r.checked_tokens(), ctl)
        out.append((g, float("nan") if c is None else c))
    del w, ref, ctl
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Checks:
    return {k: (v, float(limits.get(k, 0.0))) for k, v in values.items()}


def passed(checks: Checks) -> bool:
    return all(v <= lim for v, lim in checks.values())
