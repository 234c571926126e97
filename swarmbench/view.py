"""What the metrics read of a run, and the agent's view of it.

``RunView`` holds the window's requests, the engine counters' window
deltas, the traced stretch's requests and device trace (a traced run
profiles a stretch after the window, never the window itself) and each
request's work (``yardstick.Work``).
``agent_view`` is what the agents saw over the window: tokens per second
inside it, and the tails of the time to first token, the time per output
token and the reply's arrival, each over every request.
"""

from __future__ import annotations

from typing import Dict, List

from . import yardstick as ys


class RunView:
    """What a per-layer metric reads: the window's requests (``reqs``)
    and engine counter deltas, the traced stretch's requests (``traced``)
    and device trace, and the work counts."""

    def __init__(self, dims, window, stretch=None) -> None:
        self.d = dims
        self.window = window
        self.stretch = stretch
        self.reqs = [r for r in window.requests if r.in_window]
        self.counters = window.counters
        self.trace = stretch.trace if stretch is not None else None
        self.traced = stretch.requests if stretch is not None else []
        self._work = {}
        for r in list(window.requests) + list(self.traced):
            reused = 0
            if r.prev is not None:
                reused = ys.common_prefix(
                    r.prompt, list(r.prev.prompt) + list(r.prev.served or []))
            self._work[r.mid] = ys.Work(prompt=len(r.prompt),
                                        reused=reused, served=r.generated)

    def profiler_effect(self) -> Dict[str, List[float]]:
        """[window, traced stretch] of host-paced numbers: the stretch
        runs under the profiler's recording, the window never does."""
        if self.stretch is None:
            return {}
        side = RunView(self.d, self.stretch)

        def chunk(c):
            return ys.ratio(c["phase_us_decode"] / 1e3,
                            c["engine_decode_chunks"])

        return {"decode_chunk_ms": [chunk(self.counters),
                                    chunk(side.counters)],
                "tpot_p95_ms": [agent_view(self)["tpot_p95_ms"],
                                agent_view(side)["tpot_p95_ms"]]}

    def work(self, r):
        return self._work[r.mid]

    @staticmethod
    def token_times(r) -> List[float]:
        """When each served token reached the benchmark's listener."""
        return r.tok_times or []


def agent_view(view: RunView) -> Dict[str, float]:
    reqs, t0, t1 = view.reqs, view.window.t0, view.window.t1
    end = max([t1] + [r.t_recv for r in reqs if r.t_recv is not None])
    ttft, tpot, reply = [], [], []
    tokens = 0
    for r in reqs:
        times = view.token_times(r)
        # a reply that never came counts as late as the drain waited; one
        # with no token (an eos first) has its first token in the reply
        first = times[0] if times else (r.t_recv or end)
        ttft.append(first - r.t_send)
        reply.append((r.t_recv or end) - r.t_send)
        if len(times) >= 2:
            tpot.append((times[-1] - times[0]) / (len(times) - 1) * 1e3)
        tokens += ys.count_in(times, t0, t1)
    return {
        "output_tokens_per_s": tokens / (t1 - t0),
        "ttft_p95_s": ys.percentile(ttft, 95),
        "tpot_p95_ms": ys.percentile(tpot, 95),
        "reply_p95_s": ys.percentile(reply, 95),
    }
