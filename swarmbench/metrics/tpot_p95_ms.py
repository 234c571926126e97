"""tpot_p95_ms (serving service): p95 over the window's answered requests
of (last token - first token) / (tokens - 1), as the benchmark's listener
heard them: the streaming speed each agent saw. Moves
``output_tokens_per_s``."""

from swarmbench.view import agent_view


def read(run):
    return agent_view(run)["tpot_p95_ms"] if run.reqs else None
