"""ttft_p95_s (serving service): nearest-rank p95 over every request of
the window of its send (the benchmark's clock at ``send_message``) to its
first token (the benchmark's listener on the generation); a reply that
never came counts as late as the drain waited. A tail of a saturated
closed loop: read, not bounded. Moves ``output_tokens_per_s``."""

from swarmbench.view import agent_view


def read(run):
    return agent_view(run)["ttft_p95_s"] if run.reqs else None
