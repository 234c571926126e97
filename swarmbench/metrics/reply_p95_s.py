"""reply_p95_s (serving service): p95 over every request of the window of
its send to the moment its agent's ``receive_messages`` returned the
reply; one that never came counts as late as the drain waited. Moves
``output_tokens_per_s``."""

from swarmbench.view import agent_view


def read(run):
    return agent_view(run)["reply_p95_s"] if run.reqs else None
