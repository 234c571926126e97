"""device_idle_share (device): the share of the profiled interval in
which no operation ran on the card, in %. Moves
``output_tokens_per_s``."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
