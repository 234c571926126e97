"""prefix_hit_share (paged admission): prompt tokens served from the
prefix cache over prompt tokens admitted in the window
(``prefix_reused_tokens`` over ``prompt_tokens``), in %. Moves ``output_tokens_per_s``
(through ``ttft_p95_s``)."""

from swarmbench.yardstick import ratio


def read(run):
    c = run.counters
    v = ratio(c["prefix_reused_tokens"], c["prompt_tokens"])
    return None if v is None else 100.0 * v
