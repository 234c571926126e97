"""queue_wait_ms (paged admission): the engine's submit-to-admission wait
per admitted request over the window (``phase_us_queue_wait`` over
``engine_admitted``, window deltas). Moves ``output_tokens_per_s``
(through ``ttft_p95_s``)."""

from swarmbench.yardstick import ratio


def read(run):
    c = run.counters
    v = ratio(c["phase_us_queue_wait"] / 1e3, c["engine_admitted"])
    return v
