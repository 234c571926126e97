"""decode_chunk_ms (decode loop): the engine's wall time per decode chunk
in the window (``phase_us_decode`` over ``engine_decode_chunks``). Moves ``output_tokens_per_s``
(through ``tpot_p95_ms``)."""

from swarmbench.yardstick import ratio


def read(run):
    c = run.counters
    return ratio(c["phase_us_decode"] / 1e3, c["engine_decode_chunks"])
