"""host_sync_share (decode loop): the time the engine's host blocked on
the card over its decode time in the window (``phase_us_host_sync`` over
``phase_us_decode``), in %. Moves ``output_tokens_per_s``
(through ``tpot_p95_ms``)."""

from swarmbench.yardstick import ratio


def read(run):
    c = run.counters
    v = ratio(c["phase_us_host_sync"], c["phase_us_decode"])
    return None if v is None else 100.0 * v
