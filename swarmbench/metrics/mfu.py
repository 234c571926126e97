"""mfu (model): the FLOPs the traffic needed in the profiled interval
over the interval's seconds times the card's bf16 peak, in %. A request's
prefill (its new prompt tokens: those not in the conversation's previous
prompt and reply) counts when its first token came, each later served
token when it came (the benchmark's token listener). A token costs 2 x
the active parameters (Mixtral: the router and top-k of its experts) plus
causal attention at its position. Moves ``output_tokens_per_s``."""

from swarmbench import yardstick as ys


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.host
    flops = 0.0
    for r in run.traced:
        times = run.token_times(r)
        if not times:
            continue
        w = run.work(r)
        if ys.inside(times[0], lo, hi):
            flops += w.prefill_flops(run.d)
        for j in range(1, len(times)):
            if ys.inside(times[j], lo, hi):
                flops += w.decode_flops(run.d, j)
    return 100.0 * flops / ((hi - lo) * ys.PEAK_BF16_FLOPS)
