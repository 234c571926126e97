"""decode_attn_roofline (kernels): the least time the card needs for the
decode attention of the tokens served in the profiled interval (each
step's query against its context, each context token's K and V read
once; a token counts when the benchmark's listener heard it) over the
device time of the decode attention kernels
(``kernels/decode_attn/*.txt``) there, in %. Moves
``output_tokens_per_s``."""

from swarmbench import spec
from swarmbench import yardstick as ys


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = t.kernel_seconds(spec.kernel_names("decode_attn"))
    lo, hi = t.host
    flops = nbytes = 0.0
    for r in run.traced:
        times = run.token_times(r)
        w = run.work(r)
        for j in range(1, len(times)):
            if ys.inside(times[j], lo, hi):
                f, b = w.decode_attn(run.d, j)
                flops += f
                nbytes += b
    if device_s <= 0 or flops <= 0:
        return None
    least, bound = ys.least_seconds(flops, nbytes)
    return {"value": 100.0 * least / device_s, "bound": bound}
