"""prefill_attn_roofline (kernels): the least time the card needs for the
prefill attention of the new prompt tokens of the requests whose first
token came in the profiled interval (each new query against the keys at
and before it; Q, K and V read once, O written once) over the device
time of the prefill attention kernels (``kernels/prefill_attn/*.txt``)
there, in %. Moves ``output_tokens_per_s``."""

from swarmbench import spec
from swarmbench import yardstick as ys


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = t.kernel_seconds(spec.kernel_names("prefill_attn"))
    lo, hi = t.host
    flops = nbytes = 0.0
    for r in run.traced:
        times = run.token_times(r)
        if not times or not ys.inside(times[0], lo, hi):
            continue
        f, b = run.work(r).prefill_attn(run.d)
        flops += f
        nbytes += b
    if device_s <= 0 or flops <= 0:
        return None
    least, bound = ys.least_seconds(flops, nbytes)
    return {"value": 100.0 * least / device_s, "bound": bound}
