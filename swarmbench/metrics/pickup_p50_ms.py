"""pickup_p50_ms (runtime and broker): median over the window's requests
of the runtime's ``enqueued`` stamp (``send_message``) to the serving
service's ``admitted`` stamp (its consumer took the message and builds the
prompt). Moves ``output_tokens_per_s``
(through ``ttft_p95_s``)."""

from swarmbench.yardstick import median


def read(run):
    v = [(r.stamps["admitted"] - r.stamps["enqueued"]) * 1e3
         for r in run.reqs
         if "admitted" in r.stamps and "enqueued" in r.stamps]
    return median(v) if v else None
