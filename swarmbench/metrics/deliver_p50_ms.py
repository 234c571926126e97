"""deliver_p50_ms (reply path): median over the window's answered
requests of the service's ``done`` stamp (the engine finished) to the
moment the agent's ``receive_messages`` returned the reply. Moves ``output_tokens_per_s``
(through ``reply_p95_s``)."""

from swarmbench.yardstick import median


def read(run):
    v = [(r.t_recv - r.stamps["done"]) * 1e3 for r in run.reqs
         if r.t_recv is not None and "done" in r.stamps]
    return median(v) if v else None
