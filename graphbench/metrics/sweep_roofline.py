"""sweep_roofline: the PageRank jobs' least time at the card's memory
peak over their device time, in %.

Numerator: iterations x ``peaks.sweep_seconds(live edges, vertices)``
(8 B an edge, 8 B a vertex, each iteration).  Denominator: the seconds of
every device operation inside the jobs' spans, from the device trace.
Only the PageRank jobs count: every iteration of a dense sweep needs every
edge and every vertex value, so the bytes are a lower bound whatever
implements it."""
from graphbench import peaks


def read(rec):
    t = rec.get("trace")
    iters = sum(i for n, i in zip(rec["job_names"], rec["iterations"])
                if n == "pagerank")
    dev_s = t["device_s_in"].get("job.pagerank", 0.0) if t else 0.0
    if not iters or dev_s <= 0:
        return None
    least = iters * peaks.sweep_seconds(rec["live_edges"], rec["vertices"])
    return 100.0 * least / dev_s
