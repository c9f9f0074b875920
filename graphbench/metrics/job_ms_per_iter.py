"""job_ms_per_iter: the benchmark's spans around ``analytics`` over the
jobs' iterations, in ms (layer ``core/engine.py`` sweeps)."""


def read(rec):
    iters = sum(rec["iterations"])
    secs = sum(sum(v) for k, v in rec["spans"].items()
               if k.startswith("job."))
    return 1e3 * secs / iters if iters else None
