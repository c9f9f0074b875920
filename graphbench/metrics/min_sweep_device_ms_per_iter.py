"""min_sweep_device_ms_per_iter: device ms a sweep of the min-combine jobs
(BFS, SSSP, WCC): the seconds of every device operation inside those jobs'
spans, from the device trace, over the jobs' iterations
(``GraphService.last_iterations``)."""

MIN_JOBS = ("bfs", "sssp", "cc")


def read(rec):
    t = rec.get("trace")
    iters = sum(i for n, i in zip(rec["job_names"], rec["iterations"])
                if n in MIN_JOBS)
    dev_s = sum(t["device_s_in"].get(f"job.{n}", 0.0)
                for n in MIN_JOBS) if t else 0.0
    if not iters or dev_s <= 0:
        return None
    return 1e3 * dev_s / iters
