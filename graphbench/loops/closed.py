"""closed: one writer submits the next batch once the last is visible, as
an ingest pipeline does.  Round ``j`` applies batch ``j``, flushes, and,
where the mix names jobs, runs job ``j mod len(jobs)`` of the rotation on
the new epoch; the next round starts once its result is ready."""
import time


def round(drv, j: int, batch) -> None:
    src, dst, w, op = batch
    d = drv.stream.d
    t0 = time.perf_counter()
    with drv.spans("apply"):
        drv.svc.apply(src, dst, w, op)
    with drv.spans("flush"):
        report = drv.svc.flush()
    drv.update_s.append(time.perf_counter() - t0)
    if report.applied_inserts != d or report.applied_deletes != d:
        drv.failed += 1
    if drv.jobs:
        name, kw = drv.jobs[j % len(drv.jobs)]
        with drv.spans(f"job.{name}"):
            out = drv.svc.analytics(name, **kw)
        drv.refresh_s.append(time.perf_counter() - t0)
        drv.job_names.append(name)
        drv.iterations.append(int(drv.svc.last_iterations))
        drv.last[name] = (j + 1, kw, out)
