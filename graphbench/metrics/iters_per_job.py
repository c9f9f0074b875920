"""iters_per_job: mean of ``GraphService.last_iterations`` over the
window's jobs (layer ``core/program.py`` executor)."""


def read(rec):
    xs = rec["iterations"]
    return sum(xs) / len(xs) if xs else None
