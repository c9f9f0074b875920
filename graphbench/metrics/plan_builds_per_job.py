"""plan_builds_per_job: ``backend.PLAN_BUILDS`` over the window's jobs
(layer ``core/engine.py`` sweep plan)."""


def read(rec):
    if not rec["jobs"]:
        return None
    return rec["counters"]["plan_builds"] / rec["jobs"]
