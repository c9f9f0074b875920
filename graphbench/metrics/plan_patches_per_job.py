"""plan_patches_per_job: the program's ``repro.engine.plan_patch`` ranges
over the window's jobs (layer ``core/engine.py`` sweep plan; from
:mod:`graphbench.progtrace`): the sweep plans patched from the one kept
across snapshots.  None where the program makes no such range (a program
that builds every plan)."""
from graphbench import progtrace


def read(rec):
    if "engine.plan_patch" not in (progtrace.ranges_of(rec) or {}):
        return None
    return progtrace.per(rec, "engine.plan_patch", "count",
                         "service.analytics", "jobs")
