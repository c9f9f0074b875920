"""plan_build_device_ms_per_job: device ms launched inside the program's
``repro.engine.sweep_plan`` ranges over the window's jobs (layer
``core/engine.py`` sweep plan; from :mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    return progtrace.per(rec, "engine.sweep_plan", "device_ms",
                         "service.analytics", "jobs")
