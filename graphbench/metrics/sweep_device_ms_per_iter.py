"""sweep_device_ms_per_iter: device ms launched inside the program's
``repro.program.iter`` ranges over the count of those ranges, the
fixpoint's iterations (layer ``core/engine.py`` sweeps; from
:mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    row = (progtrace.ranges_of(rec) or {}).get("program.iter")
    if not row or not row["count"]:
        return None
    return row["device_ms"] / row["count"]
