"""maint_device_ms_per_batch: device ms launched inside the program's
``repro.maint.apply`` ranges (compactions, rebuilds, grows) over the
window's batches, 0 in a window without one (layer
``stream/maintenance.py`` actions; from :mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    return progtrace.per(rec, "maint.apply", "device_ms", "service.flush",
                         "rounds")
