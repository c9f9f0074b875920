"""upsert_device_ms_per_batch: device ms launched inside the program's
``repro.flush.upsert`` ranges (their children included) over the window's
batches (layer ``core/updates.py`` upsert; from
:mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    return progtrace.per(rec, "flush.upsert", "device_ms", "service.flush",
                         "rounds")
