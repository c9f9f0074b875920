"""seal_device_ms_per_batch: device ms launched inside the program's
``repro.tier.seal`` ranges (the cold chains' extraction and their merge
into the run) over the window's batches, 0 in a window without a seal
(layer ``core/tiered.py`` tier moves; from :mod:`graphbench.progtrace`).
None where the program makes no tier move ranges."""
from graphbench import progtrace
from graphbench.metrics import _tier


def read(rec):
    if _tier.ranges(rec) is None:
        return None
    return progtrace.per(rec, "tier.seal", "device_ms", "service.flush",
                         "rounds")
