"""unseal_device_ms_per_batch: device ms launched inside the program's
``repro.tier.unseal`` ranges (a write's move of sealed vertices back into
the delta) over the window's batches (layer ``core/tiered.py`` tier moves;
from :mod:`graphbench.progtrace`).  None where the program makes no tier
move ranges."""
from graphbench import progtrace
from graphbench.metrics import _tier


def read(rec):
    if _tier.ranges(rec) is None:
        return None
    return progtrace.per(rec, "tier.unseal", "device_ms", "service.flush",
                         "rounds")
