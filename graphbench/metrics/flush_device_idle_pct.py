"""flush_device_idle_pct: the card's idle time inside the program's
``repro.service.flush`` ranges over their summed length, in % (layer
``stream/service.py`` flush; from :mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    row = (progtrace.ranges_of(rec) or {}).get("service.flush")
    if not row or row["host_ms"] <= 0:
        return None
    return 100.0 * row["idle_ms"] / row["host_ms"]
