"""run_sweep_device_ms_per_iter: device ms launched inside the program's
``repro.tier.run_sweep`` ranges (the sealed run's part of a sweep) over
the ``repro.program.iter`` ranges, the fixpoints' iterations (layer
``core/csr.py`` run sweeps; from :mod:`graphbench.progtrace`).  None where
the program makes no tier move ranges."""
from graphbench.metrics import _tier


def read(rec):
    rows = _tier.ranges(rec)
    it = (rows or {}).get("program.iter")
    if not it or not it["count"]:
        return None
    return rows.get("tier.run_sweep", {}).get("device_ms", 0.0) / it["count"]
