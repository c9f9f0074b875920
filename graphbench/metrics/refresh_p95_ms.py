"""refresh_p95_ms: p95 over the window's refreshes of the time from a
batch's ``apply`` to its job's result ready, synchronised."""
from graphbench.metrics._common import p95


def read(rec):
    v = p95(rec["refresh_s"])
    return None if v is None else v * 1e3
