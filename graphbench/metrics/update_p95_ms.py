"""update_p95_ms: p95 over the window's batches of a batch's time from
``apply`` to ``flush`` returning, synchronised."""
from graphbench.metrics._common import p95


def read(rec):
    v = p95(rec["update_s"])
    return None if v is None else v * 1e3
