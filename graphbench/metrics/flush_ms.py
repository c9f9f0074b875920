"""flush_ms: mean ms of the benchmark's ``flush`` span a batch (layer
``stream/service.py`` flush)."""


def read(rec):
    xs = rec["spans"].get("flush", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
