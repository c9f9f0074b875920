"""device_idle_pct.update: the card's idle share of the traced window, in %
(busy: union of kernels, copies and fills in the profiler's trace)."""
from graphbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
