"""Helpers the metric readers share (not a metric: no ``read``)."""
import statistics


def p95(xs):
    """The 95th percentile (inclusive interpolation), None under 2."""
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18]


def idle_pct(rec):
    """The card's idle share of the traced window, in %."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
