"""refresh_rate: analytics jobs completed on fresh epochs in the window
over its seconds (the window's wall time less the feed's between rounds,
when only the harness runs)."""


def read(rec):
    if not rec["jobs"]:
        return None
    return rec["jobs"] / rec["window_s"]
