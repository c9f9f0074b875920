"""update_rate: updates made visible in the window over its seconds (the
window's wall time less the feed's between rounds, when only the harness
runs)."""


def read(rec):
    if not rec["rounds"]:
        return None
    return rec["updates"] / rec["window_s"]
