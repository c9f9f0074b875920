"""setup_s: seconds from the process's start to the window's (loading,
the kernels' build or load, the graph and stream made on the card, the
store built, the warm-up rounds)."""


def read(rec):
    return rec["setup_s"]
