"""locate_launches_per_batch: ``backend.LAUNCHES["chain_walk_locate"]``
over the window's batches (layer ``core/updates.py`` +
``kernels/chain_walk``)."""


def read(rec):
    if not rec["rounds"]:
        return None
    return rec["counters"]["chain_walk_locate"] / rec["rounds"]
