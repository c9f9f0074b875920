"""flush_host_syncs_per_batch: the host's synchronisations with the card
issued inside the program's ``repro.service.flush`` ranges over the
window's batches (layer ``stream/service.py`` flush; from
:mod:`graphbench.progtrace`)."""
from graphbench import progtrace


def read(rec):
    return progtrace.per(rec, "service.flush", "syncs", "service.flush",
                         "rounds")
