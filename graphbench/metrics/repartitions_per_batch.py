"""repartitions_per_batch: the program's ``repro.tier.repartition`` ranges
(both tiers read out whole and rebuilt) over the window's batches (layer
``core/tiered.py`` tier moves; from :mod:`graphbench.progtrace`): 0 where
seals and unseals move only what moves."""
from graphbench import progtrace


def read(rec):
    return progtrace.per(rec, "tier.repartition", "count", "service.flush",
                         "rounds")
