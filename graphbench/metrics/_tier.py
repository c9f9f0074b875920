"""Helpers of the tier-move readers (not a metric: no ``read``)."""
from graphbench import progtrace

# the ranges the tier moves make; a program without them (one that moves
# vertices between the tiers by rebuilding the store) has none to read
MOVES = ("tier.unseal", "tier.seal", "tier.run_sweep")


def ranges(rec):
    """The program's ranges of a traced run, or None where the program
    makes none of the tier moves' ranges."""
    rows = progtrace.ranges_of(rec)
    if not rows or not any(name in rows for name in MOVES):
        return None
    return rows
