"""The share of the realign stage (the spans ``realign.stage``) in which
the engine had no group submitted and not yet collected, from the
``engine.submit`` and ``engine.collect`` spans of each group
(``spans.starved_ns``)."""
from benchmark import spans


def read(run):
    got = spans.in_window(run)
    if got is None:
        return None
    stage, starved = spans.starved_ns(got[0])
    return 100 * starved / stage if stage else None
