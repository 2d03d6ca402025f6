"""The realign CLI's region count (the span ``realign.region_count``:
the BAM opened and its records counted a contig, ``engine/regions.py``),
µs a kb of aligned read written."""
from benchmark import spans


def read(run):
    return spans.span_us_per_kb(run, "realign.region_count")
