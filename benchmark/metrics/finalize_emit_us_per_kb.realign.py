"""Stage B of ``engine/realigner.py`` (CIGAR finalize and SAM assembly),
µs a kb of aligned read written, from the ``NPORE_TIMING=1`` line."""
from benchmark import printed


def read(run):
    return printed.timing_us_per_kb(run, "finalize_emit")
