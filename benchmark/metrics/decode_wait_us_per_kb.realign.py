"""The main thread's wait on the BAM decoder (``engine/bam_stream.py``,
``native/``), µs a kb of aligned read written, from the
``NPORE_TIMING=1`` line."""
from benchmark import printed


def read(run):
    return printed.timing_us_per_kb(run, "decode_wait")
