"""The main thread's SAM formatting and writing (the span
``realign.sam_write``, one a batch), µs a kb of aligned read written."""
from benchmark import spans


def read(run):
    return spans.span_us_per_kb(run, "realign.sam_write")
