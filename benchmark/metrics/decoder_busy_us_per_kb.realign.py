"""The BAM decoder's own busy time (the producer thread's
``pipeline.decode`` spans, each building a batch's records), µs a kb of
aligned read written: set beside ``decode_wait_us_per_kb.realign``, the
main thread's wait on it."""
from benchmark import spans


def read(run):
    return spans.span_us_per_kb(run, "pipeline.decode")
