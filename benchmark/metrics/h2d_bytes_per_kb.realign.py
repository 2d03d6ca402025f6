"""Bytes the engine copies to the card (the counter
``engine.h2d_bytes``: each group's buffer prefix), a kb of aligned read
written."""
from benchmark import spans


def read(run):
    got, kb = spans.in_window(run), spans.kb_written(run)
    if got is None or not kb or "engine.h2d_bytes" not in got[1]:
        return None
    return got[1]["engine.h2d_bytes"] / kb
