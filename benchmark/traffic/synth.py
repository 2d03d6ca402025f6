"""Seeded contigs: a frozen copy of the port's ``testing/synth.py``
(``genome_with_runs``, ``make_ref``)."""
from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def bases(rng, k: int) -> str:
    return _BASES[rng.integers(0, 4, k)].tobytes().decode("ascii")


def make_ref(rng, length: int = 1000) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, length))


def genome_with_runs(rng, n_bases: int):
    """Random sequence with an n-polymer run (period 1-6, 3-20 units)
    after every 60-239 random bases, and the runs as (start, period,
    units) rows."""
    chunks, runs = [], []
    total = 0
    while total < n_bases:
        k = int(rng.integers(60, 240))
        chunks.append(bases(rng, k))
        total += k
        period = int(rng.integers(1, 7))
        unit = bases(rng, period)
        reps = int(rng.integers(3, 21))
        chunks.append(unit * reps)
        runs.append((total, period, reps))
        total += period * reps
    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 3)
    return "".join(chunks)[:n_bases], runs[runs[:, 0] < n_bases]
