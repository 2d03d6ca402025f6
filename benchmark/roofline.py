"""The least time the banded DP could take on one H100 for an input, from
the input alone: no window, group or plane of the program enters the
count, so it reads the same whatever implements the DP.

Work: an alignment of a reference span of ``ref`` bases and a query of
``qry`` bases has ``ref + qry + 1`` anti-diagonal rows of a band of
``2r + 1`` cells. A cell of the recurrence (``reference/dp.py``, src/
aln.pyx:524-667) takes these float32 operations: INS and DEL each two adds
and a compare; LEN and SHR for each of the ``max_n`` periods an add and a
compare; MAT an add and four compares. Bytes: the bases read once, the
score tables read once a call, and the CIGAR written once, one byte an
op, of which an alignment has at least ``max(ref, qry)``.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 without the tensor cores
PEAK_HBM_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


def ops_per_cell(max_n: int) -> int:
    return 3 + 3 + 2 * max_n * 2 + 5


def table_bytes(max_n: int, nl: int = 101, kdim: int = 128) -> int:
    return 25 * 4 + 2 * max_n * nl * kdim * 4


def dp_work(alignments: Iterable[Tuple[int, int]], r: int = 30,
            max_n: int = 6) -> Tuple[float, float]:
    """(float32 operations, bytes) of one call over (ref, qry) sizes."""
    ops = 0
    nbytes = table_bytes(max_n)
    for ref, qry in alignments:
        ops += (ref + qry + 1) * (2 * r + 1) * ops_per_cell(max_n)
        nbytes += ref + qry + max(ref, qry)
    return float(ops), float(nbytes)


def least_time(ops: float, nbytes: float) -> Tuple[float, str]:
    """Seconds, and which peak sets them."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
