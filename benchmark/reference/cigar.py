"""The realigner's CIGAR normalisation (reference src/cig.pyx:102-192,
src/bam.pyx:64-83): left-shift indels through matches to a fixpoint, then
fuse each 'ID' pair into 'M' and run-length encode.

The same rules as the port's ``io/cigar.push_indels_left`` and
``push_inss_thru_dels``, applied a run of indels at a time: within one
pass a run's shift permutes only the ops before its end, so every later
run starts where it started, with as many sequence bases before it; and
each 'D+I+' junction is rewritten where it stood.
"""
from __future__ import annotations

import numpy as np

OP_M, OP_I, OP_D, OP_E, OP_X = 0, 1, 2, 7, 8
_EXT = np.full(256, 255, dtype=np.uint8)
for _ch, _op in (("M", OP_M), ("I", OP_I), ("D", OP_D), ("X", OP_M),
                 ("=", OP_M)):
    _EXT[ord(_ch)] = _op
_MID = bytes("MID", "ascii") + bytes(253)


def _runs(c: np.ndarray, op: int):
    """(start, length) of each run of ``op`` in ``c``."""
    m = np.concatenate(([False], c == op, [False])).astype(np.int8)
    d = np.diff(m)
    s = np.flatnonzero(d == 1)
    return s, np.flatnonzero(d == -1) - s


def push_indels_left(c: np.ndarray, seq: np.ndarray, push: int) -> None:
    """One left-to-right pass moving each run of ``push`` left over
    matches while the bases it passes repeat; ``seq`` is what the run
    consumes (the reference for D, the query for I). In place."""
    consumes = (c == OP_M) | (c == OP_X) | (c == OP_E) | (c == push)
    before = np.concatenate(([0], np.cumsum(consumes)))
    starts, lens = _runs(c, push)
    for cp, n in zip(starts.tolist(), lens.tolist()):
        sp = int(before[cp])
        k = 0
        while (cp - k > 0 and sp - k > 0
               and seq[sp - k - 1] == seq[sp - k - 1 + n]
               and (c[cp - k - 1] == OP_E or c[cp - k - 1] == OP_M)):
            k += 1
        if k:
            moved = c[cp - k:cp].copy()
            c[cp - k:cp - k + n] = push
            c[cp - k + n:cp + n] = moved


def push_inss_thru_dels(c: np.ndarray) -> None:
    """Rewrite each 'D+I+' as 'I+D+', left to right. In place. A rewrite
    changes only its own junction's ops, so the junctions are those of the
    ops as they came; a D run is measured as it stands, since an earlier
    rewrite may have lengthened it to the left."""
    for i in np.flatnonzero((c[:-1] == OP_D) & (c[1:] == OP_I)).tolist():
        s = i
        while s > 0 and c[s - 1] == OP_D:
            s -= 1
        e = i + 1
        while e < len(c) and c[e] == OP_I:
            e += 1
        ni = e - i - 1
        c[s:s + ni] = OP_I
        c[s + ni:e] = OP_D


def normalize(extended: str, ref: np.ndarray, seq: np.ndarray
              ) -> np.ndarray:
    """The left-normalised fixpoint of an extended CIGAR as M/I/D ops."""
    c = _EXT[np.frombuffer(extended.encode("ascii"), dtype=np.uint8)].copy()
    if (c == 255).any():
        raise ValueError("invalid CIGAR op")
    while True:
        old = c.copy()
        push_indels_left(c, ref, OP_D)
        push_inss_thru_dels(c)
        push_indels_left(c, seq, OP_I)
        push_inss_thru_dels(c)
        if np.array_equal(old, c):
            return c


def mid_string(c: np.ndarray) -> str:
    """M/I/D ops as their letters."""
    return c.tobytes().translate(_MID).decode("ascii")


def finalize(extended: str, ref: np.ndarray, seq: np.ndarray) -> str:
    """The run-length CIGAR the realigner writes for ``extended``."""
    c = normalize(extended, ref, seq)
    if len(c) == 0:
        return ""
    if len(c) > 1:
        pair = np.flatnonzero((c[:-1] == OP_I) & (c[1:] == OP_D))
        if len(pair):
            c[pair] = OP_M
            keep = np.ones(len(c), dtype=bool)
            keep[pair + 1] = False
            c = c[keep]
    starts = np.concatenate(([0], np.flatnonzero(c[1:] != c[:-1]) + 1))
    lens = np.diff(np.concatenate((starts, [len(c)]))).tolist()
    ops = c[starts].tobytes().translate(_MID).decode("ascii")
    return "".join(f"{n}{o}" for n, o in zip(lens, ops))
