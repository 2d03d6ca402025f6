"""One window of a long alignment, checked on its own against the golden
aligner.

A window is one max_b_rows chunk of an alignment's path, and chunks
re-anchor on the original path (``engine/windows.py``), so the golden
aligner reproduces a window without aligning the rest: it gets the
sub-alignment that starts at the window's first anti-diagonal and runs a
few steps past its last (until one more base of each sequence, the window's
n-polymer lookahead), with max_b_rows set to the window's own rows. Its
first chunk is then the window, with the same slices and the same guards.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..engine.windows import path_inss
from ..golden.align import get_breaks

_I, _D = ord("I"), ord("D")


def path_of(cigar: str) -> np.ndarray:
    """The alignment's path: one 'I' or 'D' byte a step (a match is 'DI')."""
    s = cigar.replace("X", "DI").replace("=", "DI").replace("M", "DI")
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8)


def breaks_of(cigar: str, cfg) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Prefix-I and prefix-D counts along the alignment's path and its
    chunk breaks, as ``build_windows`` cuts them."""
    inss = path_inss(cigar)
    dels = np.arange(len(inss), dtype=np.int64) - inss
    return inss, dels, get_breaks(cfg.max_b_rows, len(inss), inss, dels)


def chunk_of(cigar: str, seq_beg: int, ref_beg: int, seq_end: int,
             ref_end: int) -> str:
    """The part of a whole-alignment CIGAR over '=XID' that aligns
    seq[seq_beg:seq_end] to ref[ref_beg:ref_end]; a chunk of the alignment
    begins and ends where the CIGAR passes through those points."""
    ops = np.frombuffer(cigar.encode("ascii"), dtype=np.uint8)
    steps = np.cumsum(np.where((ops == _I) | (ops == _D), 1, 2))
    seq_steps = np.cumsum(ops != _D)
    lo = int(np.searchsorted(steps, seq_beg + ref_beg, side="right"))
    hi = int(np.searchsorted(steps, seq_end + ref_end, side="right"))
    for k, s in ((lo, seq_beg), (hi, seq_end)):
        if (int(seq_steps[k - 1]) if k else 0) != s:
            raise ValueError("the CIGAR does not pass through the chunk's "
                             "end points")
    return cigar[lo:hi]


def golden_window(ref: np.ndarray, seq: np.ndarray, path: np.ndarray,
                  inss: np.ndarray, dels: np.ndarray, breaks: List[int],
                  ci: int, sub_scores, np_scores, cfg) -> Tuple[str, tuple]:
    """The golden CIGAR of chunk ``ci`` of the alignment (``path`` and its
    ``breaks_of``), computed from that chunk's sub-alignment alone, and the
    chunk's (seq_beg, ref_beg, seq_end, ref_end) on the whole alignment."""
    from ..native import golden_align_native
    brk, nxt = breaks[ci], breaks[ci + 1]
    end = nxt
    for op in (_I, _D):                      # one more base of each
        after = np.flatnonzero(path[nxt:] == op)
        if len(after):
            end = max(end, nxt + int(after[0]) + 1)
    ib, db = int(inss[brk]), int(dels[brk])
    sub = path[brk:end].tobytes().decode("ascii")
    got = golden_align_native(ref[db:int(dels[end])], seq[ib:int(inss[end])],
                              sub, sub_scores, np_scores,
                              dataclasses.replace(cfg,
                                                  max_b_rows=nxt - brk + 1))
    if got is None:
        raise RuntimeError("the port's C++ host library did not load")
    bounds = (ib, db, int(inss[nxt]), int(dels[nxt]))
    return chunk_of(got, 0, 0, bounds[2] - ib, bounds[3] - db), bounds
