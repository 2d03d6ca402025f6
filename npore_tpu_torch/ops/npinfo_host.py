"""Vectorized n-polymer scan (numpy host version).

Bit-identical to golden.npinfo.get_np_info (reference: src/aln.pyx:179-251)
but O(len + total-repeat-span) instead of per-position while loops. Used by
the window builder and BED generation for full-scale inputs.

Derivation of the closed form from the sequential spec:
  * the per-start raw unit count l(s, n) comes from the length of the run of
    consecutive self-similarity matches m_n[i] = (seq[i] == seq[i+n]);
  * a start qualifies if l > 2, seq[s] != 'N', and for every shorter period
    n2 < n: l*n > stored_L[s, n2] * n2 — the stored values for n2 < n are
    final by the time (s, n) is processed, because every write to position s
    comes from a start <= s, so the filter can use the finished n2 layers;
  * writes overwrite strictly-smaller stored values; since stored values are
    clamped to max_l while comparisons use raw l, the final writer of a
    position is the LAST covering start with raw l > max_l if any exists,
    otherwise the FIRST covering start achieving the maximum raw l.
"""
from __future__ import annotations

import numpy as np

L = 0
L_IDX = 1


def _run_lengths(m: np.ndarray) -> np.ndarray:
    """t[s] = number of consecutive True values starting at s."""
    n = len(m)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    nf = np.full(n, n, dtype=np.int64)
    idx = np.flatnonzero(~m)
    nf[idx] = idx
    nf = np.minimum.accumulate(nf[::-1])[::-1]
    return nf - np.arange(n)


def get_np_info_vec(seq: np.ndarray, max_n: int = 6, max_l: int = 100) -> np.ndarray:
    seq = np.asarray(seq)
    slen = len(seq)
    info = np.zeros((slen, 2, max_n), dtype=np.int32)
    stored = info[:, L, :]   # view: final clamped L values per layer
    lidx = info[:, L_IDX, :]

    for n in range(1, max_n + 1):
        if slen <= n:
            continue
        m = seq[:-n] == seq[n:]
        t = _run_lengths(m)
        units = t // n
        raw = np.where(units > 0, units + 1, 0)
        qual = (raw > 2) & (seq[:slen - n] != 0)
        for n2 in range(1, n):
            qual &= raw * n > stored[:slen - n, n2 - 1].astype(np.int64) * n2

        starts = np.flatnonzero(qual)
        if len(starts) == 0:
            continue
        col_stored = stored[:, n - 1]
        col_lidx = lidx[:, n - 1]
        # process starts in ascending order; slice writes reproduce the
        # strictly-greater overwrite semantics exactly
        for s in starts:
            l = int(raw[s])
            pos = s + np.arange(l, dtype=np.int64) * n
            write = l > col_stored[pos]
            wpos = pos[write]
            col_stored[wpos] = min(max_l, l)
            col_lidx[wpos] = np.flatnonzero(write)
    return info
