"""n-polymer annotation of a sequence (reference src/aln.pyx:179-251): for
each position p and period n in [1, max_n], L[p, n-1] is the unit count of
the n-periodic repeat covering p (0 under 3 units; stored clamped to
max_l) and L_IDX[p, n-1] p's unit index in it; a repeat is skipped where a
shorter period at the same start covers as much, and a write replaces
only a smaller stored L.

``np_info`` is a frozen copy of the port's host scan
(``ops/npinfo_host.get_np_info_vec``), one sequence at a time;
``np_info_rows`` a frozen copy of its batched form
(``ops/npinfo_device.np_info_device``), many rows at once on a device, which
the reference uses. ``benchmark/tests`` hold the two equal.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

L, L_IDX = 0, 1


def _run_lengths(m: np.ndarray) -> np.ndarray:
    """t[s] = the number of consecutive True values from s."""
    n = len(m)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    nf = np.full(n, n, dtype=np.int64)
    idx = np.flatnonzero(~m)
    nf[idx] = idx
    nf = np.minimum.accumulate(nf[::-1])[::-1]
    return nf - np.arange(n)


def np_info(seq: np.ndarray, max_n: int = 6, max_l: int = 100
            ) -> np.ndarray:
    """(len(seq), 2, max_n) int32 of int-encoded bases (N = 0)."""
    seq = np.asarray(seq)
    slen = len(seq)
    info = np.zeros((slen, 2, max_n), dtype=np.int32)
    stored = info[:, L, :]
    lidx = info[:, L_IDX, :]
    for n in range(1, max_n + 1):
        if slen <= n:
            continue
        t = _run_lengths(seq[:-n] == seq[n:])
        units = t // n
        raw = np.where(units > 0, units + 1, 0)
        qual = (raw > 2) & (seq[:slen - n] != 0)
        for n2 in range(1, n):
            qual &= raw * n > stored[:slen - n, n2 - 1].astype(np.int64) * n2
        col_stored = stored[:, n - 1]
        col_lidx = lidx[:, n - 1]
        for s in np.flatnonzero(qual):
            l = int(raw[s])
            pos = s + np.arange(l, dtype=np.int64) * n
            write = l > col_stored[pos]
            wpos = pos[write]
            col_stored[wpos] = min(max_l, l)
            col_lidx[wpos] = np.flatnonzero(write)
    return info


def _segscan(first: torch.Tensor, last: torch.Tensor, keep: torch.Tensor,
             K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented running min of ``first`` and max of ``last`` along the last
    axis; a segment starts where ``keep`` is False (values in [-1, K - 1],
    each segment offset by its id times K)."""
    seg = torch.cumsum((~keep).to(torch.int64), dim=-1) * K
    f = torch.cummin(first - seg, dim=-1).values + seg
    lt = torch.cummax(last + seg, dim=-1).values - seg
    return f, lt


def np_info_rows(seq: torch.Tensor, lengths: torch.Tensor, max_n: int = 6,
                 max_l: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L_IDX), (B, max_n, P) int32, of each row of ``seq`` (B, P),
    scanned to its length only. Per period, a start's raw unit count is
    the run of ``seq[p] == seq[p + n]`` from it; runs cut each residue
    class into chains whose starts cover the chain up to its end; the
    final writer of p is the last qualifying chain predecessor with raw
    length > max_l if one exists (those overwrite the clamped stored
    value), else the first qualifying one."""
    seq = seq.to(torch.int64)
    B, P = seq.shape
    dev = seq.device
    pos = torch.arange(P, device=dev)
    NONE = P
    room = lengths.to(dev, torch.int64)[:, None] - pos
    m = torch.zeros(B, max_n, P, dtype=torch.bool, device=dev)
    for n in range(1, min(max_n, P - 1) + 1):
        m[:, n - 1, :P - n] = ((seq[:, :-n] == seq[:, n:])
                               & (room[..., :-n] > n))
    t_all = torch.where(m, P, pos).flip(-1).cummin(-1).values.flip(-1) - pos
    Ls, Is = [], []
    stored = torch.zeros(B, P, dtype=torch.int64, device=dev)
    for n in range(1, max_n + 1):
        t = t_all[:, n - 1]
        units = t // n
        raw = torch.where(units > 0, units + 1, 0)
        qual = (raw > 2) & (seq != 0) & (raw * n > stored)
        link = torch.zeros(B, P, dtype=torch.bool, device=dev)
        link[:, n:] = t[:, :-n] >= n
        pad = (-P) % n
        Q = (P + pad) // n

        def classes(x, fill):
            x = torch.nn.functional.pad(x, (0, pad), value=fill)
            return x.view(B, Q, n).transpose(1, 2)

        def declass(x):
            return x.transpose(1, 2).reshape(B, Q * n)[:, :P]

        first = torch.where(qual, pos, NONE)
        last = torch.where(qual & (raw > max_l), pos, -1)
        f, lt = _segscan(classes(first, NONE), classes(last, -1),
                         classes(link, False), P + 2)
        f, lt = declass(f), declass(lt)
        covered = f < NONE
        win = torch.where(lt >= 0, lt, torch.where(covered, f, pos))
        raw_w = torch.gather(raw, 1, win)
        L = torch.where(covered, torch.clamp(raw_w, max=max_l), 0)
        Li = torch.where(covered, (pos - win) // n, 0)
        stored = torch.maximum(stored, L * n)
        Ls.append(L.to(torch.int32))
        Is.append(Li.to(torch.int32))
    return torch.stack(Ls, 1), torch.stack(Is, 1)
