"""The aligner's score tables from confusion counts: a frozen copy of the
port's ``model/scores.py`` (``calc_score_matrices``,
``fix_matrix_properties``) and ``ops/tables.py`` (``build_cont_tables``),
reference src/aln.pyx:11-96, 255-274."""
from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

NBASES = 5
KDIM = 128       # k-dimension of the continuation tables (k clamped at 127)
NL = 101         # l-dimension: repeat-unit counts 0..100


def load_counts(stats_dir: str):
    return tuple(np.load(os.path.join(stats_dir, f"{n}_cm.npy"))
                 for n in ("subs", "nps", "inss", "dels"))


def fix_matrix_properties(scores: np.ndarray, delta: float = 0.01
                          ) -> np.ndarray:
    ns, l, _ = scores.shape
    for n in range(ns):
        for i in range(1, l):
            scores[n, 0, i] = 20
            scores[n, 1, i] = 20
            scores[n, 2, i] = 20
            scores[n, i, i] = 0
        for j in range(1, l):
            for i in range(j - 1, -1, -1):
                scores[n, i, j] = max(float(scores[n, i, j]),
                                      float(scores[n, i + 1, j]) + delta,
                                      float(scores[n, i, j - 1]) + delta)
        for i in range(4, l):
            for j in range(i - 1, -1, -1):
                scores[n, i, j] = max(float(scores[n, i, j]),
                                      float(scores[n, i, j + 1]) + delta,
                                      float(scores[n, i - 1, j]) + delta)
        for i in range(4, l):
            for j in range(1, l):
                if i != j:
                    scores[n, i, j] = min(float(scores[n, i, j]),
                                          float(scores[n, i - 1, j - 1])
                                          - delta)
    return scores


def score_matrices(subs: np.ndarray, nps: np.ndarray, max_n: int = 6,
                   max_l: int = 100, eps: float = 0.01
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(sub_scores (5, 5), np_scores (max_n, L, L)) as float32 penalties."""
    np_scores = np.zeros_like(nps, dtype=np.float32)
    for n in range(max_n):
        for ref_len in range(max_l):
            total = float(np.sum(nps[n, ref_len]))
            for call_len in range(max_l):
                count = int(nps[n, ref_len, call_len])
                np_scores[n, ref_len, call_len] = -math.log(
                    (count + eps) / (total + eps))
    np_scores = fix_matrix_properties(np_scores)
    sub_scores = np.zeros((NBASES, NBASES), dtype=np.float32)
    for i in range(1, NBASES):
        row_total = float(np.sum(subs[i]))
        for j in range(1, NBASES):
            if i != j:
                sub_scores[i, j] = -math.log((int(subs[i, j]) + eps)
                                             / (row_total + eps))
    return sub_scores, np_scores


def cont_tables(np_scores: np.ndarray, max_n: int = 6, max_l: int = 100
                ) -> np.ndarray:
    """T[side, n-1, l, k] = np_score(n, l, +k) (side 0) or (n, l, -k)
    (side 1), with np_score's clamping (max_l passed as its max_n)."""
    lg, kg = np.meshgrid(np.arange(NL), np.arange(KDIM), indexing="ij")
    out = np.full((2, max_n, NL, KDIM), 100.0, dtype=np.float32)
    for n in range(1, max_n + 1):
        tab = np_scores[n - 1]
        ref_c = np.minimum(lg, max_l - 1)
        call_c = np.minimum(lg + kg, max_l - 1)
        ins = tab[ref_c, call_c].astype(np.float32)
        out[0, n - 1] = np.where(lg <= 0, np.float32(100), ins)
        call_d = lg - kg
        ok = (lg > 0) & (call_d >= 0)
        dele = tab[ref_c, np.clip(call_d, 0, max_l - 1)].astype(np.float32)
        out[1, n - 1] = np.where(ok, dele, np.float32(100))
    return out
