"""Score-matrix construction from confusion counts.

Reference semantics: src/aln.pyx:11-96. Penalties are -log((count+eps) /
(total+eps)) in float64 math stored to float32, followed by in-place
monotonicity sweeps with delta=0.01 (fix_matrix_properties). The sweeps are
order-dependent recurrences over already-updated neighbors, so they are kept
as literal loops here (run once per process; results are cacheable). All
arithmetic is done with float64 intermediates to match the legacy NumPy
promotion rules the reference goldens were produced under.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np

from ..constants import NBASES


def fix_matrix_properties(scores: np.ndarray, delta: float = 0.01) -> np.ndarray:
    """Enforce penalty-matrix invariants in place (src/aln.pyx:11-58):
    zero-cost diagonal, flat penalty 20 for repeats shorter than 3 units,
    monotone growth of INDEL penalties, and a preference for placing an
    INDEL in a longer repeat."""
    ns, l, _ = scores.shape
    for n in range(ns):
        for i in range(1, l):
            scores[n, 0, i] = 20
            scores[n, 1, i] = 20
            scores[n, 2, i] = 20
            scores[n, i, i] = 0

        # more insertions => more penalized
        for j in range(1, l):
            for i in range(j - 1, -1, -1):
                scores[n, i, j] = max(float(scores[n, i, j]),
                                      float(scores[n, i + 1, j]) + delta,
                                      float(scores[n, i, j - 1]) + delta)

        # more deletions => more penalized
        for i in range(4, l):
            for j in range(i - 1, -1, -1):
                scores[n, i, j] = max(float(scores[n, i, j]),
                                      float(scores[n, i, j + 1]) + delta,
                                      float(scores[n, i - 1, j]) + delta)

        # prefer INDELs in longer n-polymers
        for i in range(4, l):
            for j in range(1, l):
                if i != j:
                    scores[n, i, j] = min(float(scores[n, i, j]),
                                          float(scores[n, i - 1, j - 1]) - delta)
    return scores


def calc_score_matrices(subs: np.ndarray, nps: np.ndarray, inss: np.ndarray,
                        dels: np.ndarray, max_n: int = 6, max_l: int = 100,
                        eps: float = 0.01
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Counts -> -log penalty matrices (src/aln.pyx:62-96).

    Note the reference iterates ref_len/call_len over range(max_l) = 0..99,
    leaving row/column max_l untouched before the fix-up sweeps; replicated.
    """
    np_scores = np.zeros_like(nps, dtype=np.float32)
    for n in range(max_n):
        for ref_len in range(max_l):
            total = float(np.sum(nps[n, ref_len]))
            for call_len in range(max_l):
                count = int(nps[n, ref_len, call_len])
                frac = (count + eps) / (total + eps)
                np_scores[n, ref_len, call_len] = -math.log(frac)
    np_scores = fix_matrix_properties(np_scores)

    sub_scores = np.zeros((NBASES, NBASES), dtype=np.float32)
    for i in range(1, NBASES):
        row_total = float(np.sum(subs[i]))
        for j in range(1, NBASES):
            if i != j:
                sub_scores[i, j] = -math.log((int(subs[i, j]) + eps)
                                             / (row_total + eps))
            else:
                sub_scores[i, j] = 0

    ins_scores = np.zeros_like(inss, dtype=np.float32)
    total = float(np.sum(inss))
    for l in range(max_l):
        ins_scores[l] = -math.log((int(inss[l]) + eps) / (total + eps))

    del_scores = np.zeros_like(dels, dtype=np.float32)
    total = float(np.sum(dels))
    for l in range(max_l):
        del_scores[l] = -math.log((int(dels[l]) + eps) / (total + eps))

    # ins_scores/del_scores are computed for parity but unused by align();
    # only indel_start/indel_extend constants are (src/aln.pyx:380).
    return sub_scores, np_scores, ins_scores, del_scores


def load_confusion_matrices(stats_dir: str
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Load cached confusion matrices (src/bam.pyx:171-176)."""
    return (np.load(os.path.join(stats_dir, "subs_cm.npy")),
            np.load(os.path.join(stats_dir, "nps_cm.npy")),
            np.load(os.path.join(stats_dir, "inss_cm.npy")),
            np.load(os.path.join(stats_dir, "dels_cm.npy")))


def save_confusion_matrices(stats_dir: str, subs, nps, inss, dels) -> None:
    os.makedirs(stats_dir, exist_ok=True)
    np.save(os.path.join(stats_dir, "subs_cm"), subs)
    np.save(os.path.join(stats_dir, "nps_cm"), nps)
    np.save(os.path.join(stats_dir, "inss_cm"), inss)
    np.save(os.path.join(stats_dir, "dels_cm"), dels)
