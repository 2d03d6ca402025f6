"""Score tables of the DP, built in numpy and carried to the device.

The DP's "weights" are the score matrices of ``model/scores``: the (5, 5)
substitution scores and the (max_n, max_l, max_l) n-polymer scores. The DP
reads the latter through a (side, n, l, k) continuation table; the JAX
package and the port build it from the same numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import AlignConfig

KDIM = 128       # k-dimension of the continuation tables (k clamped at 127)
NL = 101         # l-dimension: repeat-unit counts 0..100


def build_cont_tables(np_scores: np.ndarray, max_n: int = 6,
                      max_l: int = 100) -> np.ndarray:
    """T[side, n-1, l, k] = np_score(n, l, +k) (side 0) / np_score(n, l, -k)
    (side 1), k in [0, 128); exact np_score semantics incl. clamping
    (reference: src/aln.pyx:255-274 with max_l passed as max_n)."""
    lg, kg = np.meshgrid(np.arange(NL), np.arange(KDIM), indexing="ij")
    out = np.full((2, max_n, NL, KDIM), 100.0, dtype=np.float32)
    for n in range(1, max_n + 1):
        tab = np_scores[n - 1]
        # insertions: call = l + k
        ref_c = np.minimum(lg, max_l - 1)
        call_c = np.minimum(lg + kg, max_l - 1)
        ins = tab[ref_c, call_c].astype(np.float32)
        ins = np.where(lg <= 0, np.float32(100), ins)
        # deletions: call = l - k; negative call is invalid
        call_d = lg - kg
        ok = (lg > 0) & (call_d >= 0)
        dele = tab[ref_c, np.clip(call_d, 0, max_l - 1)].astype(np.float32)
        dele = np.where(ok, dele, np.float32(100))
        out[0, n - 1] = ins
        out[1, n - 1] = dele
    return out


def build_start_tables(l_ref: np.ndarray, cont: np.ndarray, max_n: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ref-position start penalties: len_start[p, n-1] = np_score(n,
    l_ref[p,n-1], +1), shr_start likewise with -1 (src/aln.pyx:615, 650)."""
    ns = np.arange(max_n)
    len_start = cont[0, ns[None, :], l_ref.astype(np.int64), 1]
    shr_start = cont[1, ns[None, :], l_ref.astype(np.int64), 1]
    return len_start.astype(np.float32), shr_start.astype(np.float32)


def tables_from_numpy(sub_scores: np.ndarray, np_scores: np.ndarray,
                      cfg: AlignConfig, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """The DP's parameters on ``device``: ``sub`` (25,) f32 substitution
    scores (flat SEQ*5+REF) and ``cont`` (2, max_n, 101, 128) f32."""
    cont = build_cont_tables(np_scores, cfg.max_n, cfg.max_l)
    sub = np.ascontiguousarray(sub_scores, dtype=np.float32).reshape(-1)
    return {"sub": torch.from_numpy(sub.copy()).to(device),
            "cont": torch.from_numpy(cont).to(device)}
