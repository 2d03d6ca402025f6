"""n-polymer annotation: repeat length L and repeat index L_IDX per position.

Semantics (reference: src/aln.pyx:179-251): for every position p and period
n in [1, max_n], L[p, n-1] is the unit count of the n-periodic repeat
covering p (0 unless the repeat has >= 3 units), and L_IDX[p, n-1] is p's
0-based unit index within it. Two suppression rules apply:
  * a repeat is skipped when an equivalent shorter-period repeat at the same
    start covers at least the same span (6xT is not also 3xTT);
  * writes only replace strictly-smaller stored L values, so longer repeats
    detected at earlier starts win over their own suffixes.
Stored L is clamped to max_l, but comparisons use the raw length.
"""
from __future__ import annotations

import numpy as np

L = 0
L_IDX = 1


def get_np_info(seq: np.ndarray, max_n: int = 6, max_l: int = 100) -> np.ndarray:
    """Sequential spec version. seq: int-encoded bases (uint8), N=0.

    Returns int32 array of shape (len(seq), 2, max_n).
    """
    seq = np.asarray(seq)
    seq_len = len(seq)
    info = np.zeros((seq_len, 2, max_n), dtype=np.int32)

    for s in range(seq_len):
        if not seq[s]:  # 'N' bases start nothing
            continue
        for n in range(1, max_n + 1):
            # count complete n-strides of self-similarity from s
            units = 0
            ptr = s
            while ptr + n < seq_len and seq[ptr] == seq[ptr + n]:
                ptr += 1
                if (ptr - s) % n == 0:
                    units += 1
            l = units + 1 if units else 0

            if l > 2:
                # suppression: an equivalent shorter-period repeat wins
                longest = True
                for n2 in range(1, n):
                    if l * n <= info[s, L, n2 - 1] * n2:
                        longest = False
                if not longest:
                    continue
                for idx in range(l):
                    pos = s + idx * n
                    if l > info[pos, L, n - 1]:
                        info[pos, L, n - 1] = min(max_l, l)
                        info[pos, L_IDX, n - 1] = idx
    return info
