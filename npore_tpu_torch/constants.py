"""Base and CIGAR encodings shared across the framework.

Mirrors the reference enums (reference: src/cfg.py:11-32) so that integer
encodings of sequences and CIGAR strings are interchangeable with the
reference's data files and goldens.
"""
from __future__ import annotations

import numpy as np

# --- base encoding: N=0, A=1, C=2, G=3, T=4, '-'=5 (src/cfg.py:11-25) ---
BASES = "NACGT"
SYMBOLS = "NACGT-"
NBASES = len(BASES)

BASE_TO_INT = {"N": 0, "A": 1, "C": 2, "G": 3, "T": 4,
               "n": 0, "a": 1, "c": 2, "g": 3, "t": 4, "-": 5}

# 256-entry lookup table for vectorized encoding; unknown chars -> 0 ('N'),
# matching the reference's defaultdict(int) behavior (src/cfg.py:14).
_BASE_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _v in BASE_TO_INT.items():
    _BASE_LUT[ord(_ch)] = _v

# --- CIGAR encoding: 'MIDNSHP=XB' (src/cfg.py:28-32) ---
CIGARS = "MIDNSHP=XB"
CIGAR_TO_INT = {c: i for i, c in enumerate(CIGARS)}
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_E, OP_X, OP_B = range(10)

_CIG_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _v in CIGAR_TO_INT.items():
    _CIG_LUT[ord(_ch)] = _v

# ops that consume query sequence / reference (SAM spec)
CONSUMES_QUERY = frozenset("MIS=X")
CONSUMES_REF = frozenset("MDN=X")

# BAM 4-bit sequence encoding (SAM spec section 4.2)
BAM_SEQ_CODES = "=ACMGRSVTWYHKDBN"


def bases_to_int(seq: str) -> np.ndarray:
    """Encode a base string to uint8 ints (reference: src/cig.pyx:212-229)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _BASE_LUT[raw]


def int_to_bases(int_seq) -> str:
    """Decode uint8 ints to a base string (reference: src/cig.pyx:231-232)."""
    return "".join(SYMBOLS[i] for i in np.asarray(int_seq))


def cig_to_int(cig: str) -> np.ndarray:
    """Encode an extended CIGAR string to uint8 (reference: src/cig.pyx:234-238)."""
    raw = np.frombuffer(cig.encode("ascii"), dtype=np.uint8)
    out = _CIG_LUT[raw]
    if (out == 255).any():
        bad = cig[int(np.argmax(out == 255))]
        raise ValueError(f"invalid CIGAR op {bad!r}")
    return out


def int_to_cig(int_cig) -> str:
    """Decode uint8 CIGAR ints to a string (reference: src/cig.pyx:240-241)."""
    return np.asarray(int_cig, dtype=np.uint8).tobytes().translate(
        bytes(CIGARS, "ascii") + bytes(246)).decode("ascii")
