"""Developer debug printers (reference: src/aln.pyx:791-865).

The reference's manual test flow (test/align.py, test/get_np_info.py)
relies on two pretty-printers: ``dump`` renders a gapped ref/match/seq
view of an alignment, ``print_np_info`` tabulates the n-polymer L/L_IDX
annotations. Kept as human tools here — the automated suites assert on
the underlying arrays instead. The port's copy of
``npore_tpu/golden/debug.py``.
"""
from __future__ import annotations

import numpy as np

from ..constants import int_to_bases
from ..ops.npinfo_host import get_np_info_vec

_GLYPH = {"=": "|", "M": "|", "X": "X"}


def render_alignment(ref: str, seq: str, cigar: str, width: int = 80) -> str:
    """Gapped three-row rendering of an extended CIGAR; returns the text
    (reference prints it: src/aln.pyx:791-839). 'S'/'L' are accepted as
    deletion/insertion aliases like the reference."""
    ref_row, mid_row, seq_row = [], [], []
    ri = si = 0
    for op in cigar:
        if op in "=MX":
            ref_row.append(ref[ri]); ri += 1
            seq_row.append(seq[si]); si += 1
            mid_row.append(_GLYPH[op])
        elif op in "DS":
            ref_row.append(ref[ri]); ri += 1
            seq_row.append("-")
            mid_row.append(" ")
        elif op in "IL":
            ref_row.append("-")
            seq_row.append(seq[si]); si += 1
            mid_row.append(" ")
        else:
            raise ValueError(f"unrecognized CIGAR op {op!r} at index "
                             f"{len(mid_row)}")
    head = (f"REF: len: {len(ref)} ciglen: "
            f"{sum(op in 'XD=M' for op in cigar)}\n"
            f"SEQ: len: {len(seq)} ciglen: "
            f"{sum(op in 'SXI=M' for op in cigar)}\n"
            f"Cigar: {cigar}\n")
    blocks = []
    r, m, s = "".join(ref_row), "".join(mid_row), "".join(seq_row)
    for x in range(0, len(m), width):
        blocks.append("\n".join((r[x:x + width], m[x:x + width],
                                 s[x:x + width], " ")))
    return "\n\n".join([head] + blocks)


def dump(ref, seq, cigar: str) -> None:
    """Pretty-print an alignment (reference: src/aln.pyx:791-839)."""
    if isinstance(ref, np.ndarray):
        ref = int_to_bases(ref)
    if isinstance(seq, np.ndarray):
        seq = int_to_bases(seq)
    print(render_alignment(ref, seq, cigar))


def format_np_info(seq: np.ndarray, max_n: int = 6) -> str:
    """Tabulate per-n repeat length / repeat index annotations
    (reference: src/aln.pyx:843-865)."""
    seq = np.asarray(seq, dtype=np.uint8)
    info = get_np_info_vec(seq, max_n)
    lines = ["bases: " + " ".join("NACGT"[c] for c in seq)]
    for n in range(1, max_n + 1):
        lines.append(f"n={n} l: "
                     + " ".join(str(v) for v in info[:, 0, n - 1]))
        lines.append("l_idx: "
                     + " ".join(str(v) for v in info[:, 1, n - 1]))
    return "\n".join(lines)


def print_np_info(seq: np.ndarray, max_n: int = 6) -> None:
    print(format_np_info(seq, max_n))
    print()
