"""Pileup engine: per-position read-base columns straight from a BAM.

Replaces the reference's `samtools mpileup | cut -f5` subprocess
(reference: src/bam.pyx:300-314, src/purity.py:182-184). Emits
mpileup-compatible column strings — read bases as letters (samtools prints
letters when no -f FASTA is given), '*' for deletion-covered positions,
'^X'/'$' read start/end markers, and '+N<seq>'/'-N<seq>' indel annotations
after the anchor base — so the downstream parsers match reference
semantics token for token. Bases below `min_bq` are excluded like
samtools' default -Q 13 filter.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .cigar import cigar_tuples


def _read_events(rec, min_bq: int, ref: Optional[str] = None):
    """Yield (ref_pos, column_token) pairs for one read.

    The token already contains start/end markers and any indel suffix, so a
    column is the concatenation of its reads' tokens. ``ref`` (the contig
    string) makes deletion annotations carry the actual deleted reference
    bases the way ``samtools mpileup -f`` prints them; without it they are
    'N's — exactly what the reference's no-FASTA invocation produces
    (src/bam.pyx:302-303 runs mpileup without -f).
    """
    seq = rec.seq
    qual = rec.qual
    pos = rec.pos
    q = 0
    events: List[Tuple[int, str]] = []
    first = True

    def bq(i: int) -> int:
        if qual == "*":
            return 255
        return ord(qual[i]) - 33

    tups = cigar_tuples(rec.cigar)
    for ti, (n, op) in enumerate(tups):
        if op in "SH":
            if op == "S":
                q += n
            continue
        if op in "M=X":
            for k in range(n):
                if bq(q) >= min_bq:
                    tok = seq[q].upper()
                    if first:
                        mq = chr(33 + min(rec.mapq, 93))
                        tok = "^" + mq + tok
                        first = False
                    events.append((pos, tok))
                q += 1
                pos += 1
        elif op == "D":
            # deletion: annotate the previous column, then '*' per position
            if events:
                p, tok = events[-1]
                dbases = (ref[pos:pos + n].upper() if ref is not None
                          else "N" * n)
                events[-1] = (p, tok + f"-{n}" + dbases)
            for k in range(n):
                events.append((pos + k, "*"))
            pos += n
        elif op == "I":
            ins = seq[q:q + n].upper()
            if events:
                p, tok = events[-1]
                events[-1] = (p, tok + f"+{n}{ins}")
            q += n
        elif op == "N":
            pos += n
        # P/B ignored
    if events:
        p, tok = events[-1]
        events[-1] = (p, tok + "$")
    return events


def pileup_columns(bam, contig: str, start: int, end: int,
                   min_bq: int = 13,
                   ref: Optional[str] = None) -> Iterator[Tuple[int, str]]:
    """Yield (pos, column_string) for every covered position in
    [start, end), positions ascending; uncovered positions are skipped
    (like samtools mpileup)."""
    cols: Dict[int, List[str]] = {}
    for rec in bam.fetch(contig, start, end):
        if rec.is_secondary or rec.is_supplementary or rec.is_unmapped:
            continue
        for p, tok in _read_events(rec, min_bq, ref):
            if start <= p < end:
                cols.setdefault(p, []).append(tok)
    for p in sorted(cols):
        yield p, "".join(cols[p])


def get_pileups(bam, contig: str, start: int, end: int,
                min_bq: int = 13, ref: Optional[str] = None) -> Iterator[str]:
    """Uppercased column strings only (reference: src/bam.pyx:300-314 yields
    `cut -f5` uppercased). Note the reference enumerates columns positionally
    against the region's reference slice assuming full coverage; we yield
    (pos-aligned) columns via pileup_columns for the stats engine instead."""
    for _, col in pileup_columns(bam, contig, start, end, min_bq, ref):
        yield col.upper()
