"""SAM records, parsing, writing, and MD-tag reference reconstruction.

Replaces the pysam AlignmentFile API surface the reference uses
(reference: src/bam.pyx:18-47, :127-145).
"""
from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .cigar import cigar_tuples
from ..constants import CONSUMES_QUERY, CONSUMES_REF

# SAM flag bits
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

_MD_RE = re.compile(r"\d+|\^[A-Za-z]+|[A-Za-z]")


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int          # 0-based leftmost reference position
    mapq: int
    cigar: str        # run-length CIGAR string ('*' if absent)
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)
    _tuples: Optional[List[Tuple[int, str]]] = field(
        default=None, repr=False, compare=False)

    @property
    def tuples(self) -> List[Tuple[int, str]]:
        """Memoized cigar_tuples (hot path: reference_length, clip
        stripping, MD reconstruction all walk the same CIGAR)."""
        if self._tuples is None:
            self._tuples = cigar_tuples(self.cigar)
        return self._tuples

    # --- flag helpers (pysam parity: src/bam.pyx:31-32) ---
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def has_tag(self, tag: str) -> bool:
        return tag in self.tags

    def get_tag(self, tag: str):
        return self.tags[tag][1]

    # --- cigar-derived geometry ---
    @property
    def reference_length(self) -> int:
        """Reference bases spanned by the alignment."""
        return sum(n for n, op in self.tuples if op in CONSUMES_REF)

    @property
    def reference_start(self) -> int:
        return self.pos

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length

    def _clip_lengths(self) -> Tuple[int, int]:
        tups = self.tuples
        lead = 0
        for n, op in tups:
            if op in "SH":
                lead += n if op == "S" else 0
            else:
                break
        tail = 0
        for n, op in reversed(tups):
            if op in "SH":
                tail += n if op == "S" else 0
            else:
                break
        return lead, tail

    @property
    def query_alignment_sequence(self) -> str:
        """Query sequence minus soft clips (pysam parity; src/bam.pyx:42)."""
        lead, tail = self._clip_lengths()
        return self.seq[lead:len(self.seq) - tail]

    @property
    def query_alignment_qualities_str(self) -> str:
        """Phred+33 quality string over the aligned query ('*' if absent).

        The reference re-encodes pysam's int list back to chr(33+q)
        (src/bam.pyx:43-44); we keep the SAM text form throughout.
        """
        if self.qual == "*":
            return "*"
        lead, tail = self._clip_lengths()
        return self.qual[lead:len(self.qual) - tail]

    def get_reference_sequence(self) -> str:
        """Reconstruct the aligned reference slice from the MD tag
        (pysam parity: src/bam.pyx:45). Requires MD (samtools calmd)."""
        if "MD" not in self.tags:
            raise ValueError(f"read {self.qname} has no MD tag")
        md = str(self.tags["MD"][1])
        qseq = self.query_alignment_sequence
        ref_parts: List[str] = []
        md_ops: List[Tuple[str, object]] = []
        for tok in _MD_RE.findall(md):
            c = tok[0]
            if c == "^":
                md_ops.append(("D", tok[1:]))
            elif c.isdigit():
                md_ops.append(("=", int(tok)))
            else:
                md_ops.append(("X", tok))

        # walk CIGAR; M/=/X consume MD match-counts or mismatch letters,
        # D consumes MD deletion strings, I/S consume only the query.
        md_i = 0
        md_rem = 0  # remaining bases in current '=' run
        q = 0

        def next_md():
            nonlocal md_i
            op = md_ops[md_i]
            md_i += 1
            return op

        for n, op in self.tuples:
            if op in "SH":
                if op == "S":
                    pass  # qseq already has clips removed
                continue
            if op in "M=X":
                left = n
                while left:
                    if md_rem == 0:
                        kind, val = next_md()
                        if kind == "=":
                            md_rem = val
                            if md_rem == 0:
                                continue
                        elif kind == "X":
                            ref_parts.append(val)
                            q += 1
                            left -= 1
                            continue
                        else:
                            raise ValueError("MD/CIGAR mismatch: deletion "
                                             "inside match run")
                    take = min(left, md_rem)
                    ref_parts.append(qseq[q:q + take])
                    q += take
                    md_rem -= take
                    left -= take
            elif op == "D":
                # skip zero-length match runs, then expect an MD deletion
                while (md_rem == 0 and md_i < len(md_ops)
                       and md_ops[md_i] == ("=", 0)):
                    md_i += 1
                if md_rem != 0 or md_i >= len(md_ops) or md_ops[md_i][0] != "D":
                    raise ValueError("MD/CIGAR mismatch at deletion")
                _, val = next_md()
                if len(val) != n:
                    raise ValueError("MD deletion length mismatch")
                ref_parts.append(val)
            elif op in "IN":
                if op == "I":
                    q += n
            # P/B ignored
        return "".join(ref_parts).upper()

    def to_line(self) -> str:
        tag_strs = []
        for tag, (typ, val) in self.tags.items():
            tag_strs.append(f"{tag}:{typ}:{val}")
        fields = [self.qname, str(self.flag), self.rname, str(self.pos + 1),
                  str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                  str(self.tlen), self.seq, self.qual] + tag_strs
        return "\t".join(fields)


def parse_tag(s: str) -> Tuple[str, Tuple[str, object]]:
    tag, typ, val = s.split(":", 2)
    if typ == "i":
        val = int(val)
    elif typ == "f":
        val = float(val)
    return tag, (typ, val)


def parse_sam_line(line: str) -> SamRecord:
    f = line.rstrip("\n").split("\t")
    tags = dict(parse_tag(x) for x in f[11:])
    return SamRecord(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]) - 1,
                     mapq=int(f[4]), cigar=f[5], rnext=f[6], pnext=int(f[7]),
                     tlen=int(f[8]), seq=f[9], qual=f[10], tags=tags)


class SamReader:
    """Iterates records of a SAM text file; exposes header info."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(f"SAM file '{path}' not found")
        self.path = path
        self.header_lines: List[str] = []
        self.references: List[str] = []
        self.lengths: List[int] = []
        self._data_offset = 0
        with open(path) as fh:
            off = 0
            for line in fh:
                if not line.startswith("@"):
                    break
                self.header_lines.append(line.rstrip("\n"))
                off += len(line)
                if line.startswith("@SQ"):
                    d = dict(x.split(":", 1) for x in line.rstrip("\n").split("\t")[1:])
                    self.references.append(d["SN"])
                    self.lengths.append(int(d["LN"]))
            self._data_offset = off

    def __iter__(self) -> Iterator[SamRecord]:
        with open(self.path) as fh:
            fh.seek(self._data_offset)
            for line in fh:
                if line.strip():
                    yield parse_sam_line(line)

    def fetch(self, contig: Optional[str] = None, start: Optional[int] = None,
              stop: Optional[int] = None) -> Iterator[SamRecord]:
        """Linear-scan region fetch (no index; fine at framework scale since
        reads are streamed once)."""
        for rec in self:
            if contig is not None and rec.rname != contig:
                continue
            if rec.is_unmapped:
                if contig is None:
                    yield rec
                continue
            if start is not None and rec.reference_end <= start:
                continue
            if stop is not None and rec.pos > stop:
                continue
            yield rec

    def count(self, contig: str, start: int, stop: int) -> int:
        return sum(1 for _ in self.fetch(contig, start, stop))


def make_header(references: List[str], lengths: List[int], version: str,
                cl: Optional[str] = None, sort_order: str = "coordinate") -> List[str]:
    """Output header matching the reference writer (src/bam.pyx:127-145)."""
    lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
    for ctg, ln in zip(references, lengths):
        lines.append(f"@SQ\tSN:{ctg}\tLN:{ln}")
    if cl is None:
        cl = " ".join(sys.argv)
    lines.append(f"@PG\tPN:realigner\tID:realigner\tVN:{version}\tCL:{cl}")
    return lines


def write_sam(path: str, header_lines: List[str], records: List[SamRecord]) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for line in header_lines:
            fh.write(line + "\n")
        for rec in records:
            fh.write(rec.to_line() + "\n")
