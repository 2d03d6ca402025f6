"""BAM writer: SamRecords -> BGZF-compressed BAM (SAM spec section 4.2).

The reference never writes BAM itself — it emits SAM text and shells out
to ``samtools sort/view`` for binary output (reference: scripts/align.sh:
13-60, test/realign.sh:14). Neither samtools nor pysam exists in this
image, so BAM encoding is done in-process on top of io/bgzf.BgzfWriter.
Output is readable by the C++ streaming decoder (native/bamio.cpp), the
pure-Python reader (io/bam.py), and stock samtools/pysam elsewhere.

Used by the synthetic-fixture generators (tests/generate_data.py, the
genome-scale harness) and anywhere a pipeline stage needs a BAM artifact
without external tools.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Optional, Sequence

from .bgzf import BgzfWriter, reg2bin
from .cigar import cigar_tuples
from .sam import SamRecord

_CIG_OP = {op: i for i, op in enumerate("MIDNSHP=X")}
_SEQ_NIBBLE = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}


def _encode_record(rec: SamRecord, ref_ids: Dict[str, int]) -> bytes:
    ref_id = ref_ids.get(rec.rname, -1)
    pos = rec.pos if not rec.is_unmapped or rec.rname != "*" else -1
    if rec.rname == "*":
        ref_id, pos = -1, -1
    name = rec.qname.encode("ascii") + b"\x00"
    if rec.cigar == "*":
        tups: List = []
    else:
        tups = cigar_tuples(rec.cigar)
    cig = b"".join(struct.pack("<I", (n << 4) | _CIG_OP[op])
                   for n, op in tups)
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    sq = bytearray((l_seq + 1) // 2)
    for i, base in enumerate(seq):
        nib = _SEQ_NIBBLE.get(base.upper(), 15)
        if i % 2 == 0:
            sq[i // 2] = nib << 4
        else:
            sq[i // 2] |= nib
    if rec.qual == "*" or not l_seq:
        qual = b"\xff" * l_seq
    else:
        qual = bytes((ord(c) - 33) & 0xFF for c in rec.qual)
        if len(qual) != l_seq:
            raise ValueError(f"qual/seq length mismatch for {rec.qname}")
    end = rec.reference_end if tups else rec.pos + 1
    bam_bin = reg2bin(max(rec.pos, 0), max(end, rec.pos + 1)) \
        if ref_id >= 0 else 0
    if rec.rnext == "=":
        next_ref = ref_id
    else:
        next_ref = ref_ids.get(rec.rnext, -1)
    tags = bytearray()
    for tag, (typ, val) in rec.tags.items():
        tags += tag.encode("ascii")
        if typ == "i":
            tags += b"i" + struct.pack("<i", int(val))
        elif typ == "f":
            tags += b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            tags += b"A" + str(val)[:1].encode("ascii")
        elif typ in ("Z", "H"):
            tags += typ.encode("ascii") + str(val).encode("ascii") + b"\x00"
        else:
            raise ValueError(f"unsupported tag type '{typ}' for {tag}")
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, len(name), rec.mapq, bam_bin,
        len(tups), rec.flag, l_seq, next_ref,
        rec.pnext - 1 if rec.pnext > 0 else -1, rec.tlen)
    body += name + cig + bytes(sq) + qual + bytes(tags)
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, references: Sequence[str], lengths: Sequence[int],
              records: Iterable[SamRecord],
              header_text: Optional[str] = None) -> None:
    """Write a BAM file; records should be coordinate-sorted if readers
    will region-seek it (the native reader's sparse index assumes so)."""
    if header_text is None:
        lines = ["@HD\tVN:1.6\tSO:coordinate"]
        lines += [f"@SQ\tSN:{n}\tLN:{ln}"
                  for n, ln in zip(references, lengths)]
        header_text = "\n".join(lines) + "\n"
    ref_ids = {n: i for i, n in enumerate(references)}
    with BgzfWriter(path) as w:
        text = header_text.encode("ascii")
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        w.write(struct.pack("<i", len(references)))
        for n, ln in zip(references, lengths):
            nb = n.encode("ascii") + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
        for rec in records:
            w.write(_encode_record(rec, ref_ids))
