"""Seeded synthetic reads with their true alignments: the port's copy of
the generator functions of ``tests/generate_data.py`` (reference:
test/generate_bam.py).

Reads carry 3%/5%/3% sub/ins/del noise and exact '=XID' CIGARs. The same
``numpy.random.Generator`` gives the same reads as the test generator.
"""
from __future__ import annotations


def make_ref(rng, length: int = 1000) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, length))


def make_read(rng, ref: str, min_len: int = 300, max_len: int = 700,
              p_sub: float = 0.03, p_ins: float = 0.05, p_del: float = 0.03):
    """Returns (pos, seq, extended_cigar) with the exact generating edits
    (reference: test/generate_bam.py:34-101)."""
    rlen = int(rng.integers(min_len, max_len + 1))
    pos = int(rng.integers(0, len(ref) - rlen))
    seq = []
    cig = []
    for ch in ref[pos:pos + rlen]:
        u = rng.random()
        if u < p_del:
            cig.append("D")
            continue
        if u < p_del + p_ins:
            seq.append("ACGT"[rng.integers(0, 4)])
            cig.append("I")
        if u < p_del + p_ins + p_sub:
            alt = "ACGT"[rng.integers(0, 4)]
            seq.append(alt)
            cig.append("=" if alt == ch else "X")
        else:
            seq.append(ch)
            cig.append("=")
    return pos, "".join(seq), "".join(cig)


def md_tag(ref: str, pos: int, cigar: str) -> str:
    """MD tag for an extended '=XID' CIGAR (samtools calmd semantics)."""
    out = []
    match = 0
    rp = pos
    i = 0
    n = len(cigar)
    while i < n:
        op = cigar[i]
        if op == "=":
            match += 1
            rp += 1
            i += 1
        elif op == "X":
            out.append(str(match))
            match = 0
            out.append(ref[rp])
            rp += 1
            i += 1
        elif op == "D":
            out.append(str(match))
            match = 0
            j = i
            while j < n and cigar[j] == "D":
                j += 1
            out.append("^" + ref[rp:rp + (j - i)])
            rp += j - i
            i = j
        else:          # I consumes only the query
            i += 1
    out.append(str(match))
    return "".join(out)
