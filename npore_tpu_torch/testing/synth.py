"""Seeded synthetic reads with their true alignments: the port's copy of
the generator functions of ``tests/generate_data.py`` (reference:
test/generate_bam.py).

Reads carry 3%/5%/3% sub/ins/del noise and exact '=XID' CIGARs. The same
``numpy.random.Generator`` gives the same reads as the test generator.

Whole contigs for ``standardize_vcf`` and the BED CLI: ``make_genome`` (the
contig of ``scripts/genome_scale.py``) and ``truth_variants``, a phased
truth set whose indels sit in the contig's n-polymer runs.
"""
from __future__ import annotations

import numpy as np

from ..io.vcf import VcfRecord


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


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _bases(rng, k: int) -> str:
    return _BASES[rng.integers(0, 4, k)].tobytes().decode("ascii")


def genome_with_runs(rng, n_bases: int):
    """``make_genome``'s contig and its injected n-polymer runs, an int64
    array of (start, period, units) rows (runs cut by the contig's end
    included)."""
    chunks, runs = [], []
    total = 0
    while total < n_bases:
        k = int(rng.integers(60, 240))
        chunks.append(_bases(rng, k))
        total += k
        period = int(rng.integers(1, 7))
        unit = _bases(rng, period)
        reps = int(rng.integers(3, 21))
        chunks.append(unit * reps)
        runs.append((total, period, reps))
        total += period * reps
    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 3)
    return "".join(chunks)[:n_bases], runs[runs[:, 0] < n_bases]


def n_tail_reads(rng, n_reads: int = 40):
    """(ref, seq, '=X' CIGAR) of reads dense in periodic runs that hold an
    N (ANAN..., units of 2-3 bases with one N), each ending in such a run,
    cut at a random phase; seq is ref with 3% substitutions. The first two
    are ANANAN and ANANA. A window that ends in such a run is where a scan
    must stop at the window's length: an N there matches the zero padding
    past it."""
    out = [("ANANAN",) * 2, ("ANANA",) * 2]
    for _ in range(n_reads):
        parts, n = [], int(rng.integers(12, 400))
        while sum(map(len, parts)) < n or len(parts) % 2:
            if len(parts) % 2 == 0:
                parts.append(_bases(rng, int(rng.integers(1, 30))))
            else:
                unit = list(_bases(rng, int(rng.integers(1, 3))) + "N")
                rng.shuffle(unit)
                k = len(unit) * int(rng.integers(2, 16))
                parts.append(("".join(unit) * k)[:k - int(rng.integers(
                    0, len(unit)))])
        ref = "".join(parts)
        sub = rng.random(len(ref)) < 0.03
        seq = "".join(_bases(rng, 1) if s else c for c, s in zip(ref, sub))
        out.append((ref, seq))
    return [(ref, seq, "".join("=" if a == b else "X"
                               for a, b in zip(ref, seq)))
            for ref, seq in out]


def make_genome(rng, n_bases: int) -> str:
    """Random sequence with injected n-polymer runs (~1 per 150 bp,
    periods 1-6, 3-20 units), drawn as ``scripts/genome_scale.py`` draws
    it: the same Generator gives the same contig."""
    return genome_with_runs(rng, n_bases)[0]


def truth_variants(rng, contig: str, genome: str, runs: np.ndarray,
                   per_kb: float = 1.0, indel_share: float = 0.15):
    """A phased diploid truth set for ``genome``: ``per_kb`` sites a kb,
    SNVs but for ``indel_share`` of them, which are 1-6 bp insertions or
    deletions of whole units inside the injected n-polymer runs (the
    variants standardization re-places). GT is drawn from 1|0, 0|1 and
    1|1; records are sorted and no two overlap on the reference."""
    n = len(genome)
    n_sites = max(1, int(n * per_kb / 1000))
    n_indel = int(round(n_sites * indel_share))
    sites = []                                   # (pos, ref, alt)
    inside = runs[(runs[:, 0] >= 1)
                  & (runs[:, 0] + runs[:, 1] * runs[:, 2] < n - 1)]
    for s, p, reps in inside[rng.permutation(len(inside))[:n_indel]]:
        s, p, reps = int(s), int(p), int(reps)
        units = int(rng.integers(1, max(1, min(6 // p, reps - 1)) + 1))
        size = units * p
        end = s + p * reps                       # one past the run
        if rng.random() < 0.5:                   # duplicate `units` units
            q = int(rng.integers(s + size - 1, end))
            sites.append((q, genome[q], genome[q] + genome[q - size + 1:q + 1]))
        else:                                    # drop `units` units
            q = int(rng.integers(s - 1, end - size))
            sites.append((q, genome[q:q + size + 1], genome[q]))
    for q in rng.integers(1, n - 1, n_sites - len(sites)):
        q = int(q)
        alt = "ACGT"[("ACGT".index(genome[q]) + int(rng.integers(1, 4))) % 4]
        sites.append((q, genome[q], alt))
    sites.sort()
    out, stop = [], 0
    for q, ref, alt in sites:
        gt = ("1|0", "0|1", "1|1")[int(rng.integers(0, 3))]
        if q < stop:                             # overlaps the previous one
            continue
        out.append(VcfRecord(contig=contig, pos=q, id=".", alleles=(ref, alt),
                             qual=60.0, filter="PASS", info=".", fmt="GT",
                             sample=gt))
        stop = q + len(ref)
    return out
