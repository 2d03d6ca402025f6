"""Seeded reads at nanopore lengths on a repeat-dense contig, made in bulk
with numpy.

The contig is ``synth.genome_with_runs``' (an n-polymer run of period 1-6
and 3-20 units about every 150 bp). Read lengths are log-normal (median
10 kb, sigma 0.6, clipped to 1-60 kb), as whole-genome nanopore reads
aligned with ``minimap2 -ax map-ont`` run; a length is the reference span
a read covers, as ``synth.make_read``'s is. Each read copies its span with
``make_read``'s default noise and semantics: a deletion (3%) drops the
base; an insertion (5%) puts a random base before it, and the base then
takes a random substitute, as does a substitution (3%). The reads carry
their true extended '=XID' CIGARs, and ``write_long_reads`` writes them as
a FASTA and a coordinate-sorted BAM with MD and HP tags.

A reduced run on the CPU, 40 reads of 1-3 kb on a 300 kb contig::

    python -c "from npore_tpu_torch.testing import long_reads as lr; \\
        c, _, r = lr.make_long_reads(23, 40, 300_000, median=2_000, \\
                                     lengths=(1_000, 3_000)); \\
        print(lr.write_long_reads('/tmp/lr', c, r))"

then ``python -m npore_tpu_torch.cli.realign --bam /tmp/lr/long.bam
--ref /tmp/lr/long.fasta --out_prefix /tmp/lr/out --stats_dir
guppy5_stats --engine torch``.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from . import synth

MEDIAN = 10_000             # bp, the log-normal's median
SIGMA = 0.6                 # of the length's natural log
LENGTHS = (1_000, 60_000)   # bp, the clip
P_SUB, P_INS, P_DEL = 0.03, 0.05, 0.03     # synth.make_read's defaults

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_EQ, _X, _I, _D = (ord(c) for c in "=XID")

Read = Tuple[int, str, str]     # (0-based position, seq, extended CIGAR)


def read_lengths(rng, n: int, median: float = MEDIAN, sigma: float = SIGMA,
                 lengths: Tuple[int, int] = LENGTHS) -> np.ndarray:
    """``n`` log-normal read lengths (reference spans), clipped."""
    x = np.exp(rng.normal(np.log(median), sigma, n))
    return np.clip(np.rint(x), *lengths).astype(np.int64)


def noisy_copy(rng, ref: np.ndarray, p_sub: float = P_SUB,
               p_ins: float = P_INS, p_del: float = P_DEL):
    """A read of the ASCII bases ``ref`` (uint8) with ``make_read``'s noise:
    (seq, extended CIGAR) as uint8 ASCII arrays."""
    n = len(ref)
    u = rng.random(n)
    dele = u < p_del
    ins = (u >= p_del) & (u < p_del + p_ins)
    sub = (u >= p_del) & (u < p_del + p_ins + p_sub)
    ins_base = _BASES[rng.integers(0, 4, n)]
    out = np.where(sub, _BASES[rng.integers(0, 4, n)], ref)
    # a reference base emits one CIGAR op (D, = or X), after an I if it
    # takes an insertion; and no seq base (D), one, or two (I)
    c_end = np.cumsum(1 + ins)
    cig = np.empty(int(c_end[-1]) if n else 0, dtype=np.uint8)
    cig[c_end - 1] = np.where(dele, _D, np.where(out == ref, _EQ, _X))
    cig[c_end[ins] - 2] = _I
    s_end = np.cumsum(np.where(dele, 0, 1 + ins))
    seq = np.empty(int(s_end[-1]) if n else 0, dtype=np.uint8)
    seq[s_end[~dele] - 1] = out[~dele]
    seq[s_end[ins] - 2] = ins_base[ins]
    return seq, cig


def make_long_reads(seed: int, n_reads: int, contig_bases: int,
                    median: float = MEDIAN, sigma: float = SIGMA,
                    lengths: Tuple[int, int] = LENGTHS):
    """(contig, runs, reads): ``synth.genome_with_runs``' contig and runs,
    and ``n_reads`` reads sorted by position."""
    rng = np.random.default_rng(seed)
    contig, runs = synth.genome_with_runs(rng, contig_bases)
    ref = np.frombuffer(contig.encode("ascii"), dtype=np.uint8)
    spans = read_lengths(rng, n_reads, median, sigma, lengths)
    if spans.max(initial=0) >= len(ref):
        raise ValueError(f"a read of {spans.max()} bp does not fit a contig "
                         f"of {len(ref)}")
    pos = rng.integers(0, len(ref) - spans)
    reads = []
    for p, span in zip(pos.tolist(), spans.tolist()):
        seq, cig = noisy_copy(rng, ref[p:p + span])
        reads.append((p, seq.tobytes().decode("ascii"),
                      cig.tobytes().decode("ascii")))
    reads.sort(key=lambda r: r[0])
    return contig, runs, reads


def write_long_reads(d: str, contig: str, reads: Sequence[Read],
                     seed: int = 0) -> Tuple[str, str]:
    """``reads`` on ``contig`` (named ``ctg``) as ``{d}/long.fasta`` and a
    coordinate-sorted ``{d}/long.bam`` with MD and a seeded HP tag (as
    chip_smoke's ``write_scale_bam`` writes its reads); the paths."""
    from ..io.bam_writer import write_bam
    from ..io.cigar import collapse_cigar
    from ..io.fasta import write_fasta
    from ..io.sam import SamRecord
    os.makedirs(d, exist_ok=True)
    hp = np.random.default_rng(seed).integers(0, 3, len(reads))
    records: List[SamRecord] = [SamRecord(
        qname=f"lr{i}", flag=0, rname="ctg", pos=pos, mapq=60,
        cigar=collapse_cigar(cig), seq=seq, qual="I" * len(seq),
        tags={"HP": ("i", int(h)),
              "MD": ("Z", synth.md_tag(contig, pos, cig))})
        for i, ((pos, seq, cig), h) in enumerate(zip(reads, hp))]
    fasta, bam = os.path.join(d, "long.fasta"), os.path.join(d, "long.bam")
    write_fasta(fasta, {"ctg": contig})
    write_bam(bam, ["ctg"], [len(contig)], records)
    return fasta, bam
