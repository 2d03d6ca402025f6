"""Region selection: resolve --contig/--contigs/--bed/all-contigs into an
explicit region list (reference: src/util.py:16-154)."""
from __future__ import annotations

from typing import List, Tuple

from ..config import RealignConfig
from ..io.fasta import FastaFile

Region = Tuple[str, int, int]


def get_bam_regions(cfg: RealignConfig, ref: FastaFile,
                    bam=None) -> List[Region]:
    """Reference semantics (src/util.py:16-93): a single --contig (optionally
    bounded), comma-separated --contigs, a --bed file, or every BAM contig
    that has reads and exists in the FASTA."""
    if cfg.contig:
        if cfg.contig not in ref:
            raise ValueError(f"contig '{cfg.contig}' not present in "
                             f"'{cfg.ref}'. Valid: {ref.references}")
        if cfg.contigs:
            raise ValueError("can't set both 'contig' and 'contigs'")
        beg = cfg.contig_beg or 0
        max_end = ref.get_reference_length(cfg.contig) - 1
        end = cfg.contig_end if cfg.contig_end else max_end
        return [(cfg.contig, beg, min(max_end, end))]

    if cfg.contigs:
        if cfg.contig_beg or cfg.contig_end:
            raise ValueError("can't set start/endpoints with multiple contigs")
        out = []
        for contig in cfg.contigs.split(","):
            if contig not in ref:
                raise ValueError(f"contig '{contig}' not present in "
                                 f"'{cfg.ref}'. Valid: {ref.references}")
            out.append((contig, 0, ref.get_reference_length(contig) - 1))
        return out

    if cfg.bed:
        with open(cfg.bed) as fh:
            rows = [x.strip().split() for x in fh if x.strip()]
        return [(ctg, int(start), int(stop)) for ctg, start, stop in rows]

    if cfg.contig_beg or cfg.contig_end:
        raise ValueError("'contig' not supplied, but start/endpoints set")

    out = []
    if bam is not None:
        for ctg, l in zip(bam.references, bam.lengths):
            if ctg not in ref:
                print(f"WARNING: contig '{ctg}' in BAM but not FASTA, skipping")
            elif bam.count(ctg, 0, l - 1):
                out.append((ctg, 0, l - 1))
    else:
        for ctg, l in zip(ref.references, ref.lengths):
            out.append((ctg, 0, l - 1))
    return out


def get_ranges(regions: List[Region], chunk_width: int) -> List[Region]:
    """Split regions into chunk_width windows (reference: src/bam.pyx:149-162)."""
    out = []
    for contig, start, stop in regions:
        for st in range(start, stop, chunk_width):
            out.append((contig, st, min(stop, st + chunk_width)))
    return out


def count_chunks(regions: List[Region], chunk_width: int) -> int:
    return sum((end - start + chunk_width - 1) // chunk_width
               for _, start, end in regions)
