"""n-polymer BED generation CLI (reference: src/bed.py).

Scans the reference FASTA with the native n-polymer scanner and emits, for
each period n, a BED of repeat regions ({prefix}_{n}.bed), a merged union
({prefix}_all.bed), and the complement ({prefix}_0.bed). The reference
shells out to bedtools/sed/sort (src/bed.py:80-142); here interval
sort/merge/complement are in-process numpy. The port of
``npore_tpu/cli/bed.py``, which has no device work; its ``spawn`` workers
import only this module.

Usage: python -m npore_tpu_torch.cli.bed --ref ref.fasta --bed regions.bed \
           --out_prefix out
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from time import perf_counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..native import np_info
from ..constants import bases_to_int
from ..io.fasta import FastaFile

Region = Tuple[str, int, int]


def argparser() -> argparse.ArgumentParser:
    """Flags mirror the reference (src/bed.py:14-53)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--ref", required=True, help="Input reference FASTA.")
    p.add_argument("--bed", type=str,
                   help="BED file of regions (also defines the .genome "
                        "extent for the complement).")
    p.add_argument("--contig", type=str)
    p.add_argument("--contig_beg", type=int)
    p.add_argument("--contig_end", type=int)
    p.add_argument("--contigs", type=str)
    p.add_argument("--chunk_width", type=int, default=1000000)
    p.add_argument("--max_n", type=int, default=6)
    p.add_argument("--max_l", type=int, default=100)
    p.add_argument("--out_prefix", required=True,
                   help="Output BED file prefix.")
    p.add_argument("--processes", type=int, default=0,
                   help="Chunk-scan worker processes (0 = all cores; "
                        "reference: src/bed.py:161-162 mp.Pool).")
    return p


def get_np_regions(ref_seq: np.ndarray, ctg: str, start: int, max_n: int
                   ) -> List[List[Region]]:
    """Per-n raw repeat regions (ctg, pos, pos + n*L) for every repeat start
    (reference: src/bed.py:56-76), vectorized over positions."""
    info = np_info(ref_seq, max_n)
    out: List[List[Region]] = [[] for _ in range(max_n)]
    for n in range(1, max_n + 1):
        ni = n - 1
        starts = np.flatnonzero((info[:, 0, ni] > 0) & (info[:, 1, ni] == 0))
        lens = info[starts, 0, ni].astype(np.int64)
        for s, l in zip(starts.tolist(), lens.tolist()):
            out[ni].append((ctg, start + s, start + s + n * l))
    return out


def _ctg_key(ctg: str):
    """Reference sort order: strip 'chr', numeric-sort contig names
    (src/bed.py:95-122 sed/sort pipelines)."""
    base = ctg[3:] if ctg.startswith("chr") else ctg
    m = re.match(r"^(\d+)", base)
    return (0, int(m.group(1)), base) if m else (1, 0, base)


def sort_merge(regions: Sequence[Region]) -> List[Region]:
    """bedtools-merge equivalent: sort, merge touching/overlapping."""
    regs = sorted(regions, key=lambda r: (_ctg_key(r[0]), r[1], r[2]))
    out: List[Region] = []
    for ctg, beg, end in regs:
        if out and out[-1][0] == ctg and beg <= out[-1][2]:
            if end > out[-1][2]:
                out[-1] = (ctg, out[-1][1], end)
        else:
            out.append((ctg, beg, end))
    return out


def complement(regions: Sequence[Region],
               genome: Sequence[Tuple[str, int]]) -> List[Region]:
    """bedtools-complement -L equivalent: gaps within listed contigs."""
    by_ctg: Dict[str, List[Region]] = {}
    for r in regions:
        by_ctg.setdefault(r[0], []).append(r)
    out: List[Region] = []
    for ctg, length in genome:
        pos = 0
        for _, beg, end in sort_merge(by_ctg.get(ctg, [])):
            if beg > pos:
                out.append((ctg, pos, beg))
            pos = max(pos, end)
        if pos < length:
            out.append((ctg, pos, length))
    return out


def write_bed(path: str, regions: Sequence[Region]) -> None:
    with open(path, "w") as fh:
        for ctg, beg, end in regions:
            fh.write(f"{ctg}\t{beg}\t{end}\n")


def save_np_region_beds(np_regions, args, max_n: int, slop: int = 1) -> None:
    """Per-n merged BEDs + union + complement (reference: src/bed.py:80-142,
    slop=1 on both sides)."""
    print(f"> saving n-polymer BEDs, n = 1-{max_n}")
    t0 = perf_counter()
    all_regs: List[Region] = []
    for n in range(1, max_n + 1):
        ni = n - 1
        slopped = [(ctg, max(0, beg - slop), end + slop)
                   for ctg_data in np_regions for ctg, beg, end in ctg_data[ni]]
        merged = sort_merge(slopped)
        write_bed(f"{args.out_prefix}_{n}.bed", merged)
        all_regs.extend(merged)
    print(f"    runtime: {perf_counter()-t0:.2f}s")

    print("> merging n-polymer BEDs")
    t0 = perf_counter()
    union = sort_merge(all_regs)
    write_bed(f"{args.out_prefix}_all.bed", union)
    print(f"    runtime: {perf_counter()-t0:.2f}s")

    print("> converting supplied .BED to .GENOME file")
    if not args.bed:
        sys.exit("ERROR: '--bed' must be supplied.")
    if not args.bed.endswith(".bed"):
        sys.exit("ERROR: '--bed' is not BED file.")
    genome: List[Tuple[str, int]] = []
    with open(args.bed) as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 3:
                genome.append((f[0], int(f[2])))
    with open(args.bed[:-4] + ".genome", "w") as fh:
        for ctg, ln in genome:
            fh.write(f"{ctg}\t{ln}\n")

    print("> finding complement")
    t0 = perf_counter()
    write_bed(f"{args.out_prefix}_0.bed", complement(union, genome))
    print(f"    runtime: {perf_counter()-t0:.2f}s")


_job_fastas = {}


def _np_regions_job(job):
    """Pool worker: repeat regions of one reference chunk. FASTA handles
    are pid-keyed — forked children never reuse a parent's handle."""
    ref_path, ctg, lo, hi, max_n = job
    key = (os.getpid(), ref_path)
    fa = _job_fastas.get(key)
    if fa is None:
        _job_fastas.clear()
        fa = FastaFile(ref_path)
        _job_fastas[key] = fa
    seq = bases_to_int(fa.fetch(ctg, lo, hi).upper())
    return get_np_regions(seq.astype(np.uint8), ctg, lo, max_n)


def main(argv=None) -> int:
    args = argparser().parse_args(argv)
    ref_fa = FastaFile(args.ref)

    # region selection mirrors the realign CLI (reference: src/bed.py:151-157)
    if args.contig:
        beg = args.contig_beg or 0
        end = args.contig_end or ref_fa.get_reference_length(args.contig)
        regions = [(args.contig, beg, end)]
    elif args.contigs:
        regions = [(c, 0, ref_fa.get_reference_length(c))
                   for c in args.contigs.split(",")]
    elif args.bed:
        regions = []
        with open(args.bed) as fh:
            for line in fh:
                f = line.split("\t")
                if len(f) >= 3:
                    regions.append((f[0], int(f[1]), int(f[2])))
    else:
        regions = [(c, 0, ref_fa.get_reference_length(c))
                   for c in ref_fa.references]

    print("> computing n-polymer regions")
    t0 = perf_counter()
    cw = args.chunk_width
    jobs = []
    for ctg, start, stop in regions:
        for lo in range(start, stop, cw):
            jobs.append((args.ref, ctg, lo, min(lo + cw, stop), args.max_n))
    procs = args.processes or min(os.cpu_count() or 1, len(jobs) or 1)
    if procs > 1 and len(jobs) > 1:
        # chunk-parallel scan (reference: src/bed.py:161-162 pool.map);
        # ordered map keeps output deterministic
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(procs) as pool:
            np_regions = pool.map(_np_regions_job, jobs)
    else:
        np_regions = [_np_regions_job(j) for j in jobs]
    print(f"    runtime: {perf_counter()-t0:.2f}s")

    save_np_region_beds(np_regions, args, args.max_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
