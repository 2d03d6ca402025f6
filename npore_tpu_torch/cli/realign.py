"""Read realignment CLI on PyTorch/CUDA (reference: src/realign.py).

Usage: python -m npore_tpu_torch.cli.realign --bam in.bam --ref ref.fasta \
           --out_prefix out [--stats_dir ./stats] [--engine cuda|torch|golden]
"""
from __future__ import annotations

import argparse
import os
import sys
from time import perf_counter
from typing import Optional

from .. import __version__
from ..config import AlignConfig, RealignConfig
from ..engine.realigner import ENGINES, Realigner
from ..engine.regions import get_bam_regions
from ..io.bam import open_alignment_file
from ..io.fasta import FastaFile
from ..io.sam import make_header
from ..model.scores import (calc_score_matrices, load_confusion_matrices,
                            save_confusion_matrices)


def argparser() -> argparse.ArgumentParser:
    """Flags mirror the reference (src/realign.py:15-71)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--bam", required=True, help="Input BAM to be realigned.")
    p.add_argument("--ref", required=True, help="Input reference FASTA.")
    p.add_argument("--out_prefix", required=True, help="Output SAM file prefix.")
    p.add_argument("--contig", type=str)
    p.add_argument("--contig_beg", type=int)
    p.add_argument("--contig_end", type=int)
    p.add_argument("--contigs", type=str)
    p.add_argument("--max_reads", type=int, default=0)
    p.add_argument("--bed", type=str)
    p.add_argument("--max_n", type=int, default=6)
    p.add_argument("--max_l", type=int, default=100)
    p.add_argument("--chunk_width", type=int, default=100000)
    p.add_argument("--stats_dir", default="./stats")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--recalc_cms", action="store_true")
    p.add_argument("--recalc_exit", action="store_true")
    p.add_argument("--engine", default="cuda", choices=list(ENGINES),
                   help="DP engine: CUDA kernels, plain PyTorch (CPU), or "
                        "the golden spec (new; no reference equivalent).")
    p.add_argument("--batch_reads", type=int, default=512)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Write a torch.profiler trace of the realignment "
                        "stage to this directory (new; view with Perfetto).")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Total participating hosts (only 1 is supported).")
    p.add_argument("--host_id", type=int, default=None)
    p.add_argument("--coordinator", type=str, default=None)
    return p


def config_from_args(args) -> RealignConfig:
    return RealignConfig(
        bam=args.bam, ref=args.ref, out_prefix=args.out_prefix,
        stats_dir=args.stats_dir, contig=args.contig,
        contig_beg=args.contig_beg, contig_end=args.contig_end,
        contigs=args.contigs, bed=args.bed, max_reads=args.max_reads,
        chunk_width=args.chunk_width, recalc_cms=args.recalc_cms,
        recalc_exit=args.recalc_exit, plot=args.plot,
        align=AlignConfig(max_n=args.max_n, max_l=args.max_l),
        batch_reads=args.batch_reads, engine=args.engine)


def get_read_data(bam, regions, max_reads: int = 0):
    """Stream primary mapped reads in the selected regions
    (reference: src/bam.pyx:18-47)."""
    kept = 0
    for ctg, start, stop in regions:
        for read in bam.fetch(ctg, start, stop):
            if max_reads and kept >= max_reads:
                return
            if (not read.is_secondary and not read.is_supplementary
                    and not read.is_unmapped):
                kept += 1
                yield read


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> Optional[Realigner]:
    """The CLI's work; returns the Realigner that realigned the reads
    (None when the run stops before realignment)."""
    args = argparser().parse_args(argv)
    if args.num_hosts > 1:
        raise NotImplementedError("multi-host is a later slice of the port")
    cfg = config_from_args(args)

    print("> selecting BAM regions")
    ref_fa = FastaFile(cfg.ref)
    bam = open_alignment_file(cfg.bam)
    regions = get_bam_regions(cfg, ref_fa, bam)

    # auto-recalculate stats when any matrix is missing (src/realign.py:124-128)
    have_all = all(os.path.isfile(os.path.join(cfg.stats_dir, f"{n}_cm.npy"))
                   for n in ("subs", "nps", "inss", "dels"))
    if cfg.recalc_cms or not have_all:
        print("> calculating confusion matrices")
        from ..engine.stats import calc_confusion_matrices_bam
        subs, nps, inss, dels = calc_confusion_matrices_bam(
            bam_path=cfg.bam, ref_fa=ref_fa, regions=regions, cfg=cfg)
        save_confusion_matrices(cfg.stats_dir, subs, nps, inss, dels)
        if cfg.recalc_exit:
            return None
    else:
        print("> loading confusion matrices")
        subs, nps, inss, dels = load_confusion_matrices(cfg.stats_dir)

    print("> calculating score matrices")
    sub_scores, np_scores, _, _ = calc_score_matrices(
        subs, nps, inss, dels, cfg.align.max_n, cfg.align.max_l)

    if cfg.plot:
        from ..model.plots import (plot_confusion_matrices,
                                           plot_np_score_matrices)
        print("> plotting confusion and score matrices")
        plot_confusion_matrices(subs, nps, inss, dels, cfg.stats_dir,
                                cfg.align.max_n)
        plot_np_score_matrices(np_scores, cfg.stats_dir, cfg.align.max_n)
        return None

    print("> creating output SAM")
    header = make_header(bam.references, bam.lengths, __version__)
    out_path = f"{cfg.out_prefix}.sam"
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)

    print("> computing batched read realignments")
    start = perf_counter()
    realigner = Realigner(sub_scores, np_scores, cfg.align, engine=cfg.engine)
    prof = None
    if args.profile_dir:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if realigner.engine == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    n = 0
    with open(out_path, "w") as fh:
        for line in header:
            fh.write(line + "\n")
        reads = get_read_data(bam, regions, cfg.max_reads)
        for rec in realigner.realign_records(reads, cfg.batch_reads):
            fh.write(rec.to_line() + "\n")
            n += 1
            if n % 1000 == 0:
                print(f"\r    {n} reads realigned "
                      f"({n/(perf_counter()-start):.0f} reads/s)",
                      end="", flush=True)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "realign_trace.json")
        prof.export_chrome_trace(trace)
        print(f"    profiler trace written to {trace}")
    for e in realigner.errors:
        print(f"WARNING: {e}")
    for s in realigner.skipped:
        print(f"WARNING: {s}")
    if realigner.skipped:
        print(f"    {len(realigner.skipped)} reads skipped (malformed)")
    if realigner.bail_count:
        print(f"    {realigner.bail_count} alignments used the golden "
              f"fallback")
    print(f"\r    {n} reads realigned; runtime: {perf_counter()-start:.2f}s")
    return realigner


if __name__ == "__main__":
    sys.exit(main())
