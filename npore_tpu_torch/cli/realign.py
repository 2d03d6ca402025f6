"""Read realignment CLI on PyTorch/CUDA (reference: src/realign.py).

Usage: python -m npore_tpu_torch.cli.realign --bam in.bam --ref ref.fasta \
           --out_prefix out [--stats_dir ./stats] [--engine cuda|torch|golden]
           [--num_hosts N --host_id I --coordinator HOST:PORT]

With ``--num_hosts`` N > 1, N processes (one a rank) realign region
shards, or read stripes when there are fewer regions than ranks, each into
``{out_prefix}.h{I}.sam``; rank 0 merges them into ``{out_prefix}.sam``.
The ranks talk over gloo (``parallel/distributed.py``).

With ``NPORE_TIMING=1`` the tracer (``tracing``) records the call's
spans: ``realign.call`` and, under it, ``realign.fasta``,
``realign.region_count`` (one ``regions.count`` a contig),
``realign.tables``, ``realign.header`` and ``realign.stage`` (the printed
``runtime:``), which holds ``realign.engine_init``, one
``realign.sam_write`` a batch and the pipeline's spans
(``engine/realigner.py``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from time import perf_counter, perf_counter_ns
from typing import Optional

from .. import __version__, tracing
from ..config import AlignConfig, RealignConfig
from ..engine.bam_stream import SortedBamReader, confusion_counts, file_order
from ..engine.realigner import ENGINES, Realigner
from ..engine.regions import get_bam_regions
from ..io.bam import open_alignment_file
from ..io.bam_native import native_available
from ..io.fasta import FastaFile
from ..io.sam import make_header
from ..model.scores import (calc_score_matrices, load_confusion_matrices,
                            save_confusion_matrices)
from ..parallel.distributed import (allreduce_counts, barrier, host_out_path,
                                    init_distributed, merge_host_sams,
                                    shard_regions, shutdown, stripe_reads)


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
                   help="Write a chrome trace of the call to "
                        "DIR/realign_trace.json: the card's kernels and "
                        "copies (torch.profiler, CUDA activity only; "
                        "--engine cuda) and, with NPORE_TIMING=1, the "
                        "program's spans, one row a thread (new; open in "
                        "https://ui.perfetto.dev or chrome://tracing).")
    p.add_argument("--num_hosts", type=int, default=1,
                   help="Multi-host SPMD: total participating ranks "
                        "(new; every rank runs this CLI with the same "
                        "args plus its --host_id).")
    p.add_argument("--host_id", type=int, default=None,
                   help="This rank's index in [0, num_hosts).")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the torch.distributed TCP store "
                        "(rank 0 serves it).")
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


# the records get_read_data drops: secondary, supplementary, unmapped
SKIP_FLAGS = 0x100 | 0x800 | 0x4


def open_bam(path: str, prep: bool = True, skip_flags: int = 0):
    """A BAM through ``engine.bam_stream.SortedBamReader`` (its contigs in
    one pass; the decoder drops ``skip_flags`` records before it builds
    them), anything else (or a BAM without the C++ library) as
    ``open_alignment_file`` opens it.

    The reads come with ``skip_flags=SKIP_FLAGS``: the decoder preps
    every record it keeps, rebuilding its reference from the MD tag over
    its query, and a record with SEQ ``*`` and an MD tag (a secondary
    alignment from ``minimap2 --MD``) has no query: ``md_to_ref``
    (native/bamio.cpp:379) reads past the empty buffer, through a null
    pointer where the record is the first of a batch (SIGSEGV). The
    region count needs no prep at all."""
    if path.endswith(".bam") and native_available():
        return SortedBamReader(path, prep, skip_flags)
    return open_alignment_file(path, prep)


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
    (None when the run stops before realignment). With ``--num_hosts`` N >
    1 this process is one of N ranks: it joins the process group, and
    leaves it when the run ends."""
    args = argparser().parse_args(argv)
    tracing.set_from_env()
    host_id, num_hosts = init_distributed(args.coordinator, args.num_hosts,
                                          args.host_id)
    try:
        with _profiled(args.profile_dir, args.engine), \
                tracing.span("realign.call"):
            return _run(args, host_id, num_hosts)
    finally:
        if num_hosts > 1:
            shutdown()


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], engine: str):
    """With ``profile_dir``, a chrome trace of the body in
    ``profile_dir/realign_trace.json``: the card's activity under
    torch.profiler (``--engine cuda``), and the tracer's spans on the
    profiler's timeline."""
    if not profile_dir:
        yield
        return
    prof = None
    if engine == "cuda":
        import torch
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    clock = (time.time_ns(), perf_counter_ns())
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    trace = os.path.join(profile_dir, "realign_trace.json")
    if prof is not None:
        prof.export_chrome_trace(trace)
    tracing.add_to_chrome_trace(trace, clock)
    print(f"    profiler trace written to {trace}")


def _run(args, host_id: int, num_hosts: int) -> Optional[Realigner]:
    cfg = config_from_args(args)

    print("> selecting BAM regions")
    with tracing.span("realign.fasta"):
        ref_fa = FastaFile(cfg.ref)
    with tracing.span("realign.region_count"):
        bam = open_bam(cfg.bam, prep=False)     # the count needs no prep
        regions = get_bam_regions(cfg, ref_fa, bam)
    stripe = False
    if num_hosts > 1:
        if len(regions) >= num_hosts:
            regions = shard_regions(regions, num_hosts, host_id)
            print(f"    host {host_id}/{num_hosts}: {len(regions)} region "
                  f"shards")
        else:
            # fewer regions than hosts: fall back to read-level striping
            # (all hosts stream all regions, keep every num_hosts-th read)
            stripe = True
            print(f"    host {host_id}/{num_hosts}: read-stripe mode "
                  f"({len(regions)} regions < {num_hosts} hosts)")

    tables_t0 = perf_counter_ns()
    # auto-recalculate stats when any matrix is missing (src/realign.py:124-128)
    have_all = all(os.path.isfile(os.path.join(cfg.stats_dir, f"{n}_cm.npy"))
                   for n in ("subs", "nps", "inss", "dels"))
    if cfg.recalc_cms or not have_all:
        print("> calculating confusion matrices")
        # stats must shard by REGION even in read-stripe mode: each count
        # contributes once globally or the allreduce multiplies every
        # count by num_hosts, which shifts the eps-smoothed score
        # matrices (model/scores.py) vs a single-host run
        stat_regions = (shard_regions(regions, num_hosts, host_id)
                        if stripe else regions)
        subs, nps, inss, dels = confusion_counts(cfg.bam, ref_fa,
                                                 stat_regions, cfg)
        if num_hosts > 1:      # all-reduce each host's region-shard counts
            subs, nps, inss, dels = allreduce_counts([subs, nps, inss, dels])
        if host_id == 0:
            save_confusion_matrices(cfg.stats_dir, subs, nps, inss, dels)
        if cfg.recalc_exit:
            return None
    else:
        print("> loading confusion matrices")
        subs, nps, inss, dels = load_confusion_matrices(cfg.stats_dir)

    print("> calculating score matrices")
    sub_scores, np_scores, _, _ = calc_score_matrices(
        subs, nps, inss, dels, cfg.align.max_n, cfg.align.max_l)
    tracing.record("realign.tables", tables_t0, perf_counter_ns())

    if cfg.plot:
        from ..model.plots import (plot_confusion_matrices,
                                           plot_np_score_matrices)
        print("> plotting confusion and score matrices")
        plot_confusion_matrices(subs, nps, inss, dels, cfg.stats_dir,
                                cfg.align.max_n)
        plot_np_score_matrices(np_scores, cfg.stats_dir, cfg.align.max_n)
        return None

    print("> creating output SAM")
    with tracing.span("realign.header"):
        header = make_header(bam.references, bam.lengths, __version__)
        out_path = host_out_path(cfg.out_prefix, host_id, num_hosts)
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)

    print("> computing batched read realignments")
    with tracing.span("realign.stage"):
        start = perf_counter()
        with tracing.span("realign.engine_init"):
            realigner = Realigner(sub_scores, np_scores, cfg.align,
                                  engine=cfg.engine)
        n = 0
        with open(out_path, "w") as fh:
            for line in header:
                fh.write(line + "\n")
            if num_hosts > 1 and not stripe:
                # a shard's regions in the file's order, so that the reader
                # reads on (rank 0's merge sorts the records anyway)
                regions = file_order(bam.references, regions)
            reads = get_read_data(open_bam(cfg.bam, skip_flags=SKIP_FLAGS),
                                  regions, cfg.max_reads)
            if stripe:
                reads = stripe_reads(reads, num_hosts, host_id)
            for b, recs in realigner.realign_batches(reads, cfg.batch_reads):
                with tracing.span("realign.sam_write", batch=b):
                    for rec in recs:
                        fh.write(rec.to_line() + "\n")
                n += len(recs)
                if n // 1000 > (n - len(recs)) // 1000:
                    print(f"\r    {n} reads realigned "
                          f"({n/(perf_counter()-start):.0f} reads/s)",
                          end="", flush=True)
        for e in realigner.errors:
            print(f"WARNING: {e}")
        for s in realigner.skipped:
            print(f"WARNING: {s}")
        if realigner.skipped:
            print(f"    {len(realigner.skipped)} reads skipped (malformed)")
        if realigner.bail_count:
            print(f"    {realigner.bail_count} alignments used the golden "
                  f"fallback")
        print(f"\r    {n} reads realigned; runtime: "
              f"{perf_counter()-start:.2f}s")
    if num_hosts > 1:
        barrier("realign-sam")
        if host_id == 0:
            merged = merge_host_sams(cfg.out_prefix, num_hosts)
            print(f"    merged {num_hosts} host shards into {merged}")
    return realigner


if __name__ == "__main__":
    sys.exit(main())
