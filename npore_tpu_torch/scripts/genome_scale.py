"""Genome-scale proof harness: a multi-Mbp contig through the whole port
(the port of ``scripts/genome_scale.py``).

The reference operates at whole-contig scale (standardize realigns ~60 Mbp
chr20, reference: src/bam.pyx:93-123; stats/bed stream genomes in chunks,
src/realign.py:53-55, src/bed.py:38). This harness builds a synthetic
multi-Mbp contig with realistic repeat density plus thousands of reads,
then drives realign, stats recalc, bed, and standardize_vcf end-to-end,
recording wall time, peak RSS, and sampled-window golden parity.

    python -m npore_tpu_torch.scripts.genome_scale [--mbp 5] [--reads 2000]
        [--engine cuda|torch|golden] [--parity_sample 8]
        [--std_contig contig1|contig2] [--stages realign,stats,bed,std]
        [--workdir DIR]

``--engine`` (default ``cuda``: kernels K4, K1 and K2 on the card; ``torch``:
their plain PyTorch versions on the CPU) drives both the realign and the
standardize stage. Prints one JSON line per stage plus a summary line.
Fixture generation is cached in the workdir keyed by (mbp, reads, seed);
the fixtures are byte-identical to the JAX script's for the same key.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

from ..engine.realigner import ENGINES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_fixtures(workdir: str, mbp: float, n_reads: int, seed: int):
    from ..io.bam_writer import write_bam
    from ..io.cigar import collapse_cigar
    from ..io.fasta import write_fasta
    from ..io.sam import SamRecord
    from ..io.vcf import VcfRecord, write_vcf
    from ..testing.synth import make_genome, make_read, md_tag

    tag = f"g{mbp:g}m_r{n_reads}_s{seed}v2"
    ref_fa = os.path.join(workdir, f"{tag}.fasta")
    bam = os.path.join(workdir, f"{tag}.bam")
    vcf = os.path.join(workdir, f"{tag}.vcf.gz")
    bed = os.path.join(workdir, f"{tag}.bed")
    if all(os.path.exists(p) for p in (ref_fa, bam, vcf, bed)):
        return ref_fa, bam, vcf, bed

    rng = np.random.default_rng(seed)
    n_bases = int(mbp * 1e6)
    t0 = time.perf_counter()
    contig = make_genome(rng, n_bases)
    # contig2: small companion contig so CPU runs can exercise the
    # whole-contig standardize path at affordable cost
    contig2 = make_genome(rng, 15000)
    write_fasta(ref_fa, {"contig1": contig, "contig2": contig2})

    records = []
    for i in range(n_reads):
        rlen = int(rng.integers(400, 1500))
        start = int(rng.integers(0, n_bases - rlen - 1))
        window = contig[start:start + rlen]
        pos, seq, cig = make_read(rng, window, min_len=rlen - 1,
                                  max_len=rlen - 1)
        pos += start
        records.append(SamRecord(
            qname=f"gr{i}", flag=0, rname="contig1", pos=pos, mapq=60,
            cigar=collapse_cigar(cig), seq=seq, qual="I" * len(seq),
            tags={"HP": ("i", int(rng.integers(0, 3))),
                  "MD": ("Z", md_tag(contig, pos, cig))}))
    records.sort(key=lambda r: r.pos)
    write_bam(bam, ["contig1"], [n_bases], records)

    header = ["##fileformat=VCFv4.2",
              f"##contig=<ID=contig1,length={n_bases}>",
              f"##contig=<ID=contig2,length={len(contig2)}>",
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    vrecs = []
    sites = [("contig1", int(p)) for p in
             sorted(rng.integers(100, n_bases - 100, max(20, n_reads // 8)))]
    sites += [("contig2", int(p)) for p in
              sorted(rng.integers(100, len(contig2) - 100, 8))]
    for ctg, p in sites:
        src_seq = contig if ctg == "contig1" else contig2
        ref_b = src_seq[p]
        alt = "ACGT"[("ACGT".index(ref_b) + 1) % 4]
        gt = ["1|0", "0|1", "1|1"][int(rng.integers(0, 3))]
        vrecs.append(VcfRecord(contig=ctg, pos=p, id=".",
                               alleles=(ref_b, alt), qual=30.0,
                               filter="PASS", info=".", fmt="GT", sample=gt))
    # dedup positions (keep first)
    seen = set()
    vrecs = [r for r in vrecs
             if (r.contig, r.pos) not in seen
             and not seen.add((r.contig, r.pos))]
    write_vcf(vcf, header, vrecs)
    with open(bed, "w") as fh:
        fh.write(f"contig1\t0\t{n_bases}\n")
    print(json.dumps({"stage": "generate", "mbp": mbp, "reads": n_reads,
                      "secs": round(time.perf_counter() - t0, 2)}),
          flush=True)
    return ref_fa, bam, vcf, bed


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=5.0)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--engine", default="cuda", choices=list(ENGINES),
                    help="engine of the realign and standardize stages")
    ap.add_argument("--parity_sample", type=int, default=8)
    ap.add_argument("--std_contig", default="contig2",
                    help="contig for the whole-contig standardize stage "
                         "(contig2 = small companion; contig1 = full scale)")
    ap.add_argument("--stages", default="realign,stats,bed,std")
    ap.add_argument("--max_reads", type=int, default=0,
                    help="cap reads through realign (0 = all)")
    ap.add_argument("--workdir",
                    default=os.path.expanduser("~/.cache/npore_genome_torch"))
    return ap


def main(argv=None) -> int:
    args = argparser().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    stages = set(args.stages.split(","))

    ref_fa, bam, vcf, bed = build_fixtures(args.workdir, args.mbp,
                                           args.reads, args.seed)
    stats_dir = os.path.join(REPO, "guppy5_stats")
    out = {}

    if "realign" in stages:
        from ..cli.realign import main as realign_main
        pre = os.path.join(args.workdir, "gs_realign")
        argv = ["--bam", bam, "--ref", ref_fa, "--out_prefix", pre,
                "--stats_dir", stats_dir, "--engine", args.engine]
        if args.max_reads:
            argv += ["--max_reads", str(args.max_reads)]
        t0 = time.perf_counter()
        rc = realign_main(argv)
        dt = time.perf_counter() - t0
        assert rc == 0
        n_out = sum(1 for l in open(pre + ".sam") if not l.startswith("@"))
        n_expect = args.max_reads or args.reads
        assert n_out == n_expect, (n_out, n_expect)
        out["realign"] = {"secs": round(dt, 2),
                          "reads_per_sec": round(n_out / dt, 2),
                          "rss_mb": round(rss_mb(), 1)}
        print(json.dumps({"stage": "realign", **out["realign"]}), flush=True)

        # sampled-window golden parity at scale
        if args.parity_sample:
            from ..config import AlignConfig
            from ..golden.align import align as golden_align
            from ..io.bam import open_alignment_file
            from ..io.cigar import finalize_cigar
            from ..model.scores import (calc_score_matrices,
                                        load_confusion_matrices)
            subs, nps, inss, dels = load_confusion_matrices(stats_dir)
            ss, ns, _, _ = calc_score_matrices(subs, nps, inss, dels)
            got = {l.split("\t")[0]: l.split("\t")[5]
                   for l in open(pre + ".sam") if not l.startswith("@")}
            rng = np.random.default_rng(0)
            reads = []
            for rec in open_alignment_file(bam):
                reads.append(rec)
                if len(reads) >= n_expect:
                    break
            idx = rng.choice(len(reads), size=min(args.parity_sample,
                                                  len(reads)), replace=False)
            for i in idx:
                rec = reads[int(i)]
                int_ref, int_seq, ecig = rec.aln
                want = finalize_cigar(
                    golden_align(int_ref, int_seq, ecig, ss, ns,
                                 AlignConfig()), int_ref, int_seq)
                assert got[rec.qname] == want, rec.qname
            print(json.dumps({"stage": "parity",
                              "sampled": int(len(idx)), "ok": True}),
                  flush=True)

    if "stats" in stages:
        from ..config import RealignConfig
        from ..engine.stats import calc_confusion_matrices_bam
        from ..io.fasta import FastaFile
        t0 = time.perf_counter()
        n_b = int(args.mbp * 1e6)
        regions = [("contig1", 0, n_b)]
        fa = FastaFile(ref_fa)
        rcfg = RealignConfig(bam=bam, ref=ref_fa, stats_dir=stats_dir)
        cms = calc_confusion_matrices_bam(bam, fa, regions, rcfg)
        dt = time.perf_counter() - t0
        out["stats"] = {"secs": round(dt, 2),
                        "chunks": n_b // rcfg.chunk_width + 1,
                        "subs_total": int(cms[0].sum()),
                        "rss_mb": round(rss_mb(), 1)}
        print(json.dumps({"stage": "stats", **out["stats"]}), flush=True)

    if "bed" in stages:
        from ..cli.bed import main as bed_main
        pre = os.path.join(args.workdir, "gs_bed")
        t0 = time.perf_counter()
        rc = bed_main(["--ref", ref_fa, "--out_prefix", pre, "--bed", bed])
        dt = time.perf_counter() - t0
        assert rc == 0
        sizes = {}
        for n in list(range(7)) + ["all"]:
            p = f"{pre}_{n}.bed"
            if os.path.exists(p):
                sizes[str(n)] = sum(1 for _ in open(p))
        out["bed"] = {"secs": round(dt, 2), "regions": sizes,
                      "rss_mb": round(rss_mb(), 1)}
        print(json.dumps({"stage": "bed", **out["bed"]}), flush=True)

    if "std" in stages:
        from ..cli.standardize_vcf import main as std_main
        from ..io.vcf import VcfReader
        pre = os.path.join(args.workdir, "gs_std")
        argv = ["--vcf", vcf, "--ref", ref_fa, "--out_prefix", pre,
                "--stats_dir", stats_dir, "--contig", args.std_contig,
                "--engine", args.engine]
        t0 = time.perf_counter()
        rc = std_main(argv)
        dt = time.perf_counter() - t0
        assert rc == 0
        n_std = sum(1 for _ in VcfReader(pre + ".vcf.gz"))
        assert n_std > 0
        out["std"] = {"secs": round(dt, 2), "records": n_std,
                      "rss_mb": round(rss_mb(), 1)}
        print(json.dumps({"stage": "std", **out["std"]}), flush=True)

    print(json.dumps({"stage": "summary", "mbp": args.mbp,
                      "reads": args.reads, "engine": args.engine,
                      "peak_rss_mb": round(rss_mb(), 1), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
