"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # without one or on any failed check

Phases:
  1. the card (nvidia-smi name and power limit) and torch version;
  2. build kernels K1 (csrc/band_dp.cu), K2 (csrc/traceback.cu), K3
     (csrc/tier_select.cu) and K4 (csrc/npinfo.cu) with nvcc, one process
     per source, and print ptxas registers and shared memory of each;
  3. the host library: the port's C++ host library must have loaded from
     the port's build directory, and tests/data/reads.bam must open as the
     port's NativeBamReader (so the reads/s below are the C++ host path's);
  4. K1 against the plain PyTorch DP on the fixture reads and 24 synthetic
     reads from each of four length buckets (120-1400 bp), at the
     production AlignConfig(): typ/run planes must be bit-equal;
  5. K2 against the plain traceback on K1's planes: CIGAR bytes, lengths
     and bails must be equal;
  6. the realign CLI with --engine cuda on tests/data/reads.bam must
     reproduce tests/data/npore_realigned.sam (header, 11 fields, tags;
     10/10) with no golden fallback, and launch K4, K1 and K2;
  7. throughput: the fixture replicated x256 (batch 1024) and the mixed
     set, each streamed 5 times (median, min and max reads/s, K4/K1/K2
     launches per pass; K4 must launch once a group, as K1); kernel and
     plain-version times at those groups' shapes (CUDA events, median of
     5, the plain DP's of 3; kernels after one warm-up call),
     with the kernels' outputs required equal to the plain versions' there
     too, and each kernel's bound there. K2 is timed warm (``k2_ms``: the
     same planes relaunched, hot in L2) and cold (``k2_cold_ms``: a 64 MB
     write between launches flushes the 50 MB L2, as on the main path,
     where K1 has just written far more planes than L2 holds). Kernel
     times include the host's launch of the call; ``*_device_ms`` are the
     same calls queued behind a device sleep, the device's work alone. A third
     group, ``long``, holds 6 windows of 20,000 rows cut from synthetic
     reads of ~10.6 kb (max_b_rows = 20000): K1 and K2 warm and
     cold there (``k2_long_ms``), K2 equal to the plain traceback. Each
     group's line carries K2's launch plan (windows a CTA, tile rows,
     shared memory) and the CTAs resident an SM (``tb_cuda.occupancy``).
     [npinfo] on each of the three groups: K4 on a device buffer of 0xA5
     bytes around ``windows.fill_group``'s prefix must give every array of
     ``pack_group``'s host-built buffer byte for byte, and planes equal to
     the plain scan's on the same device tensors; K4's time as paid and
     queued, the plain scan's, K4's bound, its launch plan (threads,
     staged, shared memory) with the CTAs resident an SM
     (``npinfo_cuda.occupancy``) and the H2D bytes of both
     buffers. [host split] on the fixture group: pack_group into a pinned
     buffer and its full copy against fill_group into a pinned prefix, its
     copy and K4, in turns (old, new, new, old): host µs and ms until the
     device holds the buffer. [npinfo] also on ``ntails``, 256 seeded
     reads dense in periodic runs that hold an N and ending in one, where
     the scan must stop at each window's length;
     [host split] fixture pass: one fixture x256 pass under torch.profiler
     (device busy and idle share of the pass's wall time), then one with
     NPORE_TIMING=1 (per-read submit, collect-wait, finalize+emit µs);
     [fuzz]: the ported fuzzer (scripts/fuzz_parity.py), 200 repeat-dense
     cases of seed 0 through the CUDA engine, 200/200 equal to the golden
     aligner; [bench engine]: scripts/bench_engine.py, engine-level reads/s
     on the fixture x256;
  8. K1 wave sweep: K1 on the first B in (132, 924, 1024) windows of the
     fixture's 1024-window group at the same R (CUDA events, median of 5
     after a warm-up call): ms, µs per row, the CTAs resident per SM that
     the kernel's occupancy entry point reports, and the waves that makes;
     the planes must be bit-equal to the plain DP's on that group;
  9. K3 against the plain k-select at the probe's (32, 16, 128), N=256, at
     (7, 20, 96), Q=10, N=300 with seeded start counts, and at
     (4, 16, 160), Q=12, N=100, where the first warp of each row starts at
     0 so the warps of a row vote different tiers: max |diff| 0; kernel
     and plain times (CUDA events, median of 5; kernel also queued), and
     K3 at N=0 at the probe's shape (a launch that does no step), with and
     without the host's launch; then the K3 path, the
     probe's entry point ``npore_tpu_torch.scripts.probe_cond.main()``;
 10. [std fixture] standardize_vcf --engine cuda and --engine golden on
     tests/data/test_std_vcf.vcf: the same VCF text;
 11. [std parity] standardize_vcf --engine cuda on a seeded 100 kb contig
     and its truth VCF: every haplotype's CIGAR equal to the C++ golden
     aligner's;
 12. [std scale] standardize_vcf --engine cuda on a seeded 20 Mbp contig x
     2 haplotypes (the JAX package's hardware run, a third of chr20): wall
     seconds, the NPORE_TIMING stage split, windows, groups, K1/K2
     K4/K1/K2 launches (once a group each), bails, records out, peak host
     RSS, device memory and pinned host memory (which must stay within the
     engine's GROUPS_IN_FLIGHT groups); 8 seeded windows each equal to
     the golden aligner on that window's own sub-alignment; K1 and K2 timed on one 104 x 20,000-row
     group of the run, with the bounds of that group and of the run, and
     [npinfo] and [host split] on that group as on phase 7's groups;
 13. [bed] the BED CLI on the same contig, --max_n 6, 1 and then 4
     processes: byte-identical files; wall seconds and regions per n;
 14. [purity] bam_purity with the Gini moments on the card equal to the
     host path on tests/data/reads.bam (1e-12), and gini_moments_device on
     4M seeded columns equal to a numpy int64 reference, timed;
 15. [mesh] (right after phase 8, on its 1024-window fixture group)
     parallel.mesh.make_sharded_step over make_data_mesh() (every card) and
     over [cuda:0, cuda:0] (two shards on one card): K1's planes bit-equal
     to one unsharded K1 call and to the plain DP, op counts equal to a
     numpy histogram of the planes, one K1 launch a shard; then the same
     step in a 1-rank NCCL process group started in-process, whose
     all_reduce gives the counts back unchanged; reduce_confusion_matrices
     on seeded partials equal to the numpy sums;
 16. [dist realign] the realign CLI with --engine cuda --num_hosts 2 as two
     processes on the card over gloo, on tests/data/reads.bam (one region:
     read stripes): the merged SAM equals tests/data/npore_realigned.sam
     (10/10), 0 bails; then --recalc_cms --recalc_exit on 2 ranks saves the
     *_cm.npy of a 1-process run;
 17. [dist scale] a seeded BAM of 4 contigs x 2,000 reads (bench.py's four
     length buckets) realigned with 1, 2 and 4 ranks on the card, in turns
     (1, 2, 4, 1, 2, 4): wall and stage seconds, reads/s, efficiency
     T1 / (N * TN) and each rank's peak device memory; every merged SAM
     equal to the 1-rank SAM record for record;
 18. [purity mesh] gini_moments_device(..., mesh=[cuda:0, cuda:0]) on the
     4M seeded columns equal to the unsharded call;
 19. [dryrun] scripts.dryrun_multichip.main(["--device", "cuda", "--n",
     "2"]): the sharded step and CudaEngine over [cuda:0, cuda:0],
     golden-exact;
 20. [genome scale] scripts.genome_scale.main at the JAX script's defaults
     (a seeded 5 Mbp contig with an n-polymer run about every 150 bp,
     2,000 reads, seed 11; stages realign, parity, stats, bed, std with
     --engine cuda, std on the 15 kb contig2), its stdout captured and
     each stage's JSON line printed again: all 2,000 reads written,
     golden parity 8/8, 51 stats chunks with substitutions, more than
     1,000 regions in the ``all`` BED, a standardized record; K4, K1 and
     K2 launched in the realign stage and again in the std stage (the
     wrappers' counts at each stage's JSON line); the realign CLI's
     golden-fallback count (0 when it prints none), reads/s, wall
     seconds a stage and the process's peak RSS before and after;
 21. [scripts] the port's calc_beds.sh on that FASTA and BED, whose files
     must equal the bed stage's byte for byte, and ``python3 -m
     npore_tpu_torch.scripts.tag_unphased`` on tests/data/reads.bam: 10
     records, each with an HP tag;
 22. [long reads] the realign CLI (``cli.realign.run``, --engine cuda,
     the CLI's default --batch_reads and the production AlignConfig()) on
     1,000 seeded reads of nanopore lengths (testing/long_reads.py: log-
     normal, median 10 kb, sigma 0.6, 1-60 kb; make_read's noise) on a
     seeded 5 Mbp contig with genome_scale's run density, several windows
     each: the input (read bases, windows a read, groups and their
     shapes, as the engine cut them), reads/s and read-kb/s of 3 timed
     passes (median, min, max) with K4/K1/K2 launches a pass, the
     NPORE_TIMING stage split of a fourth pass a read and a kb, the
     device's busy and idle share and each kernel's device seconds of a
     fifth under torch.profiler, peak device memory and pinned host bytes
     of the first; K4 ([npinfo]), K1 and K2 at the pass's fullest group of
     the longest windows, with their bounds and K1's resident CTAs an SM,
     K2 equal to the plain traceback (run once); then CIGARs against the
     C++ golden aligner, every read. Gates: 1,000 records in every
     pass and none skipped, the SAM byte-equal across the five passes, no
     golden fallback, K4, K1 and K2 launched once a group, every checked
     CIGAR equal;
 23. [genome bam] a whole-genome ``minimap2 -ax map-ont --eqx`` BAM after
     sort and calmd (testing/genome_reads.py, FULL, seed 29: chr1-chr8
     and chrM, 23 Mbp with N gaps, chrUn_1 without reads, decoy_1 in
     the header only; its 2,000 primary reads cut to 1,000 (GB_PRIMARY)
     of 1-60 kb, half reverse, 70%
     soft-clipped, per-base QUAL, MAPQ 0 on 10%, HP on 60%, 21 across a
     short N gap, 10 without MD, 20 with M ops; 100 supplementary, 60
     secondary with SEQ '*' and MD, 40 unmapped last): the input, then
     the realign CLI with --engine cuda at its defaults, 3 timed passes
     (reads/s and read-kb/s: median, min, max), then one with
     NPORE_TIMING=1 (the stage split a kb) and one under torch.profiler
     (the idle share and kernel device seconds): K4/K1/K2 launches,
     windows and groups, device and pinned memory of the first; the CLI's
     start (the FASTA, the region count through
     the CLI's reader and through the decoder's seeking fetch, the same
     regions); every record out against the input (FLAG, RNAME, POS,
     MAPQ, SEQ and QUAL with the clips cut, HP) and every CIGAR against
     the C++ golden aligner; K4,
     K1 and K2 at a group of 16 windows that hold reference N ([npinfo]:
     K4 = pack_group and the plain scan; K2 = the plain traceback);
     training (--recalc_cms --recalc_exit --contigs chr8,chrM) at 1 and 2
     ranks, equal to engine.stats.calc_confusion_matrices_bam's on those
     contigs; the scaling script (--hosts 2, a subprocess, its
     output in files): reads and stage seconds a rank. Gates: one record
     for each
     primary mapped read with MD on a FASTA contig and no other, the 10
     MD-less reads skipped, all fields and CIGARs equal, no golden
     fallback, the SAM byte-equal across the five passes, K4, K1 and K2
     launched once a group, the CLI's region count = the seeking one, K4
     and K2 equal at the N group, the .npy files of 1 and 2 ranks equal
     (and engine.stats' counts), the merged SAM = the 1-rank SAM = the
     passes';
     a failure prints the input's seed;
 24. a JSON line of kernels (launches on their path and on the new paths,
     error, times, and the least time the card could take for the same
     work; K4's line replaces the JAX engine's XLA scan, not a
     pallas_call), then the device line last.

The script imports nothing of JAX or of ``npore_tpu``: it fails if the run
loaded ``jax``, ``npore_tpu`` or any ``npore_tpu.*`` module, and so does
each rank that phases 16-17 and 23 start.
"""
from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# synthetic length buckets (min, max read length), as bench.py's mixed set
MIXED = ((384, 120, 170), (768, 260, 350), (1536, 430, 690),
         (3072, 950, 1400))
REPLICAS = 256
BATCH = 1024
REPS = 5
PLAIN_DP_REPS = 1   # the plain DP takes 20-60 s a group: one call
PASSES = 5       # timed passes of each throughput stream
FUZZ_CASES = 200  # [fuzz]: cases of the ported fuzzer, seed 0
SWEEP = (132, 924, 1024)   # K1 wave sweep: windows of the fixture group

# published H100 SXM peaks: the bound of a
# kernel is the larger of its bytes over HBM_BPS and its float32 operations
# over FP32_OPS
HBM_BPS = 3.35e12
FP32_OPS = 67e12
# K3 shapes (W, Qx, LANES, Q, N): the probe's; one with ragged lanes,
# Qx > Q and a wrapping (k - 1) % Q; one whose rows span five warps
K3_SHAPES = ((32, 16, 128, 16, 256), (7, 20, 96, 10, 300),
             (4, 16, 160, 12, 100))
FLUSH_BYTES = 64 << 20     # written between cold launches: more than L2
QUEUE_CYCLES = 2_000_000   # ~1 ms of device sleep ahead of a queued call
# the long group: windows of at least LONG_ROWS rows, the first window
# max_b_rows cuts from synthetic reads of (min, max) length
LONG = (6, 10400, 10800)    # (windows, min, max read length)
LONG_ROWS = 20000
# standardize_vcf inputs: (contig bases, seed) of the parity contig and of
# the whole-contig run (the JAX package's 20 Mbp hardware run)
STD_PARITY = (100_000, 21)
STD_SCALE = (20_000_000, 20)
STD_SAMPLES = 8             # windows of the scale run checked on their own
BED_PROCESSES = (1, 4)
GINI_COLUMNS = 1 << 22
# [dist scale]: contigs of the seeded BAM, reads a contig and length bucket
# (4 x 4 x 500 = 8,000 reads), the rank counts and the rounds of turns
SCALE_CONTIGS = 4
SCALE_READS = 500
SCALE_RANKS = (2, 4)
SCALE_ROUNDS = 2
# [genome scale]: scripts/genome_scale.py's defaults, on the card
GENOME_READS = 2000
GENOME_STD_CONTIG = "contig2"
GENOME_ARGV = ["--mbp", "5", "--reads", str(GENOME_READS), "--seed", "11",
               "--parity_sample", "8", "--std_contig", GENOME_STD_CONTIG,
               "--stages", "realign,stats,bed,std", "--engine", "cuda"]
GENOME_TAG = "g5m_r2000_s11v2"        # its fixtures' names in the workdir
GENOME_CHUNKS = 51                    # 5 Mbp / 100 kb + 1
# [long reads]: nanopore read lengths (testing/long_reads.py) on a seeded
# 5 Mbp contig with genome_scale's run density, through the realign CLI
LR_SEED = 23
LR_READS = 1000
LR_CONTIG = 5_000_000
LR_MEDIAN, LR_SIGMA = 10_000, 0.6     # bp, and sigma of the log-normal
LR_LENGTHS = (1_000, 60_000)          # bp, its clip
LR_PASSES = 3                         # timed passes
# [genome bam]: testing/genome_reads.py's FULL input (a whole-genome
# minimap2 BAM: 9 chromosomes with N gaps and every kind of record) with
# its 2,000 primary reads cut to GB_PRIMARY, which keeps the script well
# inside its time limit on a slow host, through the realign CLI,
# training and the rank split
GB_SEED = 29
GB_PRIMARY = 1_000
GB_PASSES = 3                         # timed passes
GB_TRAIN = "chr8,chrM"                # --contigs of the training runs
GB_RANKS = 2
GB_N_WINDOWS = 16     # windows holding reference N in the checked group


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def median_ms(fn, reps: int = REPS, warm: bool = True, flush=None,
              queued: bool = False):
    """Median CUDA-event time of ``fn`` over ``reps`` calls, and the last
    call's result. ``flush``: a device tensor zeroed before each timed
    call, outside the events, so the call finds L2 cold. ``queued``: the
    stream sleeps on the device while the host enqueues the events and the
    call, so the events time the device's work alone; otherwise they also
    take in the host's time to launch it (the wrapper's checks, output
    allocation and launch)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], out


def rate_stats(n: int, run) -> dict:
    """reads/s of ``PASSES`` timed calls of ``run`` (each must yield ``n``
    records): median, min and max."""
    rates = []
    for _ in range(PASSES):
        t0 = time.perf_counter()
        got = sum(1 for _ in run())
        rates.append(n / (time.perf_counter() - t0))
        if got != n:
            raise AssertionError(f"{got} records out of {n} reads")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "passes": PASSES, "reads": n}


def bound(nbytes: float, ops: float) -> dict:
    """Least time (ms) of ``nbytes`` moved and ``ops`` float32 operations
    on the card, and which of the two sets it."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "ops": ops}


def k1_bound(wins, batch, tables, cfg, packed) -> dict:
    """K1 reads the group and the tables once and writes the planes once.
    Operations: the 11 float32 adds and compares every live band cell needs
    (INS 3, DEL 3, MAT 5); the n-polymer candidates come on top, so this
    is a lower count."""
    nbytes = sum(v.numel() * v.element_size() for v in batch.values())
    nbytes += sum(v.numel() * v.element_size() for v in tables.values())
    nbytes += packed.numel() * packed.element_size()
    cells = sum(w.b_rows for w in wins) * (cfg.band_width - 2)
    return bound(nbytes, 11 * cells)


def k2_bound(wins, out) -> dict:
    """K2 walks one plane cell and one prefix count (4 + 4 bytes) per run,
    reads two bases per MAT op, writes each CIGAR byte once and reads and
    writes 16 bytes of counts per window. Runs are counted as the maximal
    I, D and =/X segments of this run's CIGARs, at most the runs walked."""
    meta = out.meta.cpu().numpy()
    cig = out.cig.cpu().numpy()
    runs = mats = used = 0
    for j, w in enumerate(wins):
        e, n = w.n_ins + w.n_del, int(meta[j, 0])
        c = cig[j, e - n:e]
        cls = (c == ord("I")) * 1 + (c == ord("D")) * 2
        runs += int((cls[1:] != cls[:-1]).sum()) + (n > 0)
        mats += int((cls == 0).sum())
        used += n
    return bound(8 * runs + 2 * mats + used + 16 * len(wins), 0)


def k3_bound(W: int, Q: int, lanes: int, n_steps: int) -> dict:
    """K3 reads the min(Q, 12) rows a 12-rung ladder can pick and writes
    the sums; per element and step one float32 compare and one add."""
    return bound(4 * W * lanes * (min(Q, 12) + 1), 2 * W * lanes * n_steps)


def k4_bound(batch, max_n: int) -> dict:
    """K4 reads each window's two rows once and writes its four planes
    once: 2 * A bytes in, 4 * max_n * A bytes out a window."""
    B, A = batch["seqbuf"].shape
    return bound(2 * B * A + 4 * max_n * B * A, 0)


def npinfo_check(tag: str, wins, batch, cfg, dev) -> dict:
    """[npinfo]: K4 on a device buffer of 0xA5 bytes around fill_group's
    prefix, against the group ``batch`` that pack_group built on the host
    (every array byte for byte) and against the plain scan on the same
    device tensors; K4's time as paid and queued, the plain scan's, and
    K4's bound."""
    import numpy as np
    import torch
    from npore_tpu_torch.engine.windows import (PLANES, fill_group,
                                                group_layout, group_nbytes,
                                                tensor_views)
    from npore_tpu_torch.ops import npinfo_cuda
    R = batch["inss"].shape[1] - 8
    layout = group_layout(len(wins), R, cfg.max_n)
    head = fill_group(wins, R, cfg.max_n)
    off = len(head)
    buf = torch.full((group_nbytes(layout),), 0xA5, dtype=torch.uint8,
                     device=dev)
    buf[:off].copy_(torch.from_numpy(head))
    got = tensor_views(buf, layout)
    A = got["seqbuf"].shape[1]
    t = {"group": tag, "B": len(wins), "R": R, "A": A,
         "plan": npinfo_cuda.launch_plan(A, cfg.max_n)._asdict(),
         "ctas_per_sm": npinfo_cuda.occupancy(A, cfg.max_n)}
    t["ms"], _ = median_ms(lambda: npinfo_cuda.fill_planes(got, cfg))
    t["device_ms"], _ = median_ms(lambda: npinfo_cuda.fill_planes(got, cfg),
                                  queued=True)
    plain = {k: v.clone() for k, v in got.items()}
    t["plain_ms"], _ = median_ms(
        lambda: npinfo_cuda.fill_planes_plain(plain, cfg), warm=False)
    torch.cuda.synchronize()
    t["equal_pack_group"] = all(torch.equal(got[k], batch[k])
                                for k in batch)
    t["equal_plain"] = all(torch.equal(got[k], plain[k]) for k in PLANES)
    t["max_abs_err"] = max(int((got[k].int() - plain[k].int()).abs().max())
                           for k in PLANES)
    t["h2d_bytes"] = {"fill_group": off, "pack_group": buf.numel()}
    t.update(k4_bound(got, cfg.max_n))
    print("[npinfo] " + json.dumps(t), flush=True)
    if not (t["equal_pack_group"] and t["equal_plain"]):
        raise AssertionError(f"K4's planes differ from pack_group's or the "
                             f"plain scan's ({tag})")
    return t


def host_split_group(tag: str, wins, cfg, dev) -> dict:
    """[host split] per group, in turns (old, new, new, old): the host
    microseconds of pack_group into a pinned buffer and of fill_group into
    a pinned prefix, and the milliseconds until the device holds the
    whole buffer (the full H2D copy; the prefix copy and K4), with the
    H2D bytes of each."""
    import torch
    from npore_tpu_torch.engine.windows import (fill_group, group_layout,
                                                group_nbytes, pack_group,
                                                prefix_nbytes, tensor_views)
    from npore_tpu_torch.ops import npinfo_cuda
    R = max(w.b_rows for w in wins)
    layout = group_layout(len(wins), R, cfg.max_n)
    nbytes, off = group_nbytes(layout), prefix_nbytes(layout)
    runs = {"pack_group": [], "fill_group": []}
    for name in ("pack_group", "fill_group", "fill_group", "pack_group"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "pack_group":
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            pack_group(wins, R, cfg.max_n, out=host.numpy())
            t1 = time.perf_counter()
            host.to(dev, non_blocking=True)
        else:
            host = torch.empty(off, dtype=torch.uint8, pin_memory=True)
            fill_group(wins, R, cfg.max_n, out=host.numpy())
            t1 = time.perf_counter()
            d = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            d[:off].copy_(host, non_blocking=True)
            npinfo_cuda.fill_planes(tensor_views(d, layout), cfg)
        torch.cuda.synchronize()
        runs[name].append({"host_us": (t1 - t0) * 1e6,
                           "to_device_ms": (time.perf_counter() - t0) * 1e3})
    t = {"group": tag, "B": len(wins), "R": R,
         "h2d_bytes": {"pack_group": nbytes, "fill_group": off}, **runs}
    print("[host split] " + json.dumps(t), flush=True)
    return t


def profile_pass(run) -> dict:
    """Device busy share of one call of ``run`` under torch.profiler (CUDA
    activity only): the union of kernel, copy and memset intervals in the
    trace over the pass's wall time (None where the trace holds no device
    activity), and the device seconds of each kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernel_s = {}
    for e in events:
        if e.get("cat") == "kernel":   # by the name before its arguments
            m = re.search(r"(\w+(<[^()]*>)?)\(", e["name"])
            name = m.group(1) if m else e["name"]
            kernel_s[name] = kernel_s.get(name, 0) + e.get("dur", 0) / 1e6
    busy, end = 0.0, float("-inf")
    for a, b in spans:                   # union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    share = busy / (wall * 1e6) if spans else None
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy / 1e6, "busy_share": share,
            "idle_share": None if share is None else 1 - share,
            "kernel_s": kernel_s}


def items_of(reads):
    from npore_tpu_torch.constants import bases_to_int
    from npore_tpu_torch.engine.realigner import AlignItem
    from npore_tpu_torch.io.cigar import expand_cigar
    return [AlignItem(
        bases_to_int(r.get_reference_sequence().upper()),
        bases_to_int(r.query_alignment_sequence.upper()),
        expand_cigar(r.cigar).replace("S", "").replace("H", ""))
        for r in reads]


def device_group(items, cfg, device):
    """Windows of ``items`` as one packed group on ``device``."""
    import torch
    from npore_tpu_torch.engine.windows import (build_windows, pack_group,
                                                tensor_views)
    wins = []
    for i, it in enumerate(items):
        wins += build_windows(it.ref, it.seq, it.cigar, cfg, aln_idx=i)
    wins.sort(key=lambda w: w.b_rows)
    R = max(w.b_rows for w in wins)
    buf, layout = pack_group(wins, R, cfg.max_n)
    batch = tensor_views(torch.from_numpy(buf).to(device), layout)
    return wins, batch


def ntails_group(cfg, device):
    """Seeded reads dense in periodic runs that hold an N, each ending in
    one (``synth.n_tail_reads``), as one packed group on ``device``: the
    scan must stop at each window's length, since such an N matches the
    zero padding past it."""
    import numpy as np
    from npore_tpu_torch.constants import bases_to_int
    from npore_tpu_torch.engine.realigner import AlignItem
    from npore_tpu_torch.testing import synth as gen
    items = [AlignItem(bases_to_int(ref), bases_to_int(seq), cig)
             for ref, seq, cig in gen.n_tail_reads(np.random.default_rng(11),
                                                   254)]
    return device_group(items, cfg, device)


def long_group(cfg, device):
    """LONG[0] windows of at least LONG_ROWS rows, from seeded synthetic
    reads, as one packed group on ``device``. max_b_rows = 20000 cuts a
    read's first window at 19,999 or 20,000 rows (one less where the cut
    would split a match), so reads are drawn until enough have 20,000."""
    import numpy as np
    import torch
    from npore_tpu_torch.constants import bases_to_int
    from npore_tpu_torch.engine.windows import (build_windows, pack_group,
                                                tensor_views)
    from npore_tpu_torch.testing import synth as gen
    n, lo, hi = LONG
    rng = np.random.default_rng(11)
    ref = gen.make_ref(rng, 3 * hi)
    wins = []
    for i in range(16 * n):
        pos, seq, cig = gen.make_read(rng, ref, min_len=lo, max_len=hi)
        span = sum(c != "I" for c in cig)
        wins += [w for w in build_windows(
            bases_to_int(ref[pos:pos + span]), bases_to_int(seq), cig, cfg,
            aln_idx=i) if w.b_rows >= LONG_ROWS]
        if len(wins) == n:
            break
    if len(wins) < n:
        raise AssertionError(f"the long group has {len(wins)} windows of "
                             f">= {LONG_ROWS} rows, not {n}")
    R = max(w.b_rows for w in wins)
    buf, layout = pack_group(wins, R, cfg.max_n)
    return wins, tensor_views(torch.from_numpy(buf).to(device), layout)


def k3_input(i: int, device):
    """x and start counts (None: zeros) of K3_SHAPES[i]: the probe's own
    input, then seeded values (one at the sentinel) with start counts that
    mix both tiers; in the last shape the first warp of each row starts at
    0, so for its first steps it takes the low tier and the rest of the
    row the full one."""
    import torch
    from npore_tpu_torch.ops.tier_select_cuda import WARP
    from npore_tpu_torch.scripts import probe_cond
    if i == 0:
        return probe_cond.probe_input(device), None
    W, qx, lanes, _, _ = K3_SHAPES[i]
    gen = torch.Generator().manual_seed(2 + i)
    x = torch.rand(W, qx, lanes, generator=gen) * 200 - 50
    x[0, 0, 0] = 2e9
    run0 = torch.randint(-50, 50, (W, lanes), generator=gen,
                         dtype=torch.int32)
    if i == 2:
        run0[:, :WARP] = 0
    return x.to(device), run0.to(device)


def write_mixed_bam(path: str) -> None:
    """24 seeded synthetic reads per length bucket, written with their true
    alignments (npore_tpu_torch/testing/synth.py), as bench.py builds its
    mixed set."""
    import numpy as np
    from npore_tpu_torch.io.bam_writer import write_bam
    from npore_tpu_torch.io.cigar import collapse_cigar
    from npore_tpu_torch.io.sam import SamRecord
    from npore_tpu_torch.testing import synth as gen
    rng = np.random.default_rng(7)
    ref = gen.make_ref(rng, 6000)
    records = []
    for bucket, lo, hi in MIXED:
        for i in range(24):
            pos, seq, cig = gen.make_read(rng, ref, min_len=lo, max_len=hi)
            records.append(SamRecord(
                qname=f"mx{bucket}_{i}", flag=0, rname="ref", pos=pos,
                mapq=60, cigar=collapse_cigar(cig), seq=seq,
                qual="I" * len(seq),
                tags={"HP": ("i", int(rng.integers(0, 3))),
                      "MD": ("Z", gen.md_tag(ref, pos, cig))}))
    records.sort(key=lambda r: r.pos)
    write_bam(path, ["ref"], [len(ref)], records)


def sam_parity(got_path: str, want_path: str) -> int:
    """Records of ``got`` equal to the golden SAM on the 11 mandatory
    fields and the tag set (as tests/test_cli_realign.py compares)."""
    def parse(p):
        heads, recs = [], []
        with open(p) as fh:
            for line in fh:
                line = line.rstrip("\n")
                (heads if line.startswith("@") else recs).append(line)
        return heads, recs
    gh, gr = parse(got_path)
    wh, wr = parse(want_path)
    hd = [h for h in gh if h.startswith(("@HD", "@SQ"))]
    if hd != [h for h in wh if h.startswith(("@HD", "@SQ"))]:
        raise AssertionError("SAM header @HD/@SQ differ from the golden SAM")
    key = lambda line: (line.split("\t")[2], int(line.split("\t")[3]),
                        line.split("\t")[0])
    gr.sort(key=key)
    wr.sort(key=key)
    if len(gr) != len(wr):
        raise AssertionError(f"{len(gr)} records, golden has {len(wr)}")
    same = 0
    for g, w in zip(gr, wr):
        gf, wf = g.split("\t"), w.split("\t")
        same += gf[:11] == wf[:11] and set(gf[11:]) == set(wf[11:])
    return same


def write_contig(d: str, name: str, n_bases: int, seed: int):
    """A seeded contig (``testing.synth.make_genome``'s) and its phased
    truth VCF (``testing.synth.truth_variants``: ~1 site a kb, 15% of them
    n-polymer indels) as FASTA and .vcf.gz files in ``d``."""
    import numpy as np
    from npore_tpu_torch.io.fasta import write_fasta
    from npore_tpu_torch.io.vcf import make_header, write_vcf
    from npore_tpu_torch.testing import synth
    rng = np.random.default_rng(seed)
    genome, runs = synth.genome_with_runs(rng, n_bases)
    recs = synth.truth_variants(rng, name, genome, runs)
    ref = os.path.join(d, f"{name}.fasta")
    vcf = os.path.join(d, f"{name}.vcf.gz")
    write_fasta(ref, {name: genome})
    write_vcf(vcf, make_header([(name, n_bases)]), recs)
    return ref, vcf, len(recs)


def peak_rss() -> int:
    """Peak resident bytes of this process so far (ru_maxrss)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def std_argv(vcf: str, ref: str, pre: str, stats: str, engine: str):
    return ["--vcf", vcf, "--ref", ref, "--out_prefix", pre,
            "--stats_dir", stats, "--engine", engine]


def vcf_records(path: str) -> list:
    import gzip
    with gzip.open(path, "rt") as fh:
        return [line for line in fh if not line.startswith("#")]


def std_fixture(tmp: str, stats: str) -> dict:
    """standardize_vcf with K1/K2 and with the golden engine on the
    checked-in fixture: the same VCF text."""
    import gzip
    from npore_tpu_torch.cli import standardize_vcf as std
    from npore_tpu_torch.ops import dp_cuda, tb_cuda
    data = os.path.join(REPO, "tests", "data")
    t = {}
    for engine in ("cuda", "golden"):
        pre = os.path.join(tmp, f"fixture_{engine}")
        dp_cuda.launches = tb_cuda.launches = 0
        rl = std.run(std_argv(os.path.join(data, "test_std_vcf.vcf"),
                              os.path.join(data, "test_std_ref.fasta"),
                              pre, stats, engine))
        with gzip.open(pre + ".vcf.gz", "rt") as fh:
            t[engine] = fh.read()
        t[f"{engine}_launches"] = (dp_cuda.launches, tb_cuda.launches)
        t[f"{engine}_bails"] = rl.bail_count
    same = t["cuda"] == t["golden"]
    n = len([l for l in t["cuda"].splitlines() if not l.startswith("#")])
    print(f"[std fixture] --engine cuda and golden: VCF text equal {same}, "
          f"{n} records, K1/K2 launches {t['cuda_launches']}, bails "
          f"{t['cuda_bails']}", flush=True)
    if not same or n < 4:
        raise AssertionError("standardize_vcf --engine cuda differs from "
                             "--engine golden on the fixture")
    if min(t["cuda_launches"]) < 1:
        raise AssertionError("standardize_vcf did not launch K1 and K2")
    return t


def std_parity(tmp: str, stats: str, sub_scores, np_scores, cfg) -> None:
    """standardize_vcf --engine cuda on a seeded contig: every haplotype's
    CIGAR equal to the C++ golden aligner's for the same alignment."""
    import torch
    from npore_tpu_torch.cli import standardize_vcf as std
    from npore_tpu_torch.native import golden_align_native
    from npore_tpu_torch.ops import dp_cuda, tb_cuda
    ref, vcf, n_truth = write_contig(tmp, "parity", *STD_PARITY)
    done = std.Realigned()
    dp_cuda.launches = tb_cuda.launches = 0
    t0 = time.perf_counter()
    rl = std.run(std_argv(vcf, ref, os.path.join(tmp, "parity"), stats,
                          "cuda"), done)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (dp_cuda.launches, tb_cuda.launches)
    same = sum(golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                                   np_scores, cfg) == cig
               for it, cig in zip(done.items, done.cigars))
    eng = rl._engine
    print(f"[std parity] {STD_PARITY[0]} bases, {n_truth} truth records: "
          f"{same}/{len(done.items)} haplotype CIGARs equal the golden "
          f"aligner's; {eng.windows} windows, {eng.groups} groups, K1/K2 "
          f"launches {launches}, bails {rl.bail_count}, {secs:.2f}s",
          flush=True)
    if same != len(done.items) or not done.items:
        raise AssertionError("standardize_vcf --engine cuda differs from "
                             "the golden aligner")
    if min(launches) < 1:
        raise AssertionError("standardize_vcf did not launch K1 and K2")


def k2_run_bound(cigars, n_windows: int) -> dict:
    """``k2_bound`` over whole-alignment CIGARs: their runs (a window cut
    inside a run starts another, so this counts at most the runs walked),
    MAT ops and bytes, and 16 bytes of counts a window."""
    import numpy as np
    runs = mats = used = 0
    for c in cigars:
        a = np.frombuffer(c.encode("ascii"), dtype=np.uint8)
        cls = (a == ord("I")) * 1 + (a == ord("D")) * 2
        runs += int((cls[1:] != cls[:-1]).sum()) + (len(a) > 0)
        mats += int((cls == 0).sum())
        used += len(a)
    return bound(8 * runs + 2 * mats + used + 16 * n_windows, 0)


def std_scale(tmp: str, stats: str, sub_scores, np_scores, cfg,
              tables) -> dict:
    """standardize_vcf --engine cuda on a whole seeded contig x 2
    haplotypes; see phase 12 of the module docstring."""
    import numpy as np
    import torch
    from npore_tpu_torch.cli import standardize_vcf as std
    from npore_tpu_torch.engine import cuda_engine
    from npore_tpu_torch.engine.windows import (build_windows, group_layout,
                                                group_nbytes, pack_group,
                                                tensor_views)
    from npore_tpu_torch.ops import dp_cuda, npinfo_cuda, tb_cuda
    from npore_tpu_torch.testing import chunks
    n_bases, seed = STD_SCALE
    t0 = time.perf_counter()
    ref, vcf, n_truth = write_contig(tmp, "contig1", n_bases, seed)
    print(f"[std scale] input: {n_bases} bases x 2 haplotypes, {n_truth} "
          f"truth records, made in {time.perf_counter() - t0:.2f}s",
          flush=True)
    pre = os.path.join(tmp, "scale")
    done = std.Realigned()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_host_memory_stats()
    pinned0 = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    rss0 = peak_rss()
    dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
    os.environ["NPORE_TIMING"] = "1"
    try:
        t0 = time.perf_counter()
        rl = std.run(std_argv(vcf, ref, pre, stats, "cuda"), done)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["NPORE_TIMING"]
    k1_launches, k2_launches = dp_cuda.launches, tb_cuda.launches
    k4_launches = npinfo_cuda.launches
    host = torch.cuda.host_memory_stats()
    eng = rl._engine

    # the run's windows and groups, cut as the engine cut them
    wins = []
    for i, it in enumerate(done.items):
        wins += build_windows(it.ref, it.seq, it.cigar, cfg, aln_idx=i)
    wins.sort(key=lambda w: w.b_rows)
    groups = list(eng._groups(wins))
    shapes = [(len(g), max(w.b_rows for w in g)) for g in groups]
    group_bytes = max(group_nbytes(group_layout(B, R, cfg.max_n))
                      for B, R in shapes)
    res_bytes = max(len(g) * (8 + max(w.n_ins + w.n_del for w in g))
                    for g in groups)
    pow2 = lambda x: 1 << (int(x) - 1).bit_length()   # the pinned pool's
    pinned_limit = (cuda_engine.GROUPS_IN_FLIGHT + 2) * (
        pow2(group_bytes) + pow2(res_bytes))
    t = {"wall_s": wall, "windows": eng.windows, "groups": eng.groups,
         "group_shapes": sorted(set(shapes)),
         "k1_launches": k1_launches, "k2_launches": k2_launches,
         "k4_launches": k4_launches, "bail_count": rl.bail_count,
         "records_out": len(vcf_records(pre + ".vcf.gz")),
         "truth_records": n_truth,
         "peak_rss_bytes": peak_rss(),      # the run's, if above the
         "peak_rss_before_bytes": rss0,     # process's peak before it
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "pinned_peak_bytes": host["allocated_bytes.peak"],
         "pinned_before_bytes": pinned0,
         "pinned_limit_growth_bytes": pinned_limit,
         "groups_in_flight": cuda_engine.GROUPS_IN_FLIGHT,
         "device_wait_s": eng.wait_s}
    print("[std scale] " + json.dumps(t), flush=True)
    if (eng.windows, eng.groups) != (len(wins), len(groups)):
        raise AssertionError("the engine's windows and groups differ from "
                             "the run's")
    if not k1_launches == k2_launches == k4_launches == len(groups):
        raise AssertionError("standardize_vcf did not launch K4, K1 and K2 "
                             "once a group")
    if t["pinned_peak_bytes"] - pinned0 > pinned_limit:
        raise AssertionError("pinned host memory grew past "
                             f"{cuda_engine.GROUPS_IN_FLIGHT} groups in "
                             "flight")
    if t["records_out"] < 1:
        raise AssertionError("standardize_vcf wrote no records")

    # STD_SAMPLES windows, each against the golden aligner on its own
    keys = [w.key for w in wins]
    pick = np.random.default_rng(seed).choice(len(keys), STD_SAMPLES,
                                              replace=False)
    paths, same, t0 = {}, 0, time.perf_counter()
    for i, ci in sorted(keys[k] for k in pick):
        it = done.items[i]
        if i not in paths:
            paths = {i: (chunks.path_of(it.cigar),)
                     + chunks.breaks_of(it.cigar, cfg)}
        want, ends = chunks.golden_window(it.ref, it.seq, *paths[i], ci,
                                          sub_scores, np_scores, cfg)
        same += chunks.chunk_of(done.cigars[i], *ends) == want
    print(f"[std scale] sampled windows equal to the golden aligner on "
          f"their own sub-alignments: {same}/{STD_SAMPLES} "
          f"({time.perf_counter() - t0:.2f}s)", flush=True)
    if same != STD_SAMPLES:
        raise AssertionError("a window of the whole-contig run differs "
                             "from the golden aligner")
    del paths

    # K1 and K2 on the run's fullest group of long windows
    g = max(groups, key=lambda g: (len(g), min(w.b_rows for w in g)))
    R = max(w.b_rows for w in g)
    buf, layout = pack_group(g, R, cfg.max_n)
    dev = next(iter(tables.values())).device
    batch = tensor_views(torch.from_numpy(buf).to(dev), layout)
    L = max(w.n_ins + w.n_del for w in g)
    packed = dp_cuda.band_dp(batch, tables, cfg)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    grp = {"B": len(g), "R": R, "min_rows": min(w.b_rows for w in g)}
    grp["k1_ms"], _ = median_ms(lambda: dp_cuda.band_dp(batch, tables, cfg))
    grp["k1_device_ms"], _ = median_ms(
        lambda: dp_cuda.band_dp(batch, tables, cfg), queued=True)

    def k2():
        return tb_cuda.traceback(packed, batch, cfg, L)
    grp["k2_ms"], out = median_ms(k2)
    grp["k2_cold_ms"], _ = median_ms(k2, flush=flush)
    grp["k2_cold_device_ms"], _ = median_ms(k2, flush=flush, queued=True)
    grp["k2_bails"] = int(out.meta[:, 1].sum())
    grp["k1_bound"] = k1_bound(g, batch, tables, cfg, packed)
    grp["k2_bound"] = k2_bound(g, out)
    # the run's bounds: every group's buffer, tables and planes for K1
    tab_bytes = sum(v.numel() * v.element_size() for v in tables.values())
    plane_bytes = packed.numel() * packed.element_size() // (len(g) * R)
    grp["k1_run_bound"] = bound(
        sum(group_nbytes(group_layout(B, R_, cfg.max_n)) + tab_bytes
            + B * R_ * plane_bytes for B, R_ in shapes),
        11 * sum(w.b_rows for w in wins) * (cfg.band_width - 2))
    grp["k2_run_bound"] = k2_run_bound(done.cigars, len(wins))
    print("[std group] " + json.dumps(grp), flush=True)
    t["group"] = grp
    t["npinfo"] = npinfo_check("std", g, batch, cfg, dev)
    t["split"] = host_split_group("std", g, cfg, dev)
    return t


def bed_phase(tmp: str, ref: str, n_bases: int) -> None:
    """The BED CLI on the scale contig with 1 and then 4 processes."""
    from npore_tpu_torch.cli import bed
    genome = os.path.join(tmp, "contig1.bed")
    with open(genome, "w") as fh:
        fh.write(f"contig1\t0\t{n_bases}\n")
    files, secs = {}, {}
    for procs in BED_PROCESSES:
        d = os.path.join(tmp, f"bed{procs}")
        os.makedirs(d)
        t0 = time.perf_counter()
        bed.main(["--ref", ref, "--bed", genome, "--out_prefix",
                  os.path.join(d, "np"), "--max_n", "6", "--processes",
                  str(procs)])
        secs[procs] = time.perf_counter() - t0
        files[procs] = {}
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fh:
                files[procs][name] = fh.read()
    same = all(files[p] == files[BED_PROCESSES[0]] for p in BED_PROCESSES)
    regions = {k: v.count(b"\n") for k, v in files[BED_PROCESSES[0]].items()}
    print(f"[bed] {n_bases} bases, --max_n 6: files identical across "
          f"processes {BED_PROCESSES}: {same}; wall s "
          f"{json.dumps(secs)}; regions {json.dumps(regions)}", flush=True)
    if not same or len(regions) != 8 or not regions["np_1.bed"]:
        raise AssertionError("the BED CLI's files differ across process "
                             "counts")


def gini_columns():
    """GINI_COLUMNS seeded base and insertion count columns."""
    import numpy as np
    from npore_tpu_torch.cli import purity
    rng = np.random.default_rng(5)
    b = rng.integers(0, 256, (GINI_COLUMNS, 5), dtype=np.int32)
    iv = rng.integers(0, 32, (GINI_COLUMNS, purity.INS_SLOTS),
                      dtype=np.int32)
    return b, iv


def purity_phase(device) -> dict:
    """Purity with the Gini moments on the card against the host path, and
    the moments alone on GINI_COLUMNS seeded columns."""
    import numpy as np
    import torch
    from npore_tpu_torch.cli import purity
    bam = os.path.join(REPO, "tests", "data", "reads.bam")
    host = purity.bam_purity(bam, None, None, None, 13, processes=1)
    dev = purity.bam_purity(bam, None, None, None, 13, processes=1,
                            device=True)
    err = float(np.abs(host - dev).max()) if host.shape == dev.shape \
        else float("inf")
    b, iv = gini_columns()
    b64, i64 = b.astype(np.int64), iv.astype(np.int64)
    want = (b64.sum(1), (b64 * b64).sum(1), b64.sum(1) - i64.sum(1),
            (i64 * i64).sum(1))
    t = {"columns": len(host), "max_abs_err": err}
    t["ms"], got = median_ms(lambda: purity.gini_moments_device(b, iv))
    on_card = [torch.from_numpy(x).to(device) for x in (b, iv)]
    t["device_ms"], _ = median_ms(
        lambda: purity.gini_moments_device(*on_card), queued=True)
    t["moments_equal"] = all(g.dtype == np.int32 and np.array_equal(g, w)
                             for g, w in zip(got, want))
    t["moment_columns"] = GINI_COLUMNS
    print("[purity] " + json.dumps(t), flush=True)
    if err > 1e-12 or not len(host):
        raise AssertionError("the device Gini differs from the host path")
    if not t["moments_equal"]:
        raise AssertionError("gini_moments_device differs from numpy")
    return t


def mesh_phase(batch, plain, tables, cfg) -> dict:
    """[mesh]: the sharded K1 step on the fixture group over every card and
    over two shards on one card, then in a 1-rank NCCL group; the
    confusion reduce on seeded partials."""
    import numpy as np
    import torch
    from npore_tpu_torch.ops import dp_cuda
    from npore_tpu_torch.parallel import distributed as pd
    from npore_tpu_torch.parallel import mesh as pm
    from npore_tpu_torch.scripts.multihost_scaling import free_port
    dev0 = torch.device("cuda", 0)
    whole = dp_cuda.band_dp(batch, tables, cfg)
    out = {"launches": 0, "meshes": []}

    def run(mesh, tag):
        dp_cuda.launches = 0
        planes, counts = pm.make_sharded_step(mesh, cfg)(
            pm.shard_batch(batch, mesh), tables)
        torch.cuda.synchronize()
        launches = dp_cuda.launches
        out["launches"] += launches
        got = torch.cat([p.to(dev0) for p in planes])
        p = got.cpu().numpy()
        hist = np.bincount((p & 7)[(p >> 3) > 0], minlength=5)
        t = {"mesh": tag, "shards": mesh.size, "windows": len(got),
             "launches": launches, "op_counts": counts.tolist(),
             "equal_unsharded": torch.equal(got, whole),
             "equal_plain": torch.equal(got, plain),
             "counts_equal_numpy": np.array_equal(counts.cpu().numpy(),
                                                  hist)}
        out["meshes"].append(t)
        print("[mesh] " + json.dumps(t), flush=True)
        if not (t["equal_unsharded"] and t["equal_plain"]
                and t["counts_equal_numpy"]):
            raise AssertionError(f"the sharded step over {tag} differs")
        if launches != mesh.size:
            raise AssertionError(f"the sharded step over {tag} launched K1 "
                                 f"{launches} times, not once a shard")
        return counts

    counts = run(pm.make_data_mesh(), "make_data_mesh()")
    two = pm.make_data_mesh([dev0, dev0])
    run(two, "[cuda:0, cuda:0]")
    pd.start_group(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        back = pd.allreduce_sum(counts)
        in_group = run(two, "[cuda:0, cuda:0] in a 1-rank NCCL group")
        torch.cuda.synchronize()
    finally:
        pd.shutdown()
    print(f"[mesh] 1-rank NCCL all_reduce: {back.tolist()} (in "
          f"{counts.tolist()})", flush=True)
    if not (torch.equal(back, counts) and torch.equal(in_group, counts)):
        raise AssertionError("a 1-rank NCCL all_reduce changed the counts")
    rng = np.random.default_rng(9)
    for mesh in (pm.make_data_mesh(), two):
        parts = [rng.integers(0, 1 << 40, (mesh.size,) + shape)
                 for shape in ((5, 5), (2, cfg.max_n, cfg.max_l, cfg.max_l),
                               (cfg.max_l,), (cfg.max_l,))]
        got = pm.reduce_confusion_matrices(mesh, *parts)
        if not all(g.dtype == np.int64 and np.array_equal(g, x.sum(0))
                   for g, x in zip(got, parts)):
            raise AssertionError("reduce_confusion_matrices differs from "
                                 "the numpy sums")
    print("[mesh] reduce_confusion_matrices equal to the numpy sums over "
          "both meshes", flush=True)
    return out


def rank_launches(row) -> tuple:
    """K1 and K2 launches of every rank of a multihost_scaling run."""
    return (sum(r["k1_launches"] for r in row["ranks"]),
            sum(r["k2_launches"] for r in row["ranks"]))


def check_ranks(row, tag: str) -> None:
    """Every rank of a run loaded nothing of JAX and bailed on nothing."""
    for h, r in enumerate(row["ranks"]):
        if r["loaded"]:
            raise AssertionError(f"{tag}: rank {h} loaded {r['loaded']}")
        if r["bails"]:
            raise AssertionError(f"{tag}: rank {h} used the golden "
                                 f"fallback {r['bails']} times")


def dist_realign(tmp: str, stats: str) -> dict:
    """[dist realign]: 2 ranks on the card against the golden SAM, then
    the confusion counts of 2 ranks against 1 process."""
    import numpy as np
    from npore_tpu_torch.scripts import multihost_scaling as mh
    data = os.path.join(REPO, "tests", "data")
    cli = ["--bam", os.path.join(data, "reads.bam"),
           "--ref", os.path.join(data, "ref.fasta"), "--engine", "cuda"]
    pre = os.path.join(tmp, "dist")
    row = mh.run_ranks(2, cli + ["--stats_dir", stats, "--out_prefix", pre],
                       tmp, "dist")
    check_ranks(row, "[dist realign]")
    same = sam_parity(pre + ".sam", os.path.join(data, "npore_realigned.sam"))
    t = {"hosts": 2, "reads": row["reads"], "golden_records_equal": same,
         "wall_s": row["wall_s"], "seconds": row["seconds"],
         "k1_k2_launches": rank_launches(row),
         "bails": [r["bails"] for r in row["ranks"]]}
    if same != 10:
        raise AssertionError("2 ranks do not reproduce the golden SAM")
    if any(min(r["k1_launches"], r["k2_launches"]) < 1
           for r in row["ranks"]):
        raise AssertionError("a rank did not launch K1 and K2")
    cms = {}
    for n in (1, 2):
        d = os.path.join(tmp, f"cm{n}")
        mh.run_ranks(n, cli + ["--stats_dir", d, "--out_prefix",
                               os.path.join(tmp, f"cm{n}"), "--recalc_cms",
                               "--recalc_exit"], tmp, f"cm{n}")
        cms[n] = [np.load(os.path.join(d, f"{k}_cm.npy"))
                  for k in ("subs", "nps", "inss", "dels")]
    t["cm_equal_1_process"] = all(np.array_equal(a, b)
                                  for a, b in zip(cms[1], cms[2]))
    t["cm_total"] = int(sum(int(a.sum()) for a in cms[2]))
    print("[dist realign] " + json.dumps(t), flush=True)
    if not t["cm_equal_1_process"] or not t["cm_total"]:
        raise AssertionError("2 ranks' confusion counts differ from 1 "
                             "process's")
    return t


def write_scale_bam(d: str):
    """SCALE_CONTIGS seeded contigs, each with SCALE_READS reads of every
    length bucket of MIXED: FASTA and coordinate-sorted BAM paths."""
    import numpy as np
    from npore_tpu_torch.io.bam_writer import write_bam
    from npore_tpu_torch.io.cigar import collapse_cigar
    from npore_tpu_torch.io.fasta import write_fasta
    from npore_tpu_torch.io.sam import SamRecord
    from npore_tpu_torch.testing import synth as gen
    rng = np.random.default_rng(17)
    refs = {f"ctg{c}": gen.make_ref(rng, 200_000)
            for c in range(SCALE_CONTIGS)}
    records = []
    for c, (name, ref) in enumerate(refs.items()):
        for bucket, lo, hi in MIXED:
            for i in range(SCALE_READS):
                pos, seq, cig = gen.make_read(rng, ref, min_len=lo,
                                              max_len=hi)
                records.append((c, pos, SamRecord(
                    qname=f"{name}_{bucket}_{i}", flag=0, rname=name,
                    pos=pos, mapq=60, cigar=collapse_cigar(cig), seq=seq,
                    qual="I" * len(seq),
                    tags={"HP": ("i", int(rng.integers(0, 3))),
                          "MD": ("Z", gen.md_tag(ref, pos, cig))})))
    records.sort(key=lambda r: r[:2])
    fasta, bam = os.path.join(d, "scale.fasta"), os.path.join(d, "scale.bam")
    write_fasta(fasta, refs)
    write_bam(bam, list(refs), [len(r) for r in refs.values()],
              [r[2] for r in records])
    return fasta, bam, len(records)


def dist_scale(tmp: str, stats: str) -> dict:
    """[dist scale]: 1, 2 and 4 ranks on the card, in turns, over a BAM of
    SCALE_CONTIGS contigs (region shards)."""
    from npore_tpu_torch.scripts import multihost_scaling as mh
    t0 = time.perf_counter()
    fasta, bam, n_reads = write_scale_bam(tmp)
    print(f"[dist scale] input: {n_reads} reads on {SCALE_CONTIGS} contigs, "
          f"made in {time.perf_counter() - t0:.2f}s", flush=True)
    cli = ["--bam", bam, "--ref", fasta, "--stats_dir", stats,
           "--engine", "cuda", "--batch_reads", str(BATCH)]
    rows = []

    def emit(line):
        row = json.loads(line)
        rows.append(row)
        t = {k: row[k] for k in ("round", "hosts", "reads", "wall_s",
                                 "seconds", "reads_per_s", "efficiency",
                                 "records_match_1host")}
        t["k1_k2_launches"] = rank_launches(row)
        t["peak_device_bytes"] = [r["peak_device_bytes"]
                                  for r in row["ranks"]]
        print("[dist scale] " + json.dumps(t), flush=True)
    mh.scaling(SCALE_RANKS, cli, tmp, SCALE_ROUNDS, emit=emit)
    for row in rows:
        check_ranks(row, "[dist scale]")
        if not row["records_match_1host"] or row["reads"] != n_reads:
            raise AssertionError(f"{row['hosts']} ranks' merged SAM differs "
                                 "from the 1-rank SAM")
        if row["hosts"] > 1 and any(r["k1_launches"] < 1
                                    for r in row["ranks"]):
            raise AssertionError("a rank of [dist scale] launched no K1")
    launches = [rank_launches(r) for r in rows]
    return {"rows": rows, "k1_launches": sum(a for a, _ in launches),
            "k2_launches": sum(b for _, b in launches)}


def purity_mesh_phase() -> None:
    """[purity mesh]: the Gini moments split over two shards on one card
    equal the unsharded call."""
    import numpy as np
    import torch
    from npore_tpu_torch.cli import purity
    b, iv = gini_columns()
    dev0 = torch.device("cuda", 0)
    want = purity.gini_moments_device(b, iv)
    got = purity.gini_moments_device(b, iv, mesh=[dev0, dev0])
    same = all(g.dtype == w.dtype and np.array_equal(g, w)
               for g, w in zip(got, want))
    print(f"[purity mesh] {GINI_COLUMNS} columns over [cuda:0, cuda:0]: "
          f"equal to the unsharded call {same}", flush=True)
    if not same:
        raise AssertionError("gini_moments_device over a mesh differs")


class StageLog(io.StringIO):
    """Captured stdout that notes ``counts()`` when a stage's JSON line is
    written (genome_scale prints one as each stage ends)."""

    def __init__(self, counts):
        super().__init__()
        self.counts = counts
        self.at = {}

    def write(self, s):
        if s.startswith('{"stage": '):
            self.at[json.loads(s)["stage"]] = self.counts()
        return super().write(s)


def golden_cigars(alns, sub_scores, np_scores, cfg) -> list:
    """The CIGAR the realign CLI must write for each alignment (ref, seq,
    extended CIGAR): the C++ golden aligner's, finalized, on cpu_count - 1
    threads (ctypes lets go of the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    from npore_tpu_torch.io.cigar import finalize_cigar
    from npore_tpu_torch.native import golden_align_native

    def want(aln):
        ref, seq, cigar = aln
        return finalize_cigar(golden_align_native(
            ref, seq, cigar, sub_scores, np_scores, cfg), ref, seq)
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) - 1)) as ex:
        return list(ex.map(want, alns))


def sam_cigars(path: str) -> dict:
    """QNAME -> CIGAR of a SAM file's records."""
    with open(path) as fh:
        return {f[0]: f[5] for f in (line.split("\t") for line in fh
                                     if not line.startswith("@"))}


def genome_golden(workdir: str, stats: str, sub_scores, np_scores,
                  cfg) -> dict:
    """The [genome scale] run held against the golden aligners: every read
    of gs_realign.sam against the C++ golden aligner (threads: ctypes lets
    go of the GIL), and gs_std.vcf.gz against the one standardize_vcf
    --engine golden writes for the same contig (a subprocess, meanwhile)."""
    from npore_tpu_torch.io.bam import open_alignment_file
    fx = os.path.join(workdir, GENOME_TAG)
    pre = os.path.join(workdir, "gs_std_golden")
    t0 = time.perf_counter()
    with open(pre + ".log", "w") as log:
        std = subprocess.Popen(
            [sys.executable, "-m", "npore_tpu_torch.cli.standardize_vcf"]
            + std_argv(fx + ".vcf.gz", fx + ".fasta", pre, stats, "golden")
            + ["--contig", GENOME_STD_CONTIG],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        got = sam_cigars(os.path.join(workdir, "gs_realign.sam"))
        reads = list(open_alignment_file(fx + ".bam"))
        wants = golden_cigars([r.aln for r in reads], sub_scores,
                              np_scores, cfg)
        differ = [r.qname for r, w in zip(reads, wants)
                  if got.get(r.qname) != w]
        reads_s = time.perf_counter() - t0
        rc = std.wait(timeout=900)
    finally:
        if std.poll() is None:
            std.kill()
            std.wait()
    std_s = time.perf_counter() - t0
    same_vcf = rc == 0 and filecmp.cmp(
        os.path.join(workdir, "gs_std.vcf.gz"), pre + ".vcf.gz",
        shallow=False)
    t = {"reads": len(reads), "reads_equal": len(reads) - len(differ),
         "reads_differ": differ[:10], "reads_s": reads_s,
         "std_golden_rc": rc, "std_vcf_equal": same_vcf, "std_s": std_s}
    print(f"[genome scale] golden: {t['reads_equal']}/{len(reads)} "
          f"realigned CIGARs equal the C++ golden aligner's "
          f"({reads_s:.2f}s); gs_std.vcf.gz byte-equal to --engine golden's "
          f"{same_vcf} ({std_s:.2f}s)", flush=True)
    if rc != 0:
        with open(pre + ".log") as fh:
            print(fh.read()[-4000:], flush=True)
    return t


def genome_phase(workdir: str, stats: str, sub_scores, np_scores,
                 cfg) -> dict:
    """[genome scale]: the port's genome_scale.main in this process at the
    JAX script's defaults, with the K4/K1/K2 launches of its realign and
    std stages; its realigned reads and standardized VCF then held against
    the golden aligners (``genome_golden``)."""
    from npore_tpu_torch.ops import dp_cuda, npinfo_cuda, tb_cuda
    from npore_tpu_torch.scripts import genome_scale
    names = ("k4", "k1", "k2")
    log = StageLog(lambda: (npinfo_cuda.launches, dp_cuda.launches,
                            tb_cuda.launches))
    rss0 = peak_rss()
    dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            rc = genome_scale.main(GENOME_ARGV + ["--workdir", workdir])
    except BaseException:
        print(log.getvalue()[-4000:], flush=True)
        raise
    wall = time.perf_counter() - t0
    out = log.getvalue()
    rows = {}
    for line in out.splitlines():
        if line.startswith('{"stage": '):
            rows[json.loads(line)["stage"]] = json.loads(line)
            print("[genome scale] " + line, flush=True)
    m = re.search(r"(\d+) alignments used the golden fallback", out)
    zero = (0, 0, 0)
    realign = log.at.get("realign", zero)      # the counts start at 0
    std = [b - a for a, b in zip(log.at.get("bed", zero),
                                 log.at.get("std", zero))]
    t = {"rc": rc, "wall_s": wall,
         "secs": {k: rows[k]["secs"] for k in
                  ("generate", "realign", "stats", "bed", "std")
                  if k in rows},
         "reads_per_s": rows.get("realign", {}).get("reads_per_sec"),
         "golden_fallbacks": int(m.group(1)) if m else 0,
         "launches_realign": dict(zip(names, realign)),
         "launches_std": dict(zip(names, std)),
         "peak_rss_mb_before": rss0 / 2**20,
         "peak_rss_mb_after": peak_rss() / 2**20}
    print("[genome scale] " + json.dumps(t), flush=True)
    gold = genome_golden(workdir, stats, sub_scores, np_scores, cfg)
    t["golden"] = gold
    parity, counts = rows.get("parity", {}), rows.get("stats", {})
    fails = [what for what, ok in (
        ("rc", rc == 0),
        ("stages", all(k in rows for k in ("realign", "parity", "stats",
                                           "bed", "std", "summary"))),
        ("parity 8/8", parity.get("ok") is True
         and parity.get("sampled") == 8),
        ("stats chunks", counts.get("chunks") == GENOME_CHUNKS
         and counts.get("subs_total", 0) > 0),
        ("bed regions", rows.get("bed", {}).get("regions", {}).get(
            "all", 0) > 1000),
        ("std records", rows.get("std", {}).get("records", 0) >= 1),
        ("realign launches", min(realign) >= 1),
        ("std launches", min(std) >= 1),
        ("reads = golden", gold["reads"] == GENOME_READS
         and gold["reads_equal"] == GENOME_READS),
        ("std VCF = golden", gold["std_vcf_equal"])) if not ok]
    if fails:
        raise AssertionError(f"[genome scale] failed: {fails}")
    return t


def scripts_phase(workdir: str) -> None:
    """[scripts]: calc_beds.sh on the genome-scale fixture (its files =
    the bed stage's) and tag_unphased on reads.bam with the HP tag taken
    off half of its reads."""
    ref = os.path.join(workdir, GENOME_TAG + ".fasta")
    bed = os.path.join(workdir, GENOME_TAG + ".bed")
    d = os.path.join(workdir, "calc_beds")
    os.makedirs(d)
    t0 = time.perf_counter()
    subprocess.run(["bash", os.path.join(REPO, "npore_tpu_torch", "scripts",
                                         "calc_beds.sh"),
                    ref, bed, os.path.join(d, "gs_bed")],
                   check=True, capture_output=True, timeout=600)
    secs = time.perf_counter() - t0

    def files(where, names):
        out = {}
        for n in names:
            with open(os.path.join(where, n), "rb") as fh:
                out[n] = fh.read()
        return out
    names = sorted(os.listdir(d))
    same = files(d, names) == files(workdir, sorted(
        f for f in os.listdir(workdir) if f.startswith("gs_bed")))
    print(f"[scripts] calc_beds.sh: {len(names)} files, identical to the "
          f"bed stage's: {same}, {secs:.2f}s", flush=True)
    if not same or "gs_bed_all.bed" not in names:
        raise AssertionError("calc_beds.sh's files differ from the bed "
                             "stage's")
    # reads.bam with the HP tag taken off every other read
    from npore_tpu_torch.io.bam import BamReader
    from npore_tpu_torch.io.bam_writer import write_bam
    from npore_tpu_torch.io.sam import SamReader
    reads = BamReader(os.path.join(REPO, "tests", "data", "reads.bam"))
    recs = list(reads)
    hp = {r.qname: r.tags["HP"][1] for r in recs}
    untagged = {r.qname for r in recs[::2]}
    for r in recs[::2]:
        r.tags = {k: v for k, v in r.tags.items() if k != "HP"}
    bam = os.path.join(workdir, "half_tagged.bam")
    write_bam(bam, list(reads.references), [int(n) for n in reads.lengths],
              recs)
    sam = os.path.join(workdir, "tagged.sam")
    res = subprocess.run(
        [sys.executable, "-m", "npore_tpu_torch.scripts.tag_unphased",
         bam, sam],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=300)
    out = {r.qname: r.tags.get("HP", (None, None))[1]
           for r in SamReader(sam)}
    want = {q: 0 if q in untagged else v for q, v in hp.items()}
    print(f"[scripts] tag_unphased on reads.bam with HP taken off "
          f"{len(untagged)} of {len(hp)} reads: {res.stdout.strip()}; HP "
          f"0 on those and kept on the rest: {out == want}", flush=True)
    if (res.stdout != f"tagged {len(untagged)} unphased reads\n"
            or len(untagged) != 5 or out != want):
        raise AssertionError("tag_unphased did not tag the unphased reads")


def long_reads_input(d: str):
    """[long reads]: the seeded contig and reads (testing/long_reads.py)
    written as FASTA and BAM; the paths and the reads."""
    from npore_tpu_torch.testing import long_reads as lr
    contig, _, reads = lr.make_long_reads(LR_SEED, LR_READS, LR_CONTIG,
                                          LR_MEDIAN, LR_SIGMA, LR_LENGTHS)
    fasta, bam = lr.write_long_reads(d, contig, reads, seed=LR_SEED)
    return fasta, bam, reads


def long_reads_groups(alns, eng, batch_reads: int):
    """Windows a read, and the groups, as the realign CLI's engine cuts
    them: batches of ``batch_reads`` reads in the BAM's order, each
    batch's windows sorted by rows."""
    from npore_tpu_torch.engine.windows import build_windows
    per_read, groups = [], []
    for lo in range(0, len(alns), batch_reads):
        wins = []
        for i, (ref, seq, cig) in enumerate(alns[lo:lo + batch_reads]):
            w = build_windows(ref, seq, cig, eng.cfg, aln_idx=i)
            per_read.append(len(w))
            wins += w
        wins.sort(key=lambda w: w.b_rows)
        groups += list(eng._groups(wins))
    return per_read, groups


def long_reads_golden(bam: str, sam: str, n_windows, sub_scores, np_scores,
                      cfg) -> dict:
    """Every [long reads] CIGAR against the C++ golden aligner's."""
    from npore_tpu_torch.io.bam import open_alignment_file
    t0 = time.perf_counter()
    got = sam_cigars(sam)
    reads = list(open_alignment_file(bam))
    wants = golden_cigars([r.aln for r in reads], sub_scores, np_scores,
                          cfg)
    differ = [r.qname for r, w in zip(reads, wants) if got.get(r.qname) != w]
    t = {"reads_checked": len(reads),
         "bases_checked": sum(len(r.aln[1]) for r in reads),
         "reads_3plus_windows": sum(n >= 3 for n in n_windows),
         "reads_equal": len(reads) - len(differ),
         "reads_differ": differ[:10], "seconds": time.perf_counter() - t0}
    print("[long reads] golden: " + json.dumps(t), flush=True)
    return t


def group_kernels(tag: str, g, cfg, tables):
    """K4 ([npinfo]: = ``pack_group`` and the plain scan), K1 and K2 at the
    group of windows ``g``: times as paid and queued, K2 warm and cold,
    the plain traceback (run once) and K2's equality to it, bounds and
    K1's resident CTAs an SM; printed as ``[tag] group``. Returns the
    group's dict and [npinfo]'s."""
    import torch
    from npore_tpu_torch.engine.windows import pack_group, tensor_views
    from npore_tpu_torch.ops import dp_cuda, tb_cuda
    from npore_tpu_torch.ops.traceback import traceback as tb_plain
    R = max(w.b_rows for w in g)
    buf, layout = pack_group(g, R, cfg.max_n)
    dev = next(iter(tables.values())).device
    batch = tensor_views(torch.from_numpy(buf).to(dev), layout)
    L = max(w.n_ins + w.n_del for w in g)
    npi = npinfo_check(tag, g, batch, cfg, dev)
    packed = dp_cuda.band_dp(batch, tables, cfg)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grp = {"B": len(g), "R": R, "min_rows": min(w.b_rows for w in g),
           "k1_ctas_per_sm": dp_cuda.occupancy(cfg), "sms": sms}
    grp["k1_ms"], _ = median_ms(lambda: dp_cuda.band_dp(batch, tables, cfg))
    grp["k1_device_ms"], _ = median_ms(
        lambda: dp_cuda.band_dp(batch, tables, cfg), queued=True)
    grp["k1_device_us_per_row"] = grp["k1_device_ms"] * 1e3 / R

    def k2():
        return tb_cuda.traceback(packed, batch, cfg, L)
    grp["k2_ms"], out_k = median_ms(k2)
    grp["k2_cold_ms"], out_c = median_ms(k2, flush=flush)
    grp["k2_cold_device_ms"], _ = median_ms(k2, flush=flush, queued=True)
    grp["k2_plain_ms"], out_p = median_ms(
        lambda: tb_plain(packed, batch, cfg, L), warm=False, reps=1)
    grp["k2_max_diff"] = max(int((o.buf.int() - out_p.buf.int()).abs().max())
                             for o in (out_k, out_c))
    grp["k2_equal_plain"] = (torch.equal(out_k.buf, out_p.buf)
                             and torch.equal(out_c.buf, out_p.buf))
    grp["k2_bails"] = int(out_k.meta[:, 1].sum())
    grp["k1_bound"] = k1_bound(g, batch, tables, cfg, packed)
    grp["k2_bound"] = k2_bound(g, out_k)
    grp["k4"] = {k: npi[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}
    print(f"[{tag}] group: " + json.dumps(grp), flush=True)
    return grp, npi


def memory_before() -> tuple:
    """Reset the peaks; the device and pinned host bytes held now."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_host_memory_stats()
    return (torch.cuda.memory_allocated(),
            torch.cuda.host_memory_stats()["allocated_bytes.current"])


def memory_added(before: tuple) -> dict:
    """The device and pinned host memory added at the peak since
    ``memory_before()`` to what was held then."""
    import torch
    dev0, pinned0 = before
    host = torch.cuda.host_memory_stats()
    return {"device_peak_bytes": torch.cuda.max_memory_allocated() - dev0,
            "device_before_bytes": dev0,
            "pinned_peak_bytes": host["allocated_bytes.peak"] - pinned0,
            "pinned_before_bytes": pinned0,
            "pinned_after_bytes": host["allocated_bytes.current"]}


def stage_split(stdout: str, n_reads: int, kb: float) -> dict:
    """The Realigner's NPORE_TIMING line in ``stdout``, a read and a kb of
    ``n_reads`` reads of ``kb`` kb (empty without the line)."""
    m = re.search(r"submit (\d+)us, collect-wait (\d+)us, finalize\+emit "
                  r"(\d+)us, decode-wait (\d+)us, main-wait (\d+)us", stdout)
    if not m:
        return {}
    us = dict(zip(("submit", "collect_wait", "finalize_emit", "decode_wait",
                   "main_wait"), map(int, m.groups())))
    return {"per_read_us": us,
            "per_kb_us": {k: v * n_reads / kb for k, v in us.items()}}


def kernel_shares(prof: dict) -> dict:
    """``profile_pass``'s result with its six largest kernels by device
    seconds and their share of the wall time."""
    prof = dict(prof)
    prof["kernel_s"] = dict(sorted(prof["kernel_s"].items(),
                                   key=lambda kv: -kv[1])[:6])
    prof["kernel_share"] = {k: v / prof["wall_s"]
                            for k, v in prof["kernel_s"].items()}
    return prof


def realign_pass(argv, sam_path: str, n_reads: int, kb: float,
                 profiled: bool = False) -> dict:
    """One run of the realign CLI (``cli.realign.run(argv)``; under
    torch.profiler if ``profiled``) with its stdout captured: wall s,
    reads/s and read-kb/s of ``n_reads`` reads of ``kb`` kb, K4/K1/K2
    launches, the SAM's hash and records, golden fallbacks, skips, the
    engine and its device wait, and the stdout."""
    import hashlib
    import torch
    from npore_tpu_torch.cli import realign as cli
    from npore_tpu_torch.ops import dp_cuda, npinfo_cuda, tb_cuda
    dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
    log = io.StringIO()
    box = []

    def run():
        box.append(cli.run(argv))
        torch.cuda.synchronize()
    with contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        prof = profile_pass(run) if profiled else run()
        wall = time.perf_counter() - t0
    rl = box[0]
    with open(sam_path, "rb") as fh:
        sam = fh.read()
    t = {"wall_s": wall, "reads_per_s": n_reads / wall,
         "read_kb_per_s": kb / wall,
         "launches": (npinfo_cuda.launches, dp_cuda.launches,
                      tb_cuda.launches),
         "records": sum(1 for line in sam.splitlines()
                        if not line.startswith(b"@")),
         "sha256": hashlib.sha256(sam).hexdigest(),
         "golden_fallbacks": rl.bail_count, "skipped": len(rl.skipped),
         "wait_s": rl._engine.wait_s, "engine": rl._engine,
         "stdout": log.getvalue()}
    if profiled:
        t["profile"] = prof
    return t


def throughput(passes) -> dict:
    """reads/s and read-kb/s (median, min, max), wall and device-wait
    seconds and K4/K1/K2 launches of ``realign_pass`` results."""
    rates = sorted(p["reads_per_s"] for p in passes)
    kbs = sorted(p["read_kb_per_s"] for p in passes)
    return {"passes": len(passes),
            "reads_per_s": {"median": rates[len(rates) // 2],
                            "min": rates[0], "max": rates[-1]},
            "read_kb_per_s": {"median": kbs[len(kbs) // 2], "min": kbs[0],
                              "max": kbs[-1]},
            "wall_s": [p["wall_s"] for p in passes],
            "device_wait_s": [p["wait_s"] for p in passes],
            "launches_k4_k1_k2": [p["launches"] for p in passes]}


def timed_passes(argv, sam_path: str, n_reads: int, kb: float,
                 n_passes: int):
    """``n_passes`` timed ``realign_pass`` runs, then one with
    NPORE_TIMING=1 and one under torch.profiler: (the timed runs, the
    NPORE_TIMING run, the profiled run, the device and pinned memory the
    first run added at its peak to what earlier phases still hold)."""
    before = memory_before()
    passes = []
    for k in range(n_passes):
        passes.append(realign_pass(argv, sam_path, n_reads, kb))
        if k == 0:
            memory = memory_added(before)
    os.environ["NPORE_TIMING"] = "1"
    try:
        timed = realign_pass(argv, sam_path, n_reads, kb)
    finally:
        del os.environ["NPORE_TIMING"]
    profiled = realign_pass(argv, sam_path, n_reads, kb, profiled=True)
    return passes, timed, profiled, memory


def long_reads_phase(tmp: str, stats: str, sub_scores, np_scores, cfg,
                     tables) -> dict:
    """[long reads]: the realign CLI with --engine cuda on LR_READS seeded
    reads of nanopore lengths, several windows each; see phase 22 of the
    module docstring."""
    import numpy as np
    import torch
    from npore_tpu_torch.cli import realign as cli
    from npore_tpu_torch.engine import cuda_engine
    from npore_tpu_torch.io.bam import open_alignment_file
    start = time.perf_counter()
    fasta, bam, reads = long_reads_input(tmp)
    gen_s = time.perf_counter() - start
    n_bases = sum(len(s) for _, s, _ in reads)
    kb = n_bases / 1e3
    pre = os.path.join(tmp, "long_out")
    argv = ["--bam", bam, "--ref", fasta, "--out_prefix", pre,
            "--stats_dir", stats, "--engine", "cuda"]
    batch_reads = cli.argparser().parse_args(argv).batch_reads
    passes, timed, profiled, memory = timed_passes(
        argv, pre + ".sam", LR_READS, kb, LR_PASSES)
    runs = passes + [timed, profiled]

    # the input as the engine cut it
    eng = passes[0]["engine"]
    t0 = time.perf_counter()          # a decode of the whole BAM, as the
    alns = [r.aln for r in open_alignment_file(bam)]   # CLI's region
    decode_s = time.perf_counter() - t0                # count makes one
    n_windows, groups = long_reads_groups(alns, eng, batch_reads)
    shapes = [(len(g), max(w.b_rows for w in g)) for g in groups]
    hist = np.bincount(np.minimum(n_windows, 4), minlength=5)
    t = {"reads": LR_READS, "read_bases": n_bases,
         "read_bases_ref_span": sum(len(a[0]) for a in alns),
         "longest_read": max(len(s) for _, s, _ in reads),
         "windows_a_read": {"1": int(hist[1]), "2": int(hist[2]),
                            "3": int(hist[3]), "4+": int(hist[4])},
         "windows": sum(n_windows), "groups": len(groups),
         "group_shapes": shapes, "batch_reads": batch_reads,
         "made_s": gen_s}
    print("[long reads] input: " + json.dumps(t), flush=True)
    thr = throughput(passes)
    print("[long reads] throughput: " + json.dumps(thr), flush=True)
    split = {"wall_s": timed["wall_s"], "bam_decode_s": decode_s,
             **stage_split(timed["stdout"], LR_READS, kb)}
    print("[long reads] timing: " + json.dumps(split), flush=True)
    print("[long reads] device: " + json.dumps(
        kernel_shares(profiled["profile"])), flush=True)
    memory["groups_in_flight"] = cuda_engine.GROUPS_IN_FLIGHT
    print("[long reads] memory: " + json.dumps(memory), flush=True)

    # kernels at the pass's fullest group of the longest windows
    g = max(groups, key=lambda g: (min(w.b_rows for w in g), len(g)))
    grp, npi = group_kernels("long reads", g, cfg, tables)

    gold = long_reads_golden(bam, pre + ".sam", n_windows, sub_scores,
                             np_scores, cfg)
    wall = time.perf_counter() - start
    print(f"[long reads] phase {wall:.2f}s", flush=True)
    fails = [what for what, ok in (
        ("records", all(r["records"] == LR_READS for r in runs)),
        ("skipped", all(r["skipped"] == 0 for r in runs)),
        ("SAM equal across passes", len({r["sha256"] for r in runs}) == 1),
        ("golden fallbacks", all(r["golden_fallbacks"] == 0 for r in runs)),
        ("launches = groups", all(r["launches"] == (len(groups),) * 3
                                  for r in runs)),
        ("engine's windows and groups",
         (eng.windows, eng.groups) == (sum(n_windows), len(groups))),
        ("K4 = pack_group and plain", npi["equal_pack_group"]
         and npi["equal_plain"]),
        ("K2 = plain", grp["k2_equal_plain"] and grp["k2_bails"] == 0),
        ("reads = golden", gold["reads_equal"] == gold["reads_checked"]
         == LR_READS)) if not ok]
    if fails:
        raise AssertionError(f"[long reads] failed: {fails}")
    return {"launches": passes[0]["launches"], "group": grp,
            "throughput": thr, "wall_s": wall}


def run_logged(cmd, prefix: str, timeout: float = 900) -> int:
    """Run ``cmd`` from the repo root with its stdout and stderr in
    ``{prefix}.out`` and ``{prefix}.err``, in a process group of its own
    whose every process is killed when it ends or outlasts ``timeout``;
    its exit code. On a failure it prints the tail of both files."""
    import signal
    with open(prefix + ".out", "w") as out, open(prefix + ".err", "w") as err:
        p = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=err,
                             process_group=0)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            try:
                os.killpg(p.pid, signal.SIGKILL)    # ranks it left behind
            except ProcessLookupError:
                pass
            p.wait()
    if rc != 0:
        for ext in (".out", ".err"):
            with open(prefix + ext) as fh:
                print(f"[{os.path.basename(prefix)}{ext}] exit {rc}, tail:\n"
                      + fh.read()[-4000:], flush=True)
    return rc


def genome_bam_phase(tmp: str, stats: str, sub_scores, np_scores, cfg,
                     tables) -> dict:
    """[genome bam]: see phase 23 of the module docstring. A failure
    prints the input's seed before it is raised."""
    try:
        return _genome_bam(tmp, stats, sub_scores, np_scores, cfg, tables)
    except BaseException:
        print(f"[genome bam] failed on testing/genome_reads.py's FULL "
              f"input of seed {GB_SEED}, {GB_PRIMARY} primary reads",
              flush=True)
        raise


def _genome_bam(tmp, stats, sub_scores, np_scores, cfg, tables) -> dict:
    import dataclasses
    from collections import Counter
    import numpy as np
    from npore_tpu_torch.config import RealignConfig
    from npore_tpu_torch.constants import bases_to_int
    from npore_tpu_torch.engine.regions import get_bam_regions
    from npore_tpu_torch.engine.windows import build_windows
    from npore_tpu_torch.cli import realign as cli
    from npore_tpu_torch.engine.stats import calc_confusion_matrices_bam
    from npore_tpu_torch.io.bam_native import NativeBamReader
    from npore_tpu_torch.io.fasta import FastaFile
    from npore_tpu_torch.parallel.distributed import shard_regions
    from npore_tpu_torch.scripts import multihost_scaling as mh
    from npore_tpu_torch.testing import genome_reads as gr
    start = time.perf_counter()
    layout = dataclasses.replace(gr.FULL, primary=GB_PRIMARY)
    genome = gr.make_genome_reads(GB_SEED, layout)
    fasta, bam = gr.write_genome_reads(tmp, genome)
    want = gr.expected_output(genome)
    made_s = time.perf_counter() - start
    kb = sum(len(r.aligned_seq) for r in want) / 1e3
    kinds_in = gr.counts(genome)
    no_md = sum(r.kind == gr.NO_MD and r.rname in genome.fasta
                for r in genome.reads)
    primary = [r for r in genome.reads if r.flag & 0x904 == 0]
    t = {"seed": GB_SEED, "primary": GB_PRIMARY,
         "records": len(genome.reads),
         "records_by_kind": kinds_in,
         "contigs": {n: len(s) for n, s in genome.fasta.items()},
         "header_only": [n for n, _ in genome.header
                         if n not in genome.fasta],
         "n_gaps": {n: g for n, g in genome.gaps.items() if g},
         "reads_out_expected": len(want), "read_kb_out_expected": kb,
         "reverse": sum(r.flag & 16 != 0 for r in primary),
         "soft_clipped": sum(r.clips != (0, 0) for r in primary),
         "clipped_bases": sum(sum(r.clips) for r in primary),
         "mapq0": sum(r.mapq == 0 for r in primary),
         "hp": sum("HP" in r.tags for r in primary),
         "spanning_n": sum(r.spans_gap for r in want),
         "longest": max(r.span for r in want),
         "bam_bytes": os.path.getsize(bam), "made_s": made_s}
    print("[genome bam] input: " + json.dumps(t), flush=True)

    # the realign CLI at its defaults: GB_PASSES timed passes, then one
    # with NPORE_TIMING=1 and one under the profiler
    pre = os.path.join(tmp, "gb_out")
    argv = ["--bam", bam, "--ref", fasta, "--out_prefix", pre,
            "--stats_dir", stats, "--engine", "cuda"]
    passes, timed, profiled, memory = timed_passes(
        argv, pre + ".sam", len(want), kb, GB_PASSES)
    runs = passes + [timed, profiled]
    thr = {**throughput(passes),
           "windows_groups": [(p["engine"].windows, p["engine"].groups)
                              for p in runs],
           "skipped": [p["skipped"] for p in runs],
           "golden_fallbacks": [p["golden_fallbacks"] for p in runs]}
    print("[genome bam] throughput: " + json.dumps(thr), flush=True)
    print("[genome bam] timing: " + json.dumps(
        {"wall_s": timed["wall_s"],
         **stage_split(timed["stdout"], len(want), kb)}), flush=True)
    print("[genome bam] device: " + json.dumps(
        kernel_shares(profiled["profile"])), flush=True)
    print("[genome bam] memory: " + json.dumps(memory), flush=True)

    # the CLI's fixed start on this genome: the FASTA, and the region
    # count, a decode of the whole BAM without the prep, through the
    # CLI's reader and through the decoder's own fetch, which seeks to
    # each contig (and rescans the file once it took it for unsorted)
    t0 = time.perf_counter()
    ref_fa = FastaFile(fasta)
    start_s = {"fasta_s": time.perf_counter() - t0}
    rcfg = RealignConfig(bam=bam, ref=fasta)
    counted = {}
    for name, reader in (("cli", cli.open_bam(bam, prep=False)),
                         ("seeking", NativeBamReader(bam, prep=False))):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # decoy_1's warning
            counted[name] = get_bam_regions(rcfg, ref_fa, reader)
        start_s[f"region_count_{name}_s"] = time.perf_counter() - t0
        reader.close()
    regions = counted["cli"]
    start_s["regions"] = len(regions)
    print("[genome bam] start: " + json.dumps(start_s), flush=True)

    # the records out against the input's, field by field
    with open(pre + ".sam") as fh:
        out = [line.rstrip("\n").split("\t") for line in fh
               if not line.startswith("@")]
    by_name = {f[0]: f for f in out}
    kind_of = {r.qname: r.kind for r in primary}
    t0 = time.perf_counter()
    gold = golden_cigars(
        [(bases_to_int(genome.fasta[r.rname][r.pos:r.pos + r.span]),
          bases_to_int(r.aligned_seq), r.cli_cigar) for r in want],
        sub_scores, np_scores, cfg)
    gold_s = time.perf_counter() - t0
    fields = ("flag", "rname", "pos", "mapq", "cigar", "seq", "qual", "tags")
    differ = {k: [] for k in fields}
    for r, g in zip(want, gold):
        f = by_name.get(r.qname)
        if f is None:
            continue
        hp = r.tags["HP"][1] if "HP" in r.tags else 0
        for k, got, exp in (
                ("flag", f[1], str(r.flag)), ("rname", f[2], r.rname),
                ("pos", f[3], str(r.pos + 1)), ("mapq", f[4], str(r.mapq)),
                ("cigar", f[5], g), ("seq", f[9], r.aligned_seq.upper()),
                ("qual", f[10], r.aligned_qual),
                ("tags", f[11:], [f"HP:i:{hp}"])):
            if got != exp:
                differ[k].append(r.qname)
    recs = {"records_out": len(out),
            "records_out_by_kind": dict(Counter(
                kind_of.get(f[0], "none") for f in out)),
            "records_out_not_primary": sum(int(f[1]) & 0x904 != 0
                                           for f in out),
            "missing": sorted({r.qname for r in want} - set(by_name))[:10],
            "unexpected": sorted(set(by_name) - {r.qname for r in want})[:10],
            "skipped_expected": no_md,
            "differ": {k: (len(v), v[:5]) for k, v in differ.items()},
            "golden_s": gold_s}
    print("[genome bam] records: " + json.dumps(recs), flush=True)

    # K4, K1 and K2 at a group of windows holding reference N
    eng = passes[0]["engine"]
    wins = []
    for i, r in enumerate(x for x in want if x.spans_gap):
        wins += build_windows(
            bases_to_int(genome.fasta[r.rname][r.pos:r.pos + r.span]),
            bases_to_int(r.aligned_seq), r.cli_cigar, eng.cfg, aln_idx=i)
    n_wins = sorted((w for w in wins if (w.ref[:w.n_del] == 0).any()),
                    key=lambda w: w.b_rows)[:GB_N_WINDOWS]
    grp, npi = group_kernels("genome bam", n_wins, cfg, tables)

    # training on two contigs, 1 rank and GB_RANKS ranks
    cms, train = {}, {}
    for n in (1, GB_RANKS):
        d = os.path.join(tmp, f"gb_stats{n}")
        row = mh.run_ranks(n, [
            "--bam", bam, "--ref", fasta, "--engine", "cuda",
            "--stats_dir", d, "--out_prefix", os.path.join(tmp, f"gb_cm{n}"),
            "--recalc_cms", "--recalc_exit", "--contigs", GB_TRAIN], tmp,
            f"gb_cm{n}")
        check_ranks(row, "[genome bam] training")
        cms[n] = [np.load(os.path.join(d, f"{k}_cm.npy"))
                  for k in ("subs", "nps", "inss", "dels")]
        train[n] = row["wall_s"]
    # the CLI's counts against engine.stats' own function on the same
    # contigs
    trn = {"contigs": GB_TRAIN, "wall_s": train,
           "equal": all(np.array_equal(a, b) for a, b in
                        zip(cms[1], cms[GB_RANKS])),
           "total": int(sum(int(a.sum()) for a in cms[GB_RANKS])),
           "subs_total": int(cms[GB_RANKS][0].sum())}
    on = {c: (c, 0, n - 1) for c, n in layout.contigs}
    copy_counts = calc_confusion_matrices_bam(
        bam, ref_fa, [on[c] for c in GB_TRAIN.split(",")], rcfg)
    trn["equal_stats_copy"] = all(np.array_equal(a, b)
                                  for a, b in zip(cms[1], copy_counts))
    print("[genome bam] training: " + json.dumps(trn), flush=True)
    del ref_fa

    # the rank split through the scaling script, on the one card
    wd = os.path.join(tmp, "gb_ranks")
    os.makedirs(wd)
    t0 = time.perf_counter()
    rc = run_logged([sys.executable, "-m", mh.MODULE, "--hosts",
                     str(GB_RANKS), "--engine", "cuda", "--bam", bam,
                     "--ref", fasta, "--stats_dir", stats, "--workdir", wd],
                    os.path.join(tmp, "gb_ranks"))
    if rc != 0:
        raise AssertionError(f"[genome bam] the scaling script exited {rc}")
    with open(os.path.join(tmp, "gb_ranks.out")) as fh:
        rows = [json.loads(line) for line in fh if line.startswith("{")]
    one = mh.records(os.path.join(wd, "cuda_r0_n1.sam"))
    rk = {"rc": rc, "wall_s": time.perf_counter() - t0,
          "regions": len(regions),
          "shards": [[c for c, _, _ in shard_regions(regions, GB_RANKS, h)]
                     for h in range(GB_RANKS)],
          "runs": [{"hosts": row["hosts"], "wall_s": row["wall_s"],
                    "seconds": row["seconds"], "reads": row["reads"],
                    "records_match_1host": row["records_match_1host"],
                    "efficiency": row["efficiency"],
                    "ranks": [{k: x[k] for k in ("reads", "seconds", "bails",
                                                 "k1_launches",
                                                 "peak_device_bytes")}
                              for x in row["ranks"]]} for row in rows],
          "one_rank_equals_passes": one == mh.records(pre + ".sam")}
    print("[genome bam] ranks: " + json.dumps(rk), flush=True)
    for row in rows:
        check_ranks(row, "[genome bam] ranks")

    wall = time.perf_counter() - start
    print(f"[genome bam] phase {wall:.2f}s", flush=True)
    n_groups = [p["engine"].groups for p in runs]
    fails = [what for what, ok in (
        ("records out", len(out) == len(by_name) == len(want)
         and not recs["missing"] and not recs["unexpected"]),
        ("no supplementary, secondary or unmapped record out",
         recs["records_out_not_primary"] == 0),
        ("skipped = the MD-less reads",
         all(p["skipped"] == no_md for p in runs)),
        ("fields carried and CIGARs = golden",
         not any(differ.values())),
        ("golden fallbacks", all(p["golden_fallbacks"] == 0
                                 for p in runs)),
        ("SAM equal across passes", len({p["sha256"] for p in runs}) == 1),
        ("launches = groups", all(
            p["launches"] == (g,) * 3 and g > 0
            for p, g in zip(runs, n_groups))),
        ("regions: chromosomes with reads on the FASTA",
         [c for c, _, _ in regions] == [c for c, _ in layout.contigs]),
        ("a group holding reference N", len(n_wins) > 0),
        ("K4 = pack_group and plain there", npi["equal_pack_group"]
         and npi["equal_plain"]),
        ("K2 = plain there", grp["k2_equal_plain"] and grp["k2_bails"] == 0),
        ("training: 1 rank = 2 ranks = engine.stats'",
         trn["equal"] and trn["subs_total"] and trn["equal_stats_copy"]),
        ("region count: the CLI's = the seeking decoder's",
         counted["cli"] == counted["seeking"]),
        ("ranks: 1, then 2", [r["hosts"] for r in rows] == [1, GB_RANKS]),
        ("ranks: merged = 1 rank = the passes' SAM",
         all(r["records_match_1host"] and r["reads"] == len(want)
             for r in rows) and rk["one_rank_equals_passes"])) if not ok]
    if fails:
        raise AssertionError(f"[genome bam] failed: {fails}")
    return {"launches": passes[0]["launches"], "group": grp,
            "throughput": thr, "wall_s": wall}


def long_reads_line(longr: dict, k: str) -> dict:
    """Kernel ``k``'s entry of the kernels line for [long reads]: its
    launches in the first timed pass, and its times and bound at the
    pass's fullest long group."""
    g = longr["group"]
    t = {"launches_per_pass": longr["launches"][("k4", "k1", "k2").index(k)],
         "group": [g["B"], g["R"]]}
    if k == "k4":
        return {**t, "ms": g["k4"]["ms"], "device_ms": g["k4"]["device_ms"],
                "bound_ms": g["k4"]["bound_ms"]}
    if k == "k1":
        return {**t, "ms": g["k1_ms"], "device_ms": g["k1_device_ms"],
                "bound_ms": g["k1_bound"]["bound_ms"],
                "ctas_per_sm": g["k1_ctas_per_sm"]}
    return {**t, "ms": g["k2_ms"], "cold_ms": g["k2_cold_ms"],
            "cold_device_ms": g["k2_cold_device_ms"],
            "plain_ms": g["k2_plain_ms"],
            "bound_ms": g["k2_bound"]["bound_ms"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from npore_tpu_torch import native
    from npore_tpu_torch.cli import realign as cli
    from npore_tpu_torch.config import AlignConfig
    from npore_tpu_torch.engine.realigner import Realigner
    from npore_tpu_torch.io.bam import open_alignment_file
    from npore_tpu_torch.io.bam_native import NativeBamReader
    from npore_tpu_torch.model.scores import (calc_score_matrices,
                                              load_confusion_matrices)
    from npore_tpu_torch.ops import (_build, dp_cuda, npinfo_cuda, tb_cuda,
                                     tier_select_cuda)
    from npore_tpu_torch.ops.band_dp import pack_planes, window_dp
    from npore_tpu_torch.ops.tables import tables_from_numpy
    from npore_tpu_torch.ops.tier_select import tier_select_plain
    from npore_tpu_torch.ops.traceback import traceback as tb_plain
    from npore_tpu_torch.scripts import probe_cond
    print(nvidia_smi())
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # --- 2. build ---
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(per source: " + ", ".join(
              f"{k} {v:.1f}s" for k, v in _build.build_seconds.items()) + ")")
    for name, log in _build.build_logs.items():
        tag = name
        for line in log.splitlines():
            if "Compiling entry function" in line:
                n = re.search(r"ILi(\d+)E", line)     # K1's max_n template
                tag = f"{name} max_n={n.group(1)}" if n else name
            if "registers" in line or "spill" in line:
                print(f"[ptxas {tag}] {line.strip()}")

    # --- 3. the port's C++ host library ---
    data = os.path.join(REPO, "tests", "data")
    lib = native.get_lib()
    lib_dir = os.path.dirname(native.lib_path or "")
    reader = open_alignment_file(os.path.join(data, "reads.bam"))
    print(f"[host] C++ library {native.lib_path}; reads.bam opens as "
          f"{type(reader).__module__}.{type(reader).__name__}", flush=True)
    if lib is None or os.path.realpath(lib_dir) != os.path.realpath(
            _build.build_dir()):
        raise AssertionError("the port's C++ host library did not load from "
                             f"its build directory {_build.build_dir()}")
    if not isinstance(reader, NativeBamReader):
        raise AssertionError("reads.bam did not open as the port's "
                             "NativeBamReader")

    dev = torch.device("cuda")
    cfg = AlignConfig()
    stats = os.path.join(REPO, "guppy5_stats")
    sub_scores, np_scores, _, _ = calc_score_matrices(
        *load_confusion_matrices(stats))
    tables = tables_from_numpy(sub_scores, np_scores, cfg, dev)
    fixture = [r for r in open_alignment_file(os.path.join(data, "reads.bam"))
               if not (r.is_secondary or r.is_supplementary
                       or r.is_unmapped)]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    mixed_bam = os.path.join(tmp.name, "mixed.bam")
    write_mixed_bam(mixed_bam)
    mixed = list(open_alignment_file(mixed_bam))

    # --- 4. K1 vs plain DP, 5. K2 vs plain traceback ---
    items = items_of(fixture) + items_of(mixed)
    wins, batch = device_group(items, cfg, dev)
    B, R = len(wins), batch["inss"].shape[1] - 8
    packed = dp_cuda.band_dp(batch, tables, cfg)
    torch.cuda.synchronize()
    typ, run = window_dp(batch, tables, cfg)
    plain = pack_planes(typ, run)
    k1_err = int((packed - plain).abs().max())
    k1_typ_eq = torch.equal(packed & 7, plain & 7)
    k1_run_eq = torch.equal(packed >> 3, plain >> 3)
    print(f"[K1] {B} windows x {R} rows: typ equal {k1_typ_eq}, run equal "
          f"{k1_run_eq}, max |diff| {k1_err}", flush=True)
    if not (k1_typ_eq and k1_run_eq):
        raise AssertionError("K1 planes differ from the plain DP")
    L = max(w.n_ins + w.n_del for w in wins)
    out_k = tb_cuda.traceback(packed, batch, cfg, L)
    out_p = tb_plain(packed, batch, cfg, L)
    torch.cuda.synchronize()
    k2_err = int((out_k.buf.int() - out_p.buf.int()).abs().max())
    n_bail = int(out_k.meta[:, 1].sum())
    print(f"[K2] {B} windows: buffers equal {torch.equal(out_k.buf, out_p.buf)}"
          f", max |diff| {k2_err}, bails {n_bail}", flush=True)
    if not torch.equal(out_k.buf, out_p.buf):
        raise AssertionError("K2 output differs from the plain traceback")
    if n_bail:
        raise AssertionError(f"{n_bail} windows bailed in the traceback")

    # --- 6. the main path: realign CLI, --engine cuda ---
    dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
    pre = os.path.join(tmp.name, "out")
    t0 = time.perf_counter()
    rl = cli.run(["--bam", os.path.join(data, "reads.bam"),
                  "--ref", os.path.join(data, "ref.fasta"),
                  "--out_prefix", pre, "--stats_dir", stats,
                  "--engine", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    k1_launches, k2_launches = dp_cuda.launches, tb_cuda.launches
    k4_launches = npinfo_cuda.launches
    same = sam_parity(pre + ".sam",
                      os.path.join(data, "npore_realigned.sam"))
    print(f"[e2e] golden SAM records equal: {same}/10, bail_count "
          f"{rl.bail_count}, launches K4 {k4_launches} K1 {k1_launches} K2 "
          f"{k2_launches}, {e2e_s:.2f}s", flush=True)
    if same != 10 or rl.bail_count != 0:
        raise AssertionError("the CUDA engine does not reproduce the "
                             "golden SAM")
    if min(k1_launches, k2_launches, k4_launches) < 1:
        raise AssertionError("the main path did not launch K4, K1 and K2")

    # --- 7. throughput, kernel times and bounds ---
    eng = Realigner(sub_scores, np_scores, cfg, engine="cuda")
    list(eng.realign_records(iter(fixture * 4), batch_size=256))   # warm
    bam = open_alignment_file(os.path.join(data, "reads.bam"))

    def work():
        for _ in range(REPLICAS):
            for r in bam:
                if not (r.is_secondary or r.is_supplementary
                        or r.is_unmapped):
                    yield r
    rep_m = 16

    def streamed(n, run):
        """reads/s of ``run`` and its K4/K1/K2 launches per pass."""
        dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
        out = rate_stats(n, run)
        out["k4_launches_per_pass"] = npinfo_cuda.launches / PASSES
        out["k1_launches_per_pass"] = dp_cuda.launches / PASSES
        out["k2_launches_per_pass"] = tb_cuda.launches / PASSES
        return out
    fixture_rps = streamed(REPLICAS * len(fixture), lambda: (
        eng.realign_records(work(), batch_size=BATCH)))
    mixed_rps = streamed(len(mixed) * rep_m, lambda: (
        eng.realign_records(iter(mixed * rep_m), batch_size=BATCH)))
    if eng.bail_count:
        raise AssertionError(f"{eng.bail_count} golden fallbacks under load")
    print(f"[throughput] fixture x{REPLICAS} (batch {BATCH}) reads/s "
          f"{json.dumps(fixture_rps)}; mixed set x{rep_m} reads/s "
          f"{json.dumps(mixed_rps)}", flush=True)
    if fixture_rps["k4_launches_per_pass"] != fixture_rps[
            "k1_launches_per_pass"]:
        raise AssertionError("the main path did not launch K4 once a group")

    # --- [host split]: one fixture pass under the profiler, one timed ---
    n_fx = REPLICAS * len(fixture)
    split = {"profile": profile_pass(lambda: sum(
        1 for _ in eng.realign_records(work(), batch_size=BATCH)))}
    log = io.StringIO()
    os.environ["NPORE_TIMING"] = "1"
    try:
        with contextlib.redirect_stdout(log):
            t0 = time.perf_counter()
            got = sum(1 for _ in eng.realign_records(work(),
                                                     batch_size=BATCH))
            split["timed_pass_s"] = time.perf_counter() - t0
    finally:
        del os.environ["NPORE_TIMING"]
    m = re.search(r"submit (\d+)us, collect-wait (\d+)us, finalize\+emit "
                  r"(\d+)us, decode-wait (\d+)us, main-wait (\d+)us",
                  log.getvalue())
    if got != n_fx or m is None:
        raise AssertionError("the timed fixture pass lost records or its "
                             "NPORE_TIMING line")
    split["per_read_us"] = dict(zip(
        ("submit", "collect_wait", "finalize_emit", "decode_wait",
         "main_wait"), map(int, m.groups())))
    split["reads"] = n_fx
    print("[host split] fixture pass: " + json.dumps(split), flush=True)

    # --- [fuzz] and [bench engine] ---
    from npore_tpu_torch.scripts import bench_engine, fuzz_parity
    dp_cuda.launches = tb_cuda.launches = npinfo_cuda.launches = 0
    fuzz = fuzz_parity.run(FUZZ_CASES, 0, "cuda", stats)
    fuzz["launches_k4_k1_k2"] = (npinfo_cuda.launches, dp_cuda.launches,
                                 tb_cuda.launches)
    print("[fuzz] " + json.dumps(fuzz), flush=True)
    if fuzz["equal"] != FUZZ_CASES or min(fuzz["launches_k4_k1_k2"]) < 1:
        raise AssertionError("the fuzzer found the CUDA engine differing "
                             "from the golden aligner")
    bench = bench_engine.run(REPLICAS, "cuda", 3, REPO)
    print("[bench engine] " + json.dumps(bench), flush=True)
    if bench["bails"]:
        raise AssertionError("the engine bench fell back to golden")

    shapes, groups, npinfo = {}, {}, {}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name in ("fixture", "mixed", "long"):
        if name == "long":
            wins, batch = long_group(cfg, dev)
        else:
            its = (items_of(fixture) * (BATCH // 10 + 1) if name == "fixture"
                   else items_of(mixed))[:BATCH]
            wins, batch = device_group(its, cfg, dev)
        L = max(w.n_ins + w.n_del for w in wins)
        packed = dp_cuda.band_dp(batch, tables, cfg)
        t = {"B": len(wins), "R": batch["inss"].shape[1] - 8}
        plan = tb_cuda.launch_plan(t["B"], t["R"])
        t["k2_plan"] = plan._asdict()
        t["k2_ctas_per_sm"] = tb_cuda.occupancy(t["B"], t["R"])
        t["k1_ms"], _ = median_ms(
            lambda: dp_cuda.band_dp(batch, tables, cfg))
        t["k1_device_ms"], _ = median_ms(
            lambda: dp_cuda.band_dp(batch, tables, cfg), queued=True)

        def k2():
            return tb_cuda.traceback(packed, batch, cfg, L)
        t["k2_ms"], out_k = median_ms(k2)
        t["k2_cold_ms"], out_c = median_ms(k2, flush=flush)
        t["k2_device_ms"], _ = median_ms(k2, queued=True)
        t["k2_cold_device_ms"], _ = median_ms(k2, flush=flush, queued=True)
        # the plain versions are timed cold: they compile nothing, and a
        # warm-up call of the DP costs tens of seconds; at the long group
        # the plain DP would take hours and the traceback runs once
        if name != "long":
            t["k1_plain_ms"], planes = median_ms(
                lambda: window_dp(batch, tables, cfg), warm=False,
                reps=PLAIN_DP_REPS)
            plain = pack_planes(*planes)
            groups[name] = (batch, plain)
            t["k1_max_diff"] = int((packed - plain).abs().max())
        t["k2_plain_ms"], out_p = median_ms(
            lambda: tb_plain(packed, batch, cfg, L), warm=False,
            reps=1 if name == "long" else REPS)
        t["k2_max_diff"] = max(
            int((o.buf.int() - out_p.buf.int()).abs().max())
            for o in (out_k, out_c))
        t["k2_bails"] = int(out_k.meta[:, 1].sum())
        shapes[name] = t
        if name != "long":
            t["k1_bound"] = k1_bound(wins, batch, tables, cfg, packed)
        t["k2_bound"] = k2_bound(wins, out_k)
        print(f"[times {name}] " + json.dumps(t), flush=True)
        npinfo[name] = npinfo_check(name, wins, batch, cfg, dev)
        if name == "fixture":
            npinfo["split_fixture"] = host_split_group(name, wins, cfg, dev)
        if name != "long" and not torch.equal(packed, plain):
            raise AssertionError(f"K1 planes differ from the plain DP ({name})")
        if not (torch.equal(out_k.buf, out_p.buf)
                and torch.equal(out_c.buf, out_p.buf)):
            raise AssertionError(
                f"K2 output differs from the plain traceback ({name})")
    del flush, packed, batch, out_k, out_c, out_p
    npinfo["ntails"] = npinfo_check("ntails", *ntails_group(cfg, dev), cfg,
                                    dev)
    print(f"[K2] k2_long_ms {shapes['long']['k2_ms']} warm, "
          f"{shapes['long']['k2_cold_ms']} cold, at "
          f"{shapes['long']['B']} windows x {shapes['long']['R']} rows",
          flush=True)
    tmp.cleanup()

    # --- 8. K1 wave sweep on the fixture group ---
    batch, plain = groups.pop("fixture")
    R = batch["inss"].shape[1] - 8
    occ = dp_cuda.occupancy(cfg)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = []
    for nb in SWEEP:
        part = {k: v[:nb] for k, v in batch.items()}
        ms, got = median_ms(lambda: dp_cuda.band_dp(part, tables, cfg))
        t = {"B": nb, "R": R, "ms": ms, "us_per_row": ms * 1e3 / R,
             "ctas_per_sm": occ, "waves": -(-nb // (occ * sms)),
             "max_abs_err": int((got - plain[:nb]).abs().max())}
        sweep.append(t)
        print("[K1 sweep] " + json.dumps(t), flush=True)
        if not torch.equal(got, plain[:nb]):
            raise AssertionError(f"K1 planes differ from the plain DP on the "
                                 f"first {nb} windows")
    print(f"[K1 sweep] {SWEEP[-1]} windows take "
          f"{sweep[-1]['ms'] / sweep[0]['ms']:.3f}x the time of "
          f"{SWEEP[0]}", flush=True)

    # --- 15. [mesh] on the same group ---
    mesh = mesh_phase(batch, plain, tables, cfg)
    del batch, plain, groups

    # --- 9. K3 vs the plain k-select, then the K3 path ---
    k3 = []
    for i, (W, qx, lanes, q, n_steps) in enumerate(K3_SHAPES):
        x, run0 = k3_input(i, dev)
        t = {"W": W, "Qx": qx, "LANES": lanes, "Q": q, "N": n_steps}
        t["ms"], got = median_ms(
            lambda: tier_select_cuda.tier_select(x, n_steps, q, run0))
        t["device_ms"], _ = median_ms(
            lambda: tier_select_cuda.tier_select(x, n_steps, q, run0),
            queued=True)
        t["plain_ms"], want = median_ms(
            lambda: tier_select_plain(x, n_steps, q, run0))
        t["max_abs_err"] = float((got - want).abs().max())
        t.update(k3_bound(W, q, lanes, n_steps))
        k3.append(t)
        print("[K3] " + json.dumps(t), flush=True)
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs from the plain k-select at {t}")
    x, _ = k3_input(0, dev)
    n0 = [median_ms(lambda: tier_select_cuda.tier_select(x, 0, 16),
                    queued=queued)[0] for queued in (False, True)]
    print(f"[K3] N=0 at {K3_SHAPES[0][:3]} (a launch with no step): "
          f"{n0[0]} ms, device {n0[1]} ms", flush=True)
    tier_select_cuda.launches = 0
    probe_cond.main()
    torch.cuda.synchronize()
    k3_launches = tier_select_cuda.launches
    print(f"[K3 path] probe_cond.main(): launches K3 {k3_launches}",
          flush=True)
    if k3_launches < 1:
        raise AssertionError("the probe did not launch K3")

    # --- 10-14. the downstream tools ---
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_std_")
    std_fixture(tmp.name, stats)
    std_parity(tmp.name, stats, sub_scores, np_scores, cfg)
    scale = std_scale(tmp.name, stats, sub_scores, np_scores, cfg, tables)
    bed_phase(tmp.name, os.path.join(tmp.name, "contig1.fasta"),
              STD_SCALE[0])
    purity_phase(dev)
    tmp.cleanup()

    # --- 16-19. the multi-device layer ---
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    dist = dist_realign(tmp.name, stats)
    scale_ranks = dist_scale(tmp.name, stats)
    tmp.cleanup()
    purity_mesh_phase()
    dp_cuda.launches = tb_cuda.launches = 0
    from npore_tpu_torch.scripts import dryrun_multichip
    if dryrun_multichip.main(["--device", "cuda", "--n", "2"]) != 0:
        raise AssertionError("dryrun_multichip failed")
    torch.cuda.synchronize()
    dryrun = (dp_cuda.launches, tb_cuda.launches)
    print(f"[dryrun] K1/K2 launches {dryrun}", flush=True)
    if min(dryrun) < 2:
        raise AssertionError("the dry run did not launch K1 and K2 on both "
                             "shards")

    # --- 20-21. the genome-scale harness and the port's scripts ---
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_genome_")
    genome = genome_phase(tmp.name, stats, sub_scores, np_scores, cfg)
    scripts_phase(tmp.name)
    tmp.cleanup()

    # --- 22. nanopore read lengths through the realign CLI ---
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_long_")
    longr = long_reads_phase(tmp.name, stats, sub_scores, np_scores, cfg,
                             tables)
    tmp.cleanup()

    # --- 23. a whole-genome minimap2 BAM through the realign CLI ---
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_genome_bam_")
    gbam = genome_bam_phase(tmp.name, stats, sub_scores, np_scores, cfg,
                            tables)
    tmp.cleanup()

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m == "npore_tpu" or m.startswith("npore_tpu."))
    if loaded:
        raise AssertionError(f"the port's path loaded {loaded}")

    fx = shapes["fixture"]
    k4_checks = [npinfo[k] for k in ("fixture", "mixed", "long",
                                     "ntails")] + [
        scale["npinfo"]]
    kernels = [
        {"name": "band_dp", "route": "cuda",
         "source": "npore_tpu_torch/csrc/band_dp.cu",
         "replaces": "npore_tpu/ops/pallas_dp.py:779",
         "launches": k1_launches,
         "max_abs_err": max([k1_err] + [t["k1_max_diff"]
                                        for t in shapes.values()
                                        if "k1_max_diff" in t]),
         "ms": fx["k1_ms"], "device_ms": fx["k1_device_ms"],
         "plain_ms": fx["k1_plain_ms"],
         "bound_ms": fx["k1_bound"]["bound_ms"],
         "bound_by": fx["k1_bound"]["bound_by"],
         "library_ms": None,
         "std_scale": {"launches": scale["k1_launches"],
                       "group_ms": scale["group"]["k1_ms"],
                       "group_bound_ms":
                           scale["group"]["k1_bound"]["bound_ms"],
                       "run_bound_ms":
                           scale["group"]["k1_run_bound"]["bound_ms"]},
         "launches_multi_device": {
             "mesh": mesh["launches"],
             "dist_realign": dist["k1_k2_launches"][0],
             "dist_scale": scale_ranks["k1_launches"],
             "dryrun": dryrun[0]},
         "genome_scale": {"realign": genome["launches_realign"]["k1"],
                          "std": genome["launches_std"]["k1"]},
         "long_reads": long_reads_line(longr, "k1"),
         "genome_bam": long_reads_line(gbam, "k1")},
        {"name": "traceback", "route": "cuda",
         "source": "npore_tpu_torch/csrc/traceback.cu",
         "replaces": "npore_tpu/ops/pallas_dp.py:981",
         "launches": k2_launches,
         "max_abs_err": max([k2_err] + [t["k2_max_diff"]
                                        for t in shapes.values()]),
         "ms": fx["k2_ms"], "cold_ms": fx["k2_cold_ms"],
         "device_ms": fx["k2_device_ms"],
         "cold_device_ms": fx["k2_cold_device_ms"],
         "plain_ms": fx["k2_plain_ms"],
         "bound_ms": fx["k2_bound"]["bound_ms"],
         "bound_by": fx["k2_bound"]["bound_by"],
         "library_ms": None,
         "std_scale": {"launches": scale["k2_launches"],
                       "group_ms": scale["group"]["k2_cold_ms"],
                       "group_bound_ms":
                           scale["group"]["k2_bound"]["bound_ms"],
                       "run_bound_ms":
                           scale["group"]["k2_run_bound"]["bound_ms"]},
         "launches_multi_device": {
             "dist_realign": dist["k1_k2_launches"][1],
             "dist_scale": scale_ranks["k2_launches"],
             "dryrun": dryrun[1]},
         "genome_scale": {"realign": genome["launches_realign"]["k2"],
                          "std": genome["launches_std"]["k2"]},
         "long_reads": long_reads_line(longr, "k2"),
         "genome_bam": long_reads_line(gbam, "k2")},
        {"name": "tier_select", "route": "cuda",
         "source": "npore_tpu_torch/csrc/tier_select.cu",
         "replaces": "scripts/probe_cond.py:50",
         "launches": k3_launches,
         "max_abs_err": max(t["max_abs_err"] for t in k3),
         "ms": k3[0]["ms"], "device_ms": k3[0]["device_ms"],
         "plain_ms": k3[0]["plain_ms"],
         "bound_ms": k3[0]["bound_ms"], "bound_by": k3[0]["bound_by"],
         "library_ms": None},
        {"name": "npinfo", "route": "cuda",
         "source": "npore_tpu_torch/csrc/npinfo.cu",
         "replaces": "npore_tpu/ops/npinfo_device.py:48",
         "launches": k4_launches,
         "max_abs_err": max(t["max_abs_err"] for t in k4_checks),
         "ms": npinfo["fixture"]["ms"],
         "device_ms": npinfo["fixture"]["device_ms"],
         "plain_ms": npinfo["fixture"]["plain_ms"],
         "bound_ms": npinfo["fixture"]["bound_ms"],
         "bound_by": npinfo["fixture"]["bound_by"],
         "library_ms": None,
         "launches_per_pass": fixture_rps["k4_launches_per_pass"],
         "std_scale": {"launches": scale["k4_launches"],
                       "group_ms": scale["npinfo"]["ms"],
                       "group_device_ms": scale["npinfo"]["device_ms"],
                       "group_bound_ms": scale["npinfo"]["bound_ms"]},
         "genome_scale": {"realign": genome["launches_realign"]["k4"],
                          "std": genome["launches_std"]["k4"]},
         "long_reads": long_reads_line(longr, "k4"),
         "genome_bam": long_reads_line(gbam, "k4")},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
