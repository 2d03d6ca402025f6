"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # without one or on any failed check

Phases:
  1. the card (nvidia-smi name and power limit) and torch version;
  2. build kernels K1 (csrc/band_dp.cu), K2 (csrc/traceback.cu) and K3
     (csrc/tier_select.cu) with nvcc, one process per source, and print
     ptxas registers and shared memory of each;
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
     10/10) with no golden fallback, and launch both kernels;
  7. throughput: the fixture replicated x256 (batch 1024) and the mixed
     set, each streamed 5 times (median, min and max reads/s, K1/K2
     launches per pass); kernel and plain-version times at those groups'
     shapes (CUDA events, median of 5; kernels after one warm-up call),
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
     shared memory) and the CTAs resident an SM (``tb_cuda.occupancy``);
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
 10. a JSON line of kernels (launches on their path, error, times, and the
     least time the card could take for the same work), then the device
     line last.

The script imports nothing of JAX or of ``npore_tpu``: it fails if the run
loaded ``jax``, ``npore_tpu`` or any ``npore_tpu.*`` module.
"""
from __future__ import annotations

import json
import os
import re
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
PASSES = 5       # timed passes of each throughput stream
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
    from npore_tpu_torch.ops import _build, dp_cuda, tb_cuda, tier_select_cuda
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
    dp_cuda.launches = 0
    tb_cuda.launches = 0
    pre = os.path.join(tmp.name, "out")
    t0 = time.perf_counter()
    rl = cli.run(["--bam", os.path.join(data, "reads.bam"),
                  "--ref", os.path.join(data, "ref.fasta"),
                  "--out_prefix", pre, "--stats_dir", stats,
                  "--engine", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    k1_launches, k2_launches = dp_cuda.launches, tb_cuda.launches
    same = sam_parity(pre + ".sam",
                      os.path.join(data, "npore_realigned.sam"))
    print(f"[e2e] golden SAM records equal: {same}/10, bail_count "
          f"{rl.bail_count}, launches K1 {k1_launches} K2 {k2_launches}, "
          f"{e2e_s:.2f}s", flush=True)
    if same != 10 or rl.bail_count != 0:
        raise AssertionError("the CUDA engine does not reproduce the "
                             "golden SAM")
    if k1_launches < 1 or k2_launches < 1:
        raise AssertionError("the main path did not launch both kernels")

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
        """reads/s of ``run`` and its K1/K2 launches per pass."""
        dp_cuda.launches = tb_cuda.launches = 0
        out = rate_stats(n, run)
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

    shapes, groups = {}, {}
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
                lambda: window_dp(batch, tables, cfg), warm=False)
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
        if name != "long" and not torch.equal(packed, plain):
            raise AssertionError(f"K1 planes differ from the plain DP ({name})")
        if not (torch.equal(out_k.buf, out_p.buf)
                and torch.equal(out_c.buf, out_p.buf)):
            raise AssertionError(
                f"K2 output differs from the plain traceback ({name})")
    del flush, packed, batch, out_k, out_c, out_p
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

    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m == "npore_tpu" or m.startswith("npore_tpu."))
    if loaded:
        raise AssertionError(f"the port's path loaded {loaded}")

    fx = shapes["fixture"]
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
         "library_ms": None},
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
         "library_ms": None},
        {"name": "tier_select", "route": "cuda",
         "source": "npore_tpu_torch/csrc/tier_select.cu",
         "replaces": "scripts/probe_cond.py:50",
         "launches": k3_launches,
         "max_abs_err": max(t["max_abs_err"] for t in k3),
         "ms": k3[0]["ms"], "device_ms": k3[0]["device_ms"],
         "plain_ms": k3[0]["plain_ms"],
         "bound_ms": k3[0]["bound_ms"], "bound_by": k3[0]["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
