"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # without one or on any failed check

Phases:
  1. the card (nvidia-smi name and power limit) and torch version;
  2. build kernels K1 (csrc/band_dp.cu) and K2 (csrc/traceback.cu) with nvcc;
  3. K1 against the plain PyTorch DP on the fixture reads and 24 synthetic
     reads from each of four length buckets (120-1400 bp), at the
     production AlignConfig(): typ/run planes must be bit-equal;
  4. K2 against the plain traceback on K1's planes: CIGAR bytes, lengths
     and bails must be equal;
  5. the realign CLI with --engine cuda on tests/data/reads.bam must
     reproduce tests/data/npore_realigned.sam (header, 11 fields, tags;
     10/10) with no golden fallback, and launch both kernels;
  6. throughput: the fixture replicated x256 (batch 1024) and the mixed
     set, each streamed 5 times (median, min and max reads/s); kernel and
     plain-version times at those groups' shapes (CUDA events, median of 5;
     kernels after one warm-up call), with the kernels' outputs required
     equal to the plain versions' there too;
  7. a JSON line of kernels, then the device line last.

Like the port, the script uses only those host modules of ``npore_tpu``
that load no JAX (BAM/SAM I/O, config, score matrices); it fails if the
run loaded ``jax``.
"""
from __future__ import annotations

import json
import os
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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def median_ms(fn, reps: int = REPS, warm: bool = True):
    """Median CUDA-event time of ``fn`` over ``reps`` calls, and the last
    call's result."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


def items_of(reads):
    from npore_tpu.constants import bases_to_int
    from npore_tpu.io.cigar import expand_cigar
    from npore_tpu_torch.engine.realigner import AlignItem
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


def write_mixed_bam(path: str) -> None:
    """24 seeded synthetic reads per length bucket, written with their true
    alignments (tests/generate_data.py), as bench.py builds its mixed set."""
    import importlib.util
    import numpy as np
    from npore_tpu.io.bam_writer import write_bam
    from npore_tpu.io.cigar import collapse_cigar
    from npore_tpu.io.sam import SamRecord
    spec = importlib.util.spec_from_file_location(
        "gen_data", os.path.join(REPO, "tests", "generate_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
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
    from npore_tpu.config import AlignConfig
    from npore_tpu.io.bam import open_alignment_file
    from npore_tpu.model.scores import (calc_score_matrices,
                                        load_confusion_matrices)
    from npore_tpu_torch.cli import realign as cli
    from npore_tpu_torch.engine.realigner import Realigner
    from npore_tpu_torch.ops import _build, dp_cuda, tb_cuda
    from npore_tpu_torch.ops.band_dp import pack_planes, window_dp
    from npore_tpu_torch.ops.tables import tables_from_numpy
    from npore_tpu_torch.ops.traceback import traceback as tb_plain
    print(nvidia_smi())
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # --- 2. build ---
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] both kernels in {time.perf_counter() - t0:.1f}s "
          f"(per source: " + ", ".join(
              f"{k} {v:.1f}s" for k, v in _build.build_seconds.items()) + ")")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    dev = torch.device("cuda")
    cfg = AlignConfig()
    data = os.path.join(REPO, "tests", "data")
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

    # --- 3. K1 vs plain DP, 4. K2 vs plain traceback ---
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

    # --- 5. the main path: realign CLI, --engine cuda ---
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

    # --- 6. throughput and kernel times ---
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
    fixture_rps = rate_stats(REPLICAS * len(fixture), lambda: (
        eng.realign_records(work(), batch_size=BATCH)))
    mixed_rps = rate_stats(len(mixed) * rep_m, lambda: (
        eng.realign_records(iter(mixed * rep_m), batch_size=BATCH)))
    if eng.bail_count:
        raise AssertionError(f"{eng.bail_count} golden fallbacks under load")
    print(f"[throughput] fixture x{REPLICAS} (batch {BATCH}) reads/s "
          f"{json.dumps(fixture_rps)}; mixed set x{rep_m} reads/s "
          f"{json.dumps(mixed_rps)}", flush=True)

    shapes = {}
    for name, its in (("fixture", items_of(fixture) * (BATCH // 10 + 1)),
                      ("mixed", items_of(mixed))):
        its = its[:BATCH]
        wins, batch = device_group(its, cfg, dev)
        L = max(w.n_ins + w.n_del for w in wins)
        packed = dp_cuda.band_dp(batch, tables, cfg)
        t = {"B": len(wins), "R": batch["inss"].shape[1] - 8}
        t["k1_ms"], _ = median_ms(
            lambda: dp_cuda.band_dp(batch, tables, cfg))
        # the plain versions are timed cold: they compile nothing, and a
        # warm-up call of the DP costs tens of seconds
        t["k1_plain_ms"], planes = median_ms(
            lambda: window_dp(batch, tables, cfg), warm=False)
        t["k2_ms"], out_k = median_ms(
            lambda: tb_cuda.traceback(packed, batch, cfg, L))
        t["k2_plain_ms"], out_p = median_ms(
            lambda: tb_plain(packed, batch, cfg, L), warm=False)
        plain = pack_planes(*planes)
        t["k1_max_diff"] = int((packed - plain).abs().max())
        t["k2_max_diff"] = int((out_k.buf.int() - out_p.buf.int()).abs().max())
        shapes[name] = t
        print(f"[times {name}] " + json.dumps(t), flush=True)
        if not torch.equal(packed, plain):
            raise AssertionError(f"K1 planes differ from the plain DP ({name})")
        if not torch.equal(out_k.buf, out_p.buf):
            raise AssertionError(
                f"K2 output differs from the plain traceback ({name})")
    tmp.cleanup()

    if "jax" in sys.modules:
        raise AssertionError("the port's path loaded jax")

    fx = shapes["fixture"]
    kernels = [
        {"name": "band_dp", "route": "cuda",
         "source": "npore_tpu_torch/csrc/band_dp.cu",
         "replaces": "npore_tpu/ops/pallas_dp.py:779",
         "launches": k1_launches,
         "max_abs_err": max([k1_err] + [t["k1_max_diff"]
                                        for t in shapes.values()]),
         "ms": fx["k1_ms"], "plain_ms": fx["k1_plain_ms"]},
        {"name": "traceback", "route": "cuda",
         "source": "npore_tpu_torch/csrc/traceback.cu",
         "replaces": "npore_tpu/ops/pallas_dp.py:981",
         "launches": k2_launches,
         "max_abs_err": max([k2_err] + [t["k2_max_diff"]
                                        for t in shapes.values()]),
         "ms": fx["k2_ms"], "plain_ms": fx["k2_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
