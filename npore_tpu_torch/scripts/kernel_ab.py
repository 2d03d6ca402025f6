"""Time a kernel against an earlier version of its source, in turns, on
one CUDA card.

    git show HEAD:npore_tpu_torch/csrc/traceback.cu > chip_proof/traceback_old.cu
    python -m npore_tpu_torch.scripts.kernel_ab --kernel k2 --old chip_proof/traceback_old.cu

``--kernel`` is k1 (``csrc/band_dp.cu``), k2 (``csrc/traceback.cu``), k3
(``csrc/tier_select.cu``) or k4 (``csrc/npinfo.cu``). The old source is
compiled with the port's nvcc flags into the directory that holds it and
loaded on its own; it must export the kernel's entry point
(``npore_band_dp``, ``npore_traceback``, ``npore_tier_select`` or
``npore_npinfo``) with the signature its wrapper passes, except that an
old K2 without ``npore_traceback_occupancy`` is launched as the one thread
a window K2 was (no launch-plan arguments), and an old K4 without
``npore_npinfo_occupancy`` as K4 was first written (no ``staged``
argument). An old K4 is launched with ``threads_for``'s threads, unstaged.

The inputs are those ``chip_smoke.py`` times: for K1 and K2, the fixture
replicated to 1024 windows x 1407 rows, the mixed set's 96 windows x 2812
rows and the long group of 6 windows x 20,000 rows (K2 on K1's planes);
for K1 also the first 132, 924 and 1024 windows of the fixture group (the
wave sweep); for K3 the shapes of ``chip_smoke.K3_SHAPES``; for K4 those
three groups, ``chip_smoke.ntails_group`` (256 windows x 891 rows) and the
fullest group of whole-contig windows of a seeded contig's two haplotypes
(104 windows x 20,001 rows, as ``[std scale]`` cuts them). On each input
the two versions run in the order old, new, new, old, warm (CUDA events,
median of 5 after a warm-up call) and then cold (the same, with a 64 MB
write between launches, so L2 is flushed), and their outputs must be
equal. Every call is queued behind a device sleep, so the times are the
device's work alone, without the host's launch; K4 is also timed as paid
(not queued: the wrapper's checks and launch included), and its new
planes must equal ``pack_group``'s. The script prints the card's name and
power limit and one JSON line. Run it from the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SOURCES = {"k1": "band_dp", "k2": "traceback", "k3": "tier_select",
           "k4": "npinfo"}
STD_BASES = 1_100_000      # the K4 std group's contig: two full groups
K4_THREADS = (64, 96, 128, 256)
PTXAS_WORDS = ("registers", "spill", "entry function")    # K4's threads a row, swept at two groups


def build_old(src: str, name: str):
    """The launch entry point of ``src``, built with the port's flags beside
    it and bound as kernel ``name``'s; whether it takes K2's launch plan
    (K4's ``staged``); its ptxas lines; the library."""
    from ..ops import _build
    out = os.path.splitext(os.path.abspath(src))[0] + ".so"
    cmd = [_build.nvcc()] + _build.FLAGS + ["-o", out, src]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(out)
    entry, argtypes = next(iter(_build._ARGTYPES[name].items()))
    planned = hasattr(lib, "npore_traceback_occupancy"
                      if name == "traceback" else "npore_npinfo_occupancy")
    if name == "traceback" and not planned:
        argtypes = argtypes[:13] + argtypes[-1:]     # no launch plan
    if name == "npinfo" and not planned:
        argtypes = argtypes[:15] + argtypes[-1:]     # no ``staged``
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
             if any(w in ln for w in PTXAS_WORDS)]
    return fn, planned, ptxas, lib


def launch_old_k1(fn, batch, tables, cfg):
    """The old K1 on ``batch``, with the arguments the wrapper gives the
    current one."""
    import torch
    from ..ops import dp_cuda
    from ..ops.band_dp import LW
    B, R = batch["inss"].shape[0], batch["inss"].shape[1] - 8
    A = batch["seqbuf"].shape[1]
    packed = torch.empty(B, R, LW, dtype=torch.int32, device="cuda")
    ptr = [batch[k].data_ptr() for k in dp_cuda._INT8 + dp_cuda._INT32]
    err = fn(*ptr, tables["sub"].data_ptr(), tables["cont"].data_ptr(),
             packed.data_ptr(), B, R, A, cfg.r, cfg.max_n, cfg.inf,
             cfg.indel_start, cfg.indel_extend,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old band_dp: CUDA error {err} at launch")
    return packed


def launch_old_k2(fn, planned, packed, batch, cfg, L):
    """The old K2 on K1's ``packed`` planes, with the current launch plan
    where it takes one."""
    import torch
    from ..ops import tb_cuda
    from ..ops.traceback import alloc_out
    B, R = batch["inss"].shape[0], batch["inss"].shape[1] - 8
    out = alloc_out(batch, L)
    plan = tb_cuda.launch_plan(B, R)
    args = [packed.data_ptr()] + [batch[k].data_ptr() for k in (
        "inss", "seqbuf", "refbuf", "n_ins", "n_del")] + [
        out.meta.data_ptr(), out.cig.data_ptr(), B, R,
        batch["seqbuf"].shape[1], L, cfg.r]
    if planned:
        args += [plan.tile_rows, plan.windows_per_cta]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old traceback: CUDA error {err} at launch")
    return out


def launch_old_k3(fn, x, n_steps, q, run0):
    import torch
    W, qx, lanes = x.shape
    out = torch.empty(W, lanes, dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), None if run0 is None else run0.data_ptr(),
             out.data_ptr(), W, qx, q, lanes, n_steps,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old tier_select: CUDA error {err} at launch")
    return out


def launch_k4(fn, planned, batch, cfg, threads=None, staged=False):
    """K4's entry point ``fn`` into ``batch``'s planes, at ``threads``
    (``threads_for``'s by default) and, where it takes the argument,
    ``staged``."""
    import torch
    from ..engine.windows import PLANES
    from ..ops import npinfo_cuda
    B, A = batch["seqbuf"].shape
    args = [batch["seqbuf"].data_ptr(), batch["refbuf"].data_ptr()] + [
        batch[k].data_ptr() for k in PLANES + npinfo_cuda.LENGTHS] + [
        B, A, cfg.max_n, cfg.max_l, threads or npinfo_cuda.threads_for(A)]
    if planned:
        args.append(int(staged))
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"npinfo: CUDA error {err} at launch")
    return tuple(batch[k] for k in PLANES)


def std_group(tmp: str, cfg, dev):
    """The fullest group of whole-contig windows of a seeded contig's two
    haplotypes, cut as the engine cuts them (``[std scale]``'s group at a
    smaller contig), packed on ``dev``."""
    import types
    import torch
    import chip_smoke as cs
    from ..cli import standardize_vcf as std
    from ..constants import bases_to_int
    from ..engine import cuda_engine
    from ..engine.windows import build_windows, pack_group, tensor_views
    from ..io.fasta import FastaFile
    from ..io.vcf import VcfReader, apply_vcf, split_vcf
    ref, vcf, _ = cs.write_contig(tmp, "contig1", STD_BASES, cs.STD_SCALE[1])
    pre = os.path.join(tmp, "std")
    args = std.argparser().parse_args(["--vcf", vcf, "--ref", ref,
                                       "--out_prefix", pre])
    fasta = FastaFile(ref)
    regions = std.get_vcf_regions(args, fasta, VcfReader(vcf))
    wins = []
    for hap, path in enumerate(split_vcf(vcf, regions, pre + "pre"), 1):
        for _, _, seq, rf, cig in apply_vcf(
                path, hap, regions, lambda c: fasta.fetch(c).upper(), 0):
            wins += build_windows(bases_to_int(rf), bases_to_int(seq), cig,
                                  cfg, aln_idx=hap)
    wins.sort(key=lambda w: w.b_rows)
    eng = types.SimpleNamespace(group_windows=cuda_engine.GROUP_WINDOWS)
    groups = cuda_engine.CudaEngine._groups(eng, wins)
    g = max(groups, key=lambda g: (len(g), min(w.b_rows for w in g)))
    buf, layout = pack_group(g, max(w.b_rows for w in g), cfg.max_n)
    return g, tensor_views(torch.from_numpy(buf).to(dev), layout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="k1")
    ap.add_argument("--old", required=True,
                    help="an earlier source of the kernel, outside the "
                         "package")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ..config import AlignConfig
    from ..io.bam import open_alignment_file
    from ..model.scores import calc_score_matrices, load_confusion_matrices
    from ..ops import _build, dp_cuda, tb_cuda, tier_select_cuda
    from ..ops.tables import tables_from_numpy
    print(cs.nvidia_smi(), flush=True)
    name = SOURCES[args.kernel]
    old, planned, old_ptxas, old_lib = build_old(args.old, name)
    _build.build(["band_dp", name])
    dev = torch.device("cuda")
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def ab(runs, same, paid=False):
        """old, new, new, old, warm then cold, queued (and, with ``paid``,
        warm as paid); outputs must be ``same``."""
        t = {}
        temps = (("warm", None, True), ("cold", flush, True)) + (
            (("paid", None, False),) if paid else ())
        for temp, fl, queued in temps:
            t[f"old_{temp}_ms"], t[f"new_{temp}_ms"] = [], []
            outs = {}
            for which in ("old", "new", "new", "old"):
                ms, outs[which] = cs.median_ms(runs[which], flush=fl,
                                               queued=queued)
                t[f"{which}_{temp}_ms"].append(ms)
            if not same(outs["old"], outs["new"]):
                raise AssertionError(f"old and new {args.kernel} outputs "
                                     f"differ ({temp})")
        t["equal"] = True
        return t, outs["new"]

    result = {"kernel": args.kernel, "old_ptxas": old_ptxas, "shapes": {}}
    if args.kernel == "k3":
        for i, (W, qx, lanes, q, n) in enumerate(cs.K3_SHAPES):
            x, run0 = cs.k3_input(i, dev)
            t, _ = ab({"old": lambda: launch_old_k3(old, x, n, q, run0),
                       "new": lambda: tier_select_cuda.tier_select(
                           x, n, q, run0)}, torch.equal)
            t.update(shape=[W, qx, lanes, q, n])
            result["shapes"][f"{W}x{qx}x{lanes}"] = t
            print(f"[{W}x{qx}x{lanes}] " + json.dumps(t), flush=True)
        print(json.dumps(result))
        return 0

    cfg = AlignConfig()
    if args.kernel == "k4":
        return k4_main(cfg, dev, ab, planned, old, old_ptxas, old_lib)
    sub, nps, _, _ = calc_score_matrices(*load_confusion_matrices(
        os.path.join(REPO, "guppy5_stats")))
    tables = tables_from_numpy(sub, nps, cfg, dev)
    data = os.path.join(REPO, "tests", "data")
    fixture = [r for r in open_alignment_file(os.path.join(data, "reads.bam"))
               if not (r.is_secondary or r.is_supplementary
                       or r.is_unmapped)]
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        cs.write_mixed_bam(os.path.join(tmp, "mixed.bam"))
        mixed = list(open_alignment_file(os.path.join(tmp, "mixed.bam")))
    if args.kernel == "k1":
        result.update(occupancy=dp_cuda.occupancy(cfg), sweep=[])
    for gname in ("fixture", "mixed", "long"):
        if gname == "long":
            wins, batch = cs.long_group(cfg, dev)
        else:
            its = (cs.items_of(fixture) * (cs.BATCH // 10 + 1)
                   if gname == "fixture" else cs.items_of(mixed))
            wins, batch = cs.device_group(its[:cs.BATCH], cfg, dev)
        R = batch["inss"].shape[1] - 8
        if args.kernel == "k1":
            def k1_runs(b):
                return {"old": lambda: launch_old_k1(old, b, tables, cfg),
                        "new": lambda: dp_cuda.band_dp(b, tables, cfg)}
            t, planes = ab(k1_runs(batch), torch.equal)
            t.update(B=len(wins), R=R)
            if gname != "long":
                t["bound"] = cs.k1_bound(wins, batch, tables, cfg, planes)
            if gname == "fixture":          # both kernels' wave sweeps
                for nb in cs.SWEEP:
                    part = {k: v[:nb] for k, v in batch.items()}
                    ts, _ = ab(k1_runs(part), torch.equal)
                    ts.update(B=nb, R=R)
                    result["sweep"].append(ts)
                    print("[sweep] " + json.dumps(ts), flush=True)
        else:
            packed = dp_cuda.band_dp(batch, tables, cfg)
            L = max(w.n_ins + w.n_del for w in wins)
            t, out = ab({"old": lambda: launch_old_k2(
                             old, planned, packed, batch, cfg, L),
                         "new": lambda: tb_cuda.traceback(
                             packed, batch, cfg, L)},
                        lambda a, b: torch.equal(a.buf, b.buf))
            t.update(B=len(wins), R=R, bound=cs.k2_bound(wins, out),
                     plan=tb_cuda.launch_plan(len(wins), R)._asdict())
        result["shapes"][gname] = t
        print(f"[{gname}] " + json.dumps(t), flush=True)
    print(json.dumps(result))
    return 0


def k4_main(cfg, dev, ab, planned, old, old_ptxas, old_lib) -> int:
    """K4, old against new, on the fixture, mixed, long, ntails and std
    groups."""
    import torch
    import chip_smoke as cs
    from ..engine.windows import PLANES
    from ..io.bam import open_alignment_file
    from ..ops import _build, npinfo_cuda
    result = {"kernel": "k4", "old_ptxas": old_ptxas,
              "new_ptxas": [ln.strip() for ln in _build.build_logs.get(
                  "npinfo", "").splitlines()
                  if any(w in ln for w in PTXAS_WORDS)],
              "shapes": {}}
    data = os.path.join(REPO, "tests", "data")
    fixture = [r for r in open_alignment_file(os.path.join(data, "reads.bam"))
               if not (r.is_secondary or r.is_supplementary
                       or r.is_unmapped)]
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        cs.write_mixed_bam(os.path.join(tmp, "mixed.bam"))
        mixed = list(open_alignment_file(os.path.join(tmp, "mixed.bam")))
        groups = {
            "fixture": cs.device_group((cs.items_of(fixture)
                                        * (cs.BATCH // 10 + 1))[:cs.BATCH],
                                       cfg, dev),
            "mixed": cs.device_group(cs.items_of(mixed)[:cs.BATCH], cfg,
                                     dev),
            "long": cs.long_group(cfg, dev),
            "ntails": cs.ntails_group(cfg, dev),
            "std": std_group(tmp, cfg, dev)}
    for gname, (wins, batch) in groups.items():
        B, A = batch["seqbuf"].shape
        outs = {w: dict(batch, **{k: torch.full_like(batch[k], 0x5A)
                                  for k in PLANES}) for w in ("old", "new")}

        def new():
            npinfo_cuda.fill_planes(outs["new"], cfg)
            return tuple(outs["new"][k] for k in PLANES)
        t, got = ab({"old": lambda: launch_k4(old, planned, outs["old"],
                                              cfg),
                     "new": new},
                    lambda a, b: all(map(torch.equal, a, b)), paid=True)
        if not all(torch.equal(x, batch[k]) for x, k in zip(got, PLANES)):
            raise AssertionError(f"K4's planes differ from pack_group's "
                                 f"({gname})")
        plan = npinfo_cuda.launch_plan(A, cfg.max_n)
        ctas = npinfo_cuda.occupancy(A, cfg.max_n)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        t.update(B=B, R=batch["inss"].shape[1] - 8, A=A,
                 equal_pack_group=True, plan=plan._asdict(),
                 ctas_per_sm=ctas, waves=-(-2 * B // (ctas * sms)),
                 **cs.k4_bound(batch, cfg.max_n))
        if planned:
            t["old_ctas_per_sm"] = old_lib.npore_npinfo_occupancy(
                A, cfg.max_n, npinfo_cuda.threads_for(A), 0)
        if gname in ("fixture", "ntails"):    # the new K4 at other widths
            t["threads_sweep"] = {}
            new_fn = _build.entry("npinfo")
            occ = _build.entry("npinfo", "npore_npinfo_occupancy")
            for T in K4_THREADS:
                ms, got = cs.median_ms(lambda: launch_k4(
                    new_fn, True, outs["new"], cfg, T, plan.staged),
                    queued=True)
                if not all(torch.equal(x, batch[k])
                           for x, k in zip(got, PLANES)):
                    raise AssertionError(f"K4 at {T} threads differs from "
                                         f"pack_group ({gname})")
                t["threads_sweep"][T] = {
                    "device_ms": ms,
                    "ctas_per_sm": occ(A, cfg.max_n, T, int(plan.staged))}
        result["shapes"][gname] = t
        print(f"[{gname}] " + json.dumps(t), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
