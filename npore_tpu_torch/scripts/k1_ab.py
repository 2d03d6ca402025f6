"""Time kernel K1 against an earlier version of its source, in turns, on
one CUDA card.

    git show <commit>:npore_tpu_torch/csrc/band_dp.cu > chip_proof/band_dp_old.cu
    python -m npore_tpu_torch.scripts.k1_ab --old chip_proof/band_dp_old.cu

The old source is compiled with the port's nvcc flags into the directory
that holds it and loaded on its own; it must export ``npore_band_dp`` with
the current signature. The script builds the two groups ``chip_smoke.py``
times (the fixture replicated to 1024 windows x 1407 rows, and the mixed
set's 96 windows x 2812 rows) and the first 132, 924 and 1024 windows of
the former (the wave sweep), times the kernels in the order old, new, new,
old on each (CUDA events, median of 5 after a warm-up call), requires
their planes to be equal, and prints the card's name and power limit and
one JSON line. Run it from the repository root.
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


def build_old(src: str):
    """The ``npore_band_dp`` entry point of ``src``, built with the port's
    flags beside it."""
    from ..ops import _build
    out = os.path.splitext(os.path.abspath(src))[0] + ".so"
    cmd = [_build.nvcc()] + _build.FLAGS + ["-o", out, src]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    fn = ctypes.CDLL(out).npore_band_dp
    fn.argtypes = _build._ARGTYPES["band_dp"]["npore_band_dp"]
    fn.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in (p.stdout + p.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def launch_old(fn, batch, tables, cfg):
    """The old kernel on ``batch``, with the arguments the wrapper gives
    the current one."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/band_dp.cu, outside the package")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ..config import AlignConfig
    from ..io.bam import open_alignment_file
    from ..model.scores import calc_score_matrices, load_confusion_matrices
    from ..ops import _build, dp_cuda
    from ..ops.tables import tables_from_numpy
    print(cs.nvidia_smi(), flush=True)
    old, old_ptxas = build_old(args.old)
    _build.build(["band_dp"])
    dev = torch.device("cuda")
    cfg = AlignConfig()
    sub, nps, _, _ = calc_score_matrices(*load_confusion_matrices(
        os.path.join(REPO, "guppy5_stats")))
    tables = tables_from_numpy(sub, nps, cfg, dev)
    data = os.path.join(REPO, "tests", "data")
    fixture = [r for r in open_alignment_file(os.path.join(data, "reads.bam"))
               if not (r.is_secondary or r.is_supplementary
                       or r.is_unmapped)]
    with tempfile.TemporaryDirectory(prefix="k1_ab_") as tmp:
        cs.write_mixed_bam(os.path.join(tmp, "mixed.bam"))
        mixed = list(open_alignment_file(os.path.join(tmp, "mixed.bam")))
    groups = {"fixture": cs.items_of(fixture) * (cs.BATCH // 10 + 1),
              "mixed": cs.items_of(mixed)}

    def ab(batch):
        """old, new, new, old on ``batch``; the planes must be equal."""
        runs = {"old": lambda: launch_old(old, batch, tables, cfg),
                "new": lambda: dp_cuda.band_dp(batch, tables, cfg)}
        t, outs = {"old_ms": [], "new_ms": []}, {}
        for which in ("old", "new", "new", "old"):
            ms, outs[which] = cs.median_ms(runs[which])
            t[which + "_ms"].append(ms)
        t["equal"] = torch.equal(outs["old"], outs["new"])
        if not t["equal"]:
            raise AssertionError("old and new K1 planes differ")
        return t, outs["new"]

    result = {"old_ptxas": old_ptxas,
              "occupancy": dp_cuda.occupancy(cfg), "shapes": {}, "sweep": []}
    for name, its in groups.items():
        wins, batch = cs.device_group(its[:cs.BATCH], cfg, dev)
        R = batch["inss"].shape[1] - 8
        t, planes = ab(batch)
        t.update(B=len(wins), R=R,
                 bound=cs.k1_bound(wins, batch, tables, cfg, planes))
        result["shapes"][name] = t
        print(f"[{name}] " + json.dumps(t), flush=True)
        if name == "fixture":              # both kernels' wave sweeps
            for nb in cs.SWEEP:
                t, _ = ab({k: v[:nb] for k, v in batch.items()})
                t.update(B=nb, R=R)
                result["sweep"].append(t)
                print("[sweep] " + json.dumps(t), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
