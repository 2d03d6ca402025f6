"""Differential fuzz: the port's engine against the C++ golden aligner (the
port of ``scripts/fuzz_parity.py``).

    python -m npore_tpu_torch.scripts.fuzz_parity [n_cases] [seed] \\
        [--engine cuda|torch]

Generates mutated read/ref pairs dense in n-polymer runs (the same cases
as the JAX script for the same seed), realigns them all in one engine call
(``--engine cuda``: kernels K4, K1 and K2 on the card; ``torch``: the plain
PyTorch versions on the CPU) and requires every extended CIGAR to equal the
golden aligner's (``native.golden_align_native``, bit-exact with
``golden/align.py``). Exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..config import AlignConfig
from ..constants import bases_to_int
from ..engine.cuda_engine import CudaEngine
from ..engine.realigner import AlignItem
from ..golden.align import align as golden_align
from ..model.scores import calc_score_matrices, load_confusion_matrices
from ..native import golden_align_native

STATS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "guppy5_stats")


def make_case(rng):
    """Random ref with injected repeats + mutated read with exact CIGAR."""
    n = int(rng.integers(60, 900))
    parts = []
    while sum(len(p) for p in parts) < n:
        u = rng.random()
        if u < 0.5:      # random sequence
            k = int(rng.integers(5, 40))
            parts.append("".join("ACGT"[i] for i in rng.integers(0, 4, k)))
        else:            # n-polymer run
            period = int(rng.integers(1, 7))
            unit = "".join("ACGT"[i] for i in rng.integers(0, 4, period))
            reps = int(rng.integers(3, 30))
            parts.append(unit * reps)
    ref = "".join(parts)[:n]
    seq, cig = [], []
    p_del, p_ins, p_sub = 0.03, 0.05, 0.03
    for ch in ref:
        u = rng.random()
        if u < p_del:
            cig.append("D")
            continue
        if u < p_del + p_ins:
            ins_len = 1 + int(rng.random() < 0.3) * int(rng.integers(1, 6))
            for _ in range(ins_len):
                seq.append("ACGT"[rng.integers(0, 4)])
                cig.append("I")
        if u < p_del + p_ins + p_sub:
            alt = "ACGT"[rng.integers(0, 4)]
            seq.append(alt)
            cig.append("=" if alt == ch else "X")
        else:
            seq.append(ch)
            cig.append("=")
    return ref, "".join(seq), "".join(cig)


def run(n_cases: int = 100, seed: int = 0, engine: str = "cuda",
        stats_dir: str = STATS) -> dict:
    """Fuzz ``n_cases`` cases; returns counts, the engine's bails and the
    seconds of the engine call."""
    rng = np.random.default_rng(seed)
    sub_scores, np_scores, _, _ = calc_score_matrices(
        *load_confusion_matrices(stats_dir))
    cfg = AlignConfig()
    eng = CudaEngine(sub_scores, np_scores, cfg, plain=engine == "torch")
    cases = [make_case(rng) for _ in range(n_cases)]
    items = [AlignItem(bases_to_int(r), bases_to_int(s), c)
             for r, s, c in cases]
    t0 = time.perf_counter()
    got = eng.align_batch(items)
    secs = time.perf_counter() - t0
    print(f"{engine}: {n_cases} cases in {secs:.1f}s, "
          f"bails={eng.bail_count}", flush=True)
    bad = 0
    for i, (it, g) in enumerate(zip(items, got)):
        want = golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                                   np_scores, cfg)
        if want is None:
            want = golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                np_scores, cfg)
        if g != want:
            bad += 1
            print(f"MISMATCH case {i} (seed={seed}): ref len {len(it.ref)}")
            print(f"  got : {g[:80]}...")
            print(f"  want: {want[:80]}...")
    print(f"parity: {n_cases - bad}/{n_cases}", flush=True)
    return {"cases": n_cases, "equal": n_cases - bad, "seed": seed,
            "engine": engine, "bails": eng.bail_count, "seconds": secs,
            "windows": eng.windows, "groups": eng.groups}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_cases", nargs="?", type=int, default=100)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--engine", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--stats_dir", default=STATS)
    a = ap.parse_args(argv)
    out = run(a.n_cases, a.seed, a.engine, a.stats_dir)
    return 0 if out["equal"] == out["cases"] else 1


if __name__ == "__main__":
    sys.exit(main())
