"""Engine-level bench: windows -> extended CIGARs, steady state (the port of
``scripts/bench_engine.py``).

    python -m npore_tpu_torch.scripts.bench_engine [replicas] \\
        [--engine cuda|torch] [--passes 3]

Times ``CudaEngine.align_batch`` alone on the reads of
``tests/data/reads.bam`` replicated ``replicas`` times (256 by default), in
one call a pass, after a warm-up call: the engine's host work (windows,
group fill), the device scan, DP and traceback, and the CIGAR decode,
without the BAM decode and the SAM emit that the realign CLI adds. Prints
the best and median reads/s of ``--passes`` passes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..constants import bases_to_int
from ..engine.cuda_engine import CudaEngine
from ..engine.realigner import AlignItem
from ..io.bam import open_alignment_file
from ..io.cigar import expand_cigar
from ..model.scores import calc_score_matrices, load_confusion_matrices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fixture_items(bam: str):
    items = []
    for r in open_alignment_file(bam):
        if r.is_secondary or r.is_supplementary or r.is_unmapped:
            continue
        cig = expand_cigar(r.cigar).replace("S", "").replace("H", "")
        items.append(AlignItem(
            bases_to_int(r.get_reference_sequence().upper()),
            bases_to_int(r.query_alignment_sequence.upper()), cig))
    return items


def run(replicas: int = 256, engine: str = "cuda", passes: int = 3,
        repo: str = REPO) -> dict:
    sub_scores, np_scores, _, _ = calc_score_matrices(
        *load_confusion_matrices(os.path.join(repo, "guppy5_stats")))
    items = fixture_items(os.path.join(repo, "tests", "data", "reads.bam"))
    eng = CudaEngine(sub_scores, np_scores, plain=engine == "torch")
    work = items * replicas
    eng.align_batch(items)              # warm-up: context, build, pools
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        out = eng.align_batch(work)
        rates.append(len(work) / (time.perf_counter() - t0))
        if len(out) != len(work):
            raise AssertionError(f"{len(out)} CIGARs for {len(work)} reads")
    rates.sort()
    return {"reads": len(work), "engine": engine, "passes": passes,
            "best": rates[-1], "median": rates[len(rates) // 2],
            "bails": eng.bail_count}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("replicas", nargs="?", type=int, default=256)
    ap.add_argument("--engine", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--passes", type=int, default=3)
    a = ap.parse_args(argv)
    out = run(a.replicas, a.engine, a.passes)
    print(f"engine-level: {out['best']:.0f} reads/s (median "
          f"{out['median']:.0f}; {out['reads']} reads, {a.engine}, "
          f"bails={out['bails']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
