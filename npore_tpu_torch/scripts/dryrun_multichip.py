"""Multi-device dry run: the sharded DP step and the engine over n devices.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:

1. ``parallel.mesh.make_sharded_step`` over an n-device mesh runs one step
   on 2n seeded windows (K1 on each card shard, the plain DP on each CPU
   shard): every shard's planes come back, and the op histogram is above
   zero;
2. ``CudaEngine`` over the same devices (K1 and K2, or the plain versions
   on the CPU) realigns 2n seeded items one window a group, so the groups
   go round-robin over every device, and each CIGAR must equal the golden
   aligner's.

Usage:
    python -m npore_tpu_torch.scripts.dryrun_multichip [--device cpu|cuda] \\
        [--n 2]

On ``cuda`` the mesh holds ``cuda:(i mod device_count)`` for i < n, so two
shards share a card on a one-card machine.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..config import AlignConfig
from ..constants import bases_to_int
from ..engine.cuda_engine import CudaEngine
from ..engine.realigner import AlignItem
from ..engine.windows import build_windows, pack_group, tensor_views
from ..golden.align import align as golden_align
from ..model.scores import calc_score_matrices, load_confusion_matrices
from ..ops.tables import tables_from_numpy
from ..parallel.mesh import make_data_mesh, make_sharded_step, shard_batch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
R_MAX = 256


def example_batch(nwin: int, cfg: AlignConfig):
    """``nwin`` windows of seeded 100-base pairs (a substitution every 17
    bases), packed as one group of R_MAX rows (the JAX dry run's input, in
    the engine's int8 layout)."""
    rng = np.random.default_rng(0)
    wins, i = [], 0
    while len(wins) < nwin:
        ref = rng.integers(1, 5, 100).astype(np.int8)
        seq = ref.copy()
        seq[::17] = (seq[::17] % 4) + 1
        wins.extend(build_windows(ref, seq, "M" * 100, cfg, aln_idx=i))
        i += 1
    buf, layout = pack_group(wins[:nwin], R_MAX, cfg.max_n)
    return tensor_views(torch.from_numpy(buf), layout)


def example_items(n: int):
    """``n`` seeded 97-base pairs with a 7-base A run and a substitution
    every 19 bases (the JAX dry run's engine input)."""
    rng = np.random.default_rng(3)
    items = []
    for _ in range(n):
        ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 90))
        ref = ref[:40] + "AAAAAAA" + ref[40:]
        seq = list(ref)
        seq[::19] = ["ACGT"[int(i)] for i in rng.integers(0, 4,
                                                          len(seq[::19]))]
        items.append(AlignItem(bases_to_int(ref),
                               bases_to_int("".join(seq)), "M" * len(ref)))
    return items


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--n", type=int, default=2, help="devices of the mesh")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card")
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(args.n)]
    else:
        devices = [torch.device("cpu")] * args.n
    cfg = AlignConfig()
    sub_scores, np_scores, _, _ = calc_score_matrices(
        *load_confusion_matrices(os.path.join(REPO, "guppy5_stats")))

    mesh = make_data_mesh(devices)
    step = make_sharded_step(mesh, cfg)
    tables = tables_from_numpy(sub_scores, np_scores, cfg, devices[0])
    planes, counts = step(shard_batch(example_batch(2 * args.n, cfg), mesh),
                          tables)
    if [tuple(p.shape) for p in planes] != [(2, R_MAX, 64)] * args.n:
        raise AssertionError(f"shard planes {[p.shape for p in planes]}")
    if int(counts.sum()) <= 0:
        raise AssertionError("the sharded step counted no ops")
    print(f"dryrun_multichip({args.n}, {args.device}): sharded step ok, "
          f"op counts {counts.tolist()}", flush=True)

    items = example_items(2 * args.n)
    eng = CudaEngine(sub_scores, np_scores, cfg, plain=args.device == "cpu",
                     devices=devices)
    eng.group_windows = 1               # one group a window: every device
    got = eng.align_batch(items)
    for it, g in zip(items, got):
        if g != golden_align(it.ref, it.seq, it.cigar, sub_scores,
                             np_scores, cfg):
            raise AssertionError("engine over the mesh differs from golden")
    print(f"dryrun_multichip({args.n}, {args.device}): engine over "
          f"{len(devices)} devices, {eng.groups} groups, golden-exact",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
