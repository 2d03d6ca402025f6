"""The reference against the port's plain engine and normaliser, and the
control: the reference in bfloat16 in the program's place fails the
comparison."""
import json

import numpy as np
import pytest
import torch

from benchmark.reference import cigar as rc
from benchmark.reference import dp, realign as rr, scores
from benchmark.traffic import genome_bam

from .conftest import TINY

STATS = "benchmark/configs/guppy5_stats"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    layout = json.load(open("benchmark/traffic/wgs_bam.json"))["layout"]
    d = str(tmp_path_factory.mktemp("tiny"))
    paths = genome_bam.write(d, genome_bam.make(
        5, genome_bam.Layout.from_json({**layout, **TINY})))
    return paths, rr.read_expected(paths["expected"]), \
        rr.read_fasta(paths["fasta"])


def test_scores_equal_the_ports():
    from npore_tpu_torch.model.scores import (calc_score_matrices,
                                              load_confusion_matrices)
    from npore_tpu_torch.ops.tables import build_cont_tables
    s, n, i, d = load_confusion_matrices(STATS)
    sub, nps, _, _ = calc_score_matrices(s, n, i, d, 6, 100)
    sub2, nps2 = scores.score_matrices(s, n)
    assert np.array_equal(sub, sub2) and np.array_equal(nps, nps2)
    assert np.array_equal(build_cont_tables(nps), scores.cont_tables(nps2))


@pytest.mark.parametrize("max_b_rows", [20000, 700])
def test_reference_equals_the_ports_plain_engine(tiny, max_b_rows):
    from npore_tpu_torch.config import AlignConfig
    from npore_tpu_torch.engine.cuda_engine import CudaEngine
    from npore_tpu_torch.engine.realigner import AlignItem
    from npore_tpu_torch.io.cigar import finalize_cigar
    _, expected, genome = tiny
    rows = expected[:6]
    p = dp.AlignParams(max_b_rows=max_b_rows)
    mine = rr.realign(rows, genome, STATS, p, "cpu")
    s, n, i, d = scores.load_counts(STATS)
    sub, nps = scores.score_matrices(s, n)
    eng = CudaEngine(sub, nps, AlignConfig(max_b_rows=max_b_rows),
                     device=torch.device("cpu"), plain=True)
    items = [AlignItem(rr.bases(genome[e["rname"]][
        e["pos"]:e["pos"] + rr.ref_span(e["cigar"])]), rr.bases(e["seq"]),
        e["cigar"]) for e in rows]
    port = [finalize_cigar(c, it.ref, it.seq)
            for c, it in zip(eng.align_batch(items), items)]
    assert eng.bail_count == 0
    assert mine == port


def test_normalise_equals_the_ports_python_loops():
    from npore_tpu_torch.io import cigar as pc
    rng = np.random.default_rng(3)
    for _ in range(500):
        ext = "".join(rng.choice(list("=XID"), int(rng.integers(1, 50)),
                                 p=[.4, .1, .25, .25]))
        k = int(rng.integers(1, 4))
        ref = rng.integers(1, 1 + k, sum(o in "=XD" for o in ext)
                           ).astype(np.uint8)
        seq = rng.integers(1, 1 + k, sum(o in "=XI" for o in ext)
                           ).astype(np.uint8)
        c = pc._EXT2MID_LUT[np.frombuffer(ext.encode(), np.uint8)].copy()
        while True:
            old = c.copy()
            c = pc.push_inss_thru_dels(pc.push_indels_left(c, ref, 2))
            c = pc.push_inss_thru_dels(pc.push_indels_left(c, seq, 1))
            if np.array_equal(old, c):
                break
        assert np.array_equal(rc.normalize(ext, ref, seq), c), ext


def test_control_bfloat16_fails_the_comparison(tiny):
    """The reference computed a precision lower than the configuration's
    float32, put in the program's place, gives CIGARs that the comparison
    counts as wrong; the float32 reference in its place passes."""
    paths, expected, genome = tiny
    p = dp.AlignParams()
    assert rr.control(paths, STATS, p, "cpu")["cigars_differing"] > 0
    assert not any(rr.control(paths, STATS, p, "cpu",
                              torch.float32).values())


def test_batched_npinfo_equals_the_host_scan():
    from benchmark.reference import npinfo
    rng = np.random.default_rng(9)
    rows, lens = [], []
    for _ in range(40):
        k = int(rng.integers(1, 5))
        n = int(rng.integers(5, 300))
        unit = rng.integers(0, 5, k)
        s = np.where(rng.random(n) < 0.7, np.resize(unit, n),
                     rng.integers(0, 5, n)).astype(np.uint8)
        rows.append(s)
        lens.append(n)
    P = max(lens) + 8
    buf = np.zeros((len(rows), P), np.uint8)
    for i, s in enumerate(rows):
        buf[i, :len(s)] = s
    L, Li = npinfo.np_info_rows(torch.from_numpy(buf), torch.tensor(lens))
    for i, s in enumerate(rows):
        want = npinfo.np_info(s)
        assert np.array_equal(L[i, :, :len(s)].numpy().T, want[:, 0])
        assert np.array_equal(Li[i, :, :len(s)].numpy().T, want[:, 1])
        assert not L[i, :, len(s):].any()
