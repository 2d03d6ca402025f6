"""Window building, batch packing and score tables of the PyTorch port
equal the JAX package's (npore_tpu/engine/windows.py, ops/band_dp.py)."""
import os

import numpy as np
import pytest
import torch

from npore_tpu.engine import windows as jw
from npore_tpu.ops.band_dp import build_cont_tables
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.io.bam import open_alignment_file
from npore_tpu_torch.io.cigar import expand_cigar
from npore_tpu_torch.ops.tables import tables_from_numpy

from test_torch_dp import jax_cfg

torch.set_num_threads(2)

CHUNKED = AlignConfig(r=10, max_b_rows=20)


def _fixture_items(data_dir):
    out = []
    for r in open_alignment_file(os.path.join(data_dir, "reads.bam")):
        cig = expand_cigar(r.cigar).replace("S", "").replace("H", "")
        out.append((bases_to_int(r.get_reference_sequence().upper()),
                    bases_to_int(r.query_alignment_sequence.upper()), cig))
    return out


def _repeat_items():
    """Homopolymer and dimer runs longer than max_l."""
    ref = "C" + "A" * 300 + "G" + "TA" * 90 + "C"
    seq = "C" + "A" * 296 + "G" + "TA" * 92 + "C"
    cig = "=" + "D" * 4 + "=" * 297 + "I" * 4 + "=" * 181
    return [(bases_to_int(ref), bases_to_int(seq), cig)]


def _windows(items, cfg, mod):
    """Windows of ``items`` from module ``mod`` (tw or jw), each given its
    own package's config."""
    if mod is jw:
        cfg = jax_cfg(cfg)
    out = []
    for i, (ref, seq, cig) in enumerate(items):
        out += mod.build_windows(ref, seq, cig, cfg, aln_idx=i)
    return out


@pytest.fixture(scope="module")
def cases(data_dir):
    fx = _fixture_items(data_dir)
    return {"fixture": (fx, AlignConfig()),
            "chunked": (fx[:3], CHUNKED),
            "repeats": (_repeat_items(), AlignConfig())}


@pytest.mark.parametrize("name", ["fixture", "chunked", "repeats"])
def test_build_windows_equal(cases, name):
    items, cfg = cases[name]
    got, want = _windows(items, cfg, tw), _windows(items, cfg, jw)
    assert len(got) == len(want) > 0
    if name == "chunked":
        assert len(got) > len(items)
    for g, w in zip(got, want):
        assert g.key == w.key
        for f in ("b_rows", "n_ins", "n_del", "ref_guard", "seq_guard"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("seq", "ref", "inss_local"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["fixture", "chunked", "repeats"])
def test_pack_batch_equal(cases, score_matrices, name):
    items, cfg = cases[name]
    _, np_scores, _, _ = score_matrices
    cont = build_cont_tables(np_scores, cfg.max_n, cfg.max_l)
    wins = _windows(items, cfg, tw)
    R = max(w.b_rows for w in wins) + 8
    got = tw.pack_batch(wins, R, cont, cfg.max_n)
    want = jw.pack_batch(_windows(items, cfg, jw), R, cont, cfg.max_n)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["fixture", "chunked", "repeats"])
def test_pack_group_matches_pack_batch(cases, score_matrices, name):
    """The engines' flat int8 group buffer holds the reference layout's
    values."""
    items, cfg = cases[name]
    _, np_scores, _, _ = score_matrices
    cont = build_cont_tables(np_scores, cfg.max_n, cfg.max_l)
    wins = _windows(items, cfg, tw)
    R = max(w.b_rows for w in wins)
    want = tw.pack_batch(wins, R, cont, cfg.max_n)
    buf, layout = tw.pack_group(wins, R, cfg.max_n)
    assert buf.nbytes == tw.group_nbytes(layout)
    got = tw.tensor_views(torch.from_numpy(buf), layout)
    for k, v in got.items():
        assert np.array_equal(v.numpy().astype(np.int64), want[k]), k
    if name == "repeats":       # runs longer than max_l: L_IDX stays <= 100
        assert want["lidx_ref"].max() == 100


def test_path_inss_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        cig = "".join(rng.choice(list("=XID"), size=int(rng.integers(1, 300))))
        assert np.array_equal(tw.path_inss(cig), jw.path_inss(cig))


def test_tables_equal_jax_cont(score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    for cfg in (AlignConfig(), AlignConfig(max_n=4, max_l=60)):
        tabs = tables_from_numpy(sub_scores, np_scores, cfg,
                                 torch.device("cpu"))
        want = build_cont_tables(np_scores, cfg.max_n, cfg.max_l)
        assert tabs["cont"].dtype == torch.float32
        assert np.array_equal(tabs["cont"].numpy(), want)
        assert np.array_equal(tabs["sub"].numpy(),
                              sub_scores.astype(np.float32).reshape(-1))
