"""Realigner(engine="torch") -- the plain PyTorch DP and traceback through
the port's engine -- reproduces the golden spec, and the JAX package's
Pallas engine (kernels in interpret mode, as its own tests run them)."""
import numpy as np
import pytest
import torch

from npore_tpu.golden.align import align as jax_golden_align
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine.realigner import AlignItem, Realigner
from npore_tpu_torch.engine.windows import build_windows
from npore_tpu_torch.io.cigar import expand_cigar

from test_torch_dp import (REPEATS, SMALL, TOYS, jax_cfg, random_cases,
                           synthetic_cases)

torch.set_num_threads(2)

PALLAS_TOYS = TOYS + REPEATS


def golden_align(ref, seq, cigar, sub_scores, np_scores, cfg):
    """The JAX package's golden spec under the port's config's values."""
    return jax_golden_align(ref, seq, cigar, sub_scores, np_scores,
                            jax_cfg(cfg))


def _items(cases):
    return [AlignItem(bases_to_int(r), bases_to_int(s),
                      expand_cigar(c) if any(ch.isdigit() for ch in c)
                      else c) for r, s, c in cases]


def long_indel_cases():
    """I/D runs far beyond 3 (tests/test_pallas_engine.py:53-70)."""
    rng = np.random.default_rng(5)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    cases = []
    for ln in (7, 40, 97, 150):
        ins = "".join("ACGT"[i] for i in rng.integers(0, 4, ln))
        cases.append((base[:120] + ins + base[120:], base, f"120={ln}D180="))
        cases.append((base, base[:120] + ins + base[120:], f"120={ln}I180="))
    return cases


def chunked_cases():
    """Alignments split into several windows at max_b_rows=500, one with a
    homopolymer straddling a chunk break
    (tests/test_pallas_engine.py:163-209)."""
    rng = np.random.default_rng(13)
    n = 600
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    seq, cig = [], []
    for ch in ref:
        u = rng.random()
        if u < 0.04:
            cig.append("D")
            continue
        if u < 0.08:
            seq.append("ACGT"[rng.integers(0, 4)])
            cig.append("I")
        seq.append(ch)
        cig.append("=")
    ref2 = list("".join("ACGT"[i] for i in rng.integers(0, 4, n)))
    ref2[235:265] = "A" * 30
    ref2 = "".join(ref2)
    seq2 = ref2[:240] + ref2[244:]
    cig2 = "=" * 240 + "D" * 4 + "=" * (n - 244)
    return [(ref, "".join(seq), "".join(cig)), (ref2, seq2, cig2)]


ENGINE_SETS = {
    "toys": (TOYS, SMALL),
    "random": (random_cases(), SMALL),
    "repeats": (REPEATS, SMALL),
    "chunked": (chunked_cases(), AlignConfig(max_b_rows=500)),
    "synthetic": (synthetic_cases(seed=3, n_reads=6), AlignConfig()),
}


@pytest.mark.parametrize("name", sorted(ENGINE_SETS))
def test_torch_engine_matches_golden(score_matrices, name):
    sub_scores, np_scores, _, _ = score_matrices
    cases, cfg = ENGINE_SETS[name]
    items = _items(cases)
    if name == "chunked":
        assert all(len(build_windows(it.ref, it.seq, it.cigar, cfg)) >= 2
                   for it in items)
    eng = Realigner(sub_scores, np_scores, cfg, engine="torch")
    got = eng.align_batch(items)
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)
    assert eng.bail_count == 0


def test_torch_engine_small_groups(score_matrices):
    """Windows split over many groups (sorted by rows) reassemble in
    alignment order."""
    sub_scores, np_scores, _, _ = score_matrices
    items = _items(random_cases(seed=11))
    eng = Realigner(sub_scores, np_scores, SMALL, engine="torch")
    eng._engine.group_windows = 3
    got = eng.align_batch(items)
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, SMALL)


@pytest.mark.parametrize("limit", [1, 2])
def test_groups_in_flight_are_bounded(score_matrices, monkeypatch, limit):
    """A call with more groups than GROUPS_IN_FLIGHT collects its oldest
    group before it submits the next: the CIGARs equal an unbounded run's,
    and no more than ``limit`` groups are ever submitted and uncollected."""
    from npore_tpu_torch.engine import cuda_engine
    sub_scores, np_scores, _, _ = score_matrices
    items = _items(random_cases(seed=11))

    def run(groups_in_flight):
        monkeypatch.setattr(cuda_engine, "GROUPS_IN_FLIGHT",
                            groups_in_flight)
        eng = cuda_engine.CudaEngine(sub_scores, np_scores, SMALL,
                                     plain=True)
        eng.group_windows = 3
        held = [0, 0]                            # now, most
        submit, collect = eng._submit, eng._collect

        def counted_submit(group):
            held[0] += 1
            held[1] = max(held)
            return submit(group)

        def counted_collect(group, handle):
            held[0] -= 1
            return collect(group, handle)
        eng._submit, eng._collect = counted_submit, counted_collect
        cigars = eng.align_batch_async(items)()
        assert held[0] == 0
        return cigars, held[1], eng.groups

    want, most, groups = run(10 ** 6)
    assert groups > limit + 2 and most == groups
    got, most, _ = run(limit)
    assert most == limit
    assert got == want


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_engine_rejects_max_l_past_tables(score_matrices, engine):
    """n-polymer lengths past the tables' 101 rows would wrap the int8
    L/L_IDX planes: the engine refuses them before touching a device."""
    sub_scores, np_scores, _, _ = score_matrices
    with pytest.raises(ValueError, match="max_l"):
        Realigner(sub_scores, np_scores, AlignConfig(max_l=128),
                  engine=engine)


def test_realigner_auto_engine_is_cuda(score_matrices, monkeypatch):
    """RealignConfig's default engine, "auto", runs the CUDA engine, the
    realign CLI's default (the JAX Realigner maps it to its device engine).
    The engine is replaced by a stand-in that records how it was built, so
    building needs no card."""
    from npore_tpu_torch.config import RealignConfig
    from npore_tpu_torch.engine import cuda_engine
    sub_scores, np_scores, _, _ = score_matrices
    built = []
    monkeypatch.setattr(cuda_engine, "CudaEngine",
                        lambda *a, **k: built.append(k) or object())
    assert RealignConfig().engine == "auto"
    rl = Realigner(sub_scores, np_scores, engine=RealignConfig().engine)
    assert rl.engine == "cuda"
    assert built == [{"device": None, "plain": False}]


@pytest.fixture(scope="module")
def pallas_engine(score_matrices):
    from npore_tpu.engine.pallas_engine import PallasEngine
    sub_scores, np_scores, _, _ = score_matrices
    return PallasEngine(sub_scores, np_scores, jax_cfg(AlignConfig()),
                        interpret=True)


@pytest.mark.parametrize("name", ["toys", "long_indels"])
def test_torch_engine_matches_pallas(score_matrices, pallas_engine, name):
    sub_scores, np_scores, _, _ = score_matrices
    cases = PALLAS_TOYS if name == "toys" else long_indel_cases()
    items = _items(cases)
    want = pallas_engine.align_batch(items)
    eng = Realigner(sub_scores, np_scores, AlignConfig(), engine="torch")
    assert eng.align_batch(items) == want
