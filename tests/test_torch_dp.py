"""The plain PyTorch DP is bit-equal (tolerance 0) to the JAX package's
make_window_dp on the same numpy-seeded pack_batch inputs."""
import dataclasses

import numpy as np
import pytest
import torch

import npore_tpu.config as jcfg
from npore_tpu.ops import band_dp as jdp
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.io.cigar import expand_cigar
from npore_tpu_torch.ops import band_dp as tdp
from npore_tpu_torch.ops import dp_cuda
from npore_tpu_torch.ops.tables import tables_from_numpy

torch.set_num_threads(2)

SMALL = AlignConfig(r=10, max_b_rows=20)


def jax_cfg(cfg: AlignConfig) -> jcfg.AlignConfig:
    """The JAX package's AlignConfig with the fields of the port's."""
    return jcfg.AlignConfig(**dataclasses.asdict(cfg))

TOYS = [
    ("CAAAGAAAGAAAG", "CAAAGAAAGAAG", "9=1D3="),
    ("CAAAGAAAGAAAG", "CAAAGAAAAGAAAG", "5=1I8="),
    ("CAAAGAAAGAAAG", "CAAAGAAAAG", "5=4D1I4="),
    ("CAAAGAAAGAAAG", "CAAGAAAG", "1=5D7="),
    ("CGAAAGAAAGAAAG", "CGAAGAAAG", "2=5D7="),
    ("CGAAAGAAAGAAAC", "CGAAGAAAC", "2=5D7="),
]
REPEATS = [
    ("CAAAAAAAAAG", "CAAAAAG", "1=4D6="),
    ("CAAAAAG", "CAAAAAAAAAAG", "1=5I6="),
    ("TATATATATATACG", "TATATATACG", "4D10="),
    ("TATATACG", "TATATATATATACG", "6I8="),
    ("ACGACGACGACGT", "ACGACGACGACGACGACGT", "6I13="),
]


def random_cases(seed=7, n_cases=12):
    """Mutated pairs with exact cigars (as tests/test_engine.py makes them)."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        n = int(rng.integers(30, 120))
        ref = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
        seq, cig = [], []
        for ch in ref:
            u = rng.random()
            if u < 0.05:
                cig.append("D")
                continue
            if u < 0.10:
                seq.append("ACGT"[rng.integers(0, 4)])
                cig.append("I")
            seq.append(ch)
            cig.append("=")
        cases.append((ref, "".join(seq), "".join(cig)))
    return cases


def synthetic_cases(seed=99, n_reads=4):
    """Nanopore-like reads at the production band (the port's copy of
    tests/generate_data.py)."""
    from npore_tpu_torch.testing.synth import make_read, make_ref
    rng = np.random.default_rng(seed)
    ref = make_ref(rng, 600)
    out = []
    for _ in range(n_reads):
        pos, seq, cig = make_read(rng, ref, min_len=100, max_len=160)
        nref = sum(c in "=XD" for c in cig)
        out.append((ref[pos:pos + nref], seq, cig))
    return out


def windows_of(cases, cfg):
    wins, owner = [], []
    for i, (ref, seq, cig) in enumerate(cases):
        ws = tw.build_windows(bases_to_int(ref), bases_to_int(seq),
                              expand_cigar(cig) if any(c.isdigit()
                                                       for c in cig) else cig,
                              cfg, aln_idx=i)
        wins += ws
    return wins


SETS = {"toys": (TOYS, SMALL), "random": (random_cases(), SMALL),
        "repeats": (REPEATS, SMALL)}


def run_both(sets, cfg, score_matrices, R):
    """Planes of the JAX DP and the torch DP for the windows of ``sets``
    in one batch; returns {set name: (jax typ, jax run, torch typ, torch
    run, windows)}."""
    import jax.numpy as jnp
    sub_scores, np_scores, _, _ = score_matrices
    cont = jdp.build_cont_tables(np_scores, cfg.max_n, cfg.max_l)
    spans, wins = {}, []
    for name, cases in sets.items():
        ws = windows_of(cases, cfg)
        spans[name] = (len(wins), len(wins) + len(ws))
        wins += ws
    batch = tw.pack_batch(wins, R, cont, cfg.max_n)
    tables = jdp.Tables(sub_flat=jnp.asarray(sub_scores.reshape(-1)),
                        cont=jnp.asarray(cont.reshape(-1)))
    jt, jr = jdp.make_window_dp(R, jax_cfg(cfg), cfg.max_n)(
        {k: jnp.asarray(v) for k, v in batch.items()}, tables)
    tt, tr = tdp.window_dp({k: torch.from_numpy(v) for k, v in batch.items()},
                           tables_from_numpy(sub_scores, np_scores, cfg,
                                             torch.device("cpu")), cfg)
    jt, jr, tt, tr = (np.asarray(jt), np.asarray(jr), tt.numpy(), tr.numpy())
    return {name: (jt[a:b], jr[a:b], tt[a:b], tr[a:b], wins[a:b])
            for name, (a, b) in spans.items()}, batch


@pytest.fixture(scope="module")
def planes_small(score_matrices):
    return run_both({k: v[0] for k, v in SETS.items()}, SMALL,
                    score_matrices, R=64)


@pytest.fixture(scope="module")
def planes_wide(score_matrices):
    return run_both({"synthetic": synthetic_cases()}, AlignConfig(),
                    score_matrices, R=400)


@pytest.mark.parametrize("name", sorted(SETS))
def test_dp_bit_equal_small_band(planes_small, name):
    jt, jr, tt, tr, wins = planes_small[0][name]
    assert len(wins) > 0
    assert tt.dtype == np.int8 and tr.dtype == np.int32
    assert np.array_equal(tt, jt)
    assert np.array_equal(tr, jr)


def test_dp_bit_equal_production_band(planes_wide):
    jt, jr, tt, tr, wins = planes_wide[0]["synthetic"]
    assert max(w.b_rows for w in wins) > 200
    assert np.array_equal(tt, jt)
    assert np.array_equal(tr, jr)


@pytest.fixture(scope="module")
def planes_n3(score_matrices):
    """Both DPs at max_n = 3 (a shallower n-polymer ring for the kernel),
    with the tables built from np_scores[:3]."""
    sub_scores, np_scores, a, b = score_matrices
    return run_both({k: v[0] for k, v in SETS.items()},
                    dataclasses.replace(SMALL, max_n=3),
                    (sub_scores, np_scores[:3], a, b), R=64)


@pytest.mark.parametrize("name", sorted(SETS))
def test_dp_bit_equal_max_n3(planes_n3, name):
    jt, jr, tt, tr, wins = planes_n3[0][name]
    assert len(wins) > 0
    assert np.array_equal(tt, jt)
    assert np.array_equal(tr, jr)


def test_dp_exercises_len_and_shr(planes_small):
    """The repeat-rich set reaches n-polymer states on the MAT plane."""
    _, _, tt, _, _ = planes_small[0]["repeats"]
    assert (tt == tdp.LEN).any() and (tt == tdp.SHR).any()


def test_dp_on_group_views_equals_reference_layout(planes_small,
                                                    score_matrices):
    """The engines' int8 group buffer gives the same planes as the int32
    reference layout."""
    sub_scores, np_scores, _, _ = score_matrices
    _, batch = planes_small
    wins = [w for v in planes_small[0].values() for w in v[4]]
    buf, layout = tw.pack_group(wins, 64, SMALL.max_n)
    tabs = tables_from_numpy(sub_scores, np_scores, SMALL,
                             torch.device("cpu"))
    got = tdp.window_dp(tw.tensor_views(torch.from_numpy(buf), layout), tabs,
                        SMALL)
    want = tdp.window_dp({k: torch.from_numpy(v) for k, v in batch.items()},
                         tabs, SMALL)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_dp_cuda_wrapper_without_cuda(planes_small, score_matrices):
    """ops/dp_cuda imports without CUDA; on CPU tensors it runs the plain
    version (no launch counted); on a non-CPU, non-CUDA device it raises."""
    sub_scores, np_scores, _, _ = score_matrices
    _, batch = planes_small
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tabs = tables_from_numpy(sub_scores, np_scores, SMALL,
                             torch.device("cpu"))
    before = dp_cuda.launches
    got = dp_cuda.band_dp(tb, tabs, SMALL)
    assert dp_cuda.launches == before
    assert torch.equal(got, tdp.pack_planes(*tdp.window_dp(tb, tabs, SMALL)))
    meta = {k: v.to("meta") for k, v in tb.items()}
    with pytest.raises(ValueError):
        dp_cuda.band_dp(meta, tabs, SMALL)


def test_dp_cuda_occupancy_needs_max_n_in_ring():
    """The kernel keeps 8 rows of state, so max_n past 7 is refused before
    any build."""
    with pytest.raises(ValueError):
        dp_cuda.occupancy(AlignConfig(max_n=8))


def test_band_must_fit_lanes():
    with pytest.raises(ValueError):
        tdp.check_band(AlignConfig(r=32))
