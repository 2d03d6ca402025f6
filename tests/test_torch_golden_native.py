"""The port's C++ golden aligner (``native.golden_align_native``) against
its Python spec (``golden/align.py``) when ``max_l`` is not the width the
score tables were counted at: the shipped tables are (6, 101, 101), and the
C++ code reads them with a row stride of ``max_l + 1``, so the wrapper cuts
them first. Tolerance: exact (equal CIGAR strings)."""
import numpy as np
import pytest

from npore_tpu_torch import native
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.golden.align import align
from npore_tpu_torch.model.scores import (calc_score_matrices,
                                          load_confusion_matrices)
from npore_tpu_torch.scripts.fuzz_parity import make_case

CASES = 6           # seeded fuzz cases a max_l


@pytest.fixture(scope="module")
def tables(stats_dir):
    sub, nps, _, _ = calc_score_matrices(*load_confusion_matrices(stats_dir))
    return sub, nps


@pytest.mark.parametrize("max_l", [12, 30, 60, 100])
def test_golden_align_native_equals_spec_at_max_l(tables, max_l):
    sub, nps = tables
    assert nps.shape[1:] == (101, 101)
    cfg = AlignConfig(max_l=max_l)
    rng = np.random.default_rng(5)
    for _ in range(CASES):
        ref, seq, cig = make_case(rng)
        ref, seq = bases_to_int(ref), bases_to_int(seq)
        got = native.golden_align_native(ref, seq, cig, sub, nps, cfg)
        assert got is not None and got == align(ref, seq, cig, sub, nps, cfg)


def test_golden_align_native_rejects_a_narrow_table(tables):
    sub, nps = tables
    ref, seq, cig = make_case(np.random.default_rng(5))
    with pytest.raises(ValueError, match="narrower"):
        native.golden_align_native(bases_to_int(ref), bases_to_int(seq), cig,
                                   sub, nps[:, :50, :50],
                                   AlignConfig(max_l=60))
