"""The plain PyTorch traceback equals the JAX package's host traceback
(npore_tpu/ops/traceback.traceback_window): the same CIGARs, and a bail
exactly where that traceback records an error."""
import numpy as np
import pytest
import torch

from npore_tpu.ops.traceback import traceback_window
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.ops import band_dp as tdp
from npore_tpu_torch.ops import tb_cuda
from npore_tpu_torch.ops.tables import tables_from_numpy
from npore_tpu_torch.ops.traceback import decode, traceback

from test_torch_dp import SETS, synthetic_cases, windows_of

torch.set_num_threads(2)

CASES = {name: (cases, cfg) for name, (cases, cfg) in SETS.items()}
CASES["synthetic"] = (synthetic_cases(), AlignConfig())


@pytest.fixture(scope="module")
def planes(score_matrices):
    """Per case set: windows, the group batch and the plain DP's packed
    planes."""
    sub_scores, np_scores, _, _ = score_matrices
    out = {}
    for name, (cases, cfg) in CASES.items():
        wins = windows_of(cases, cfg)
        R = max(w.b_rows for w in wins)
        buf, layout = tw.pack_group(wins, R, cfg.max_n)
        batch = tw.tensor_views(torch.from_numpy(buf), layout)
        tabs = tables_from_numpy(sub_scores, np_scores, cfg,
                                 torch.device("cpu"))
        packed = tdp.pack_planes(*tdp.window_dp(batch, tabs, cfg))
        out[name] = (wins, batch, packed, cfg)
    return out


def _host(wins, packed, r):
    """traceback_window on every window: (cigars, error flags)."""
    typ, run = tdp.unpack_planes(packed)
    cigs, errs = [], []
    for j, w in enumerate(wins):
        e = []
        cigs.append(traceback_window(typ[j].numpy(), run[j].numpy(),
                                     w.inss_local, w.seq, w.ref, w.n_ins,
                                     w.n_del, r, e))
        errs.append(bool(e))
    return cigs, errs


def _port(wins, batch, packed, cfg, fn=traceback):
    out = fn(packed, batch, cfg)
    ends = np.array([w.n_ins + w.n_del for w in wins])
    return decode(out.meta.numpy(), out.cig.numpy(), ends)


@pytest.mark.parametrize("name", sorted(CASES))
def test_traceback_equals_host(planes, name):
    wins, batch, packed, cfg = planes[name]
    want, errs = _host(wins, packed, cfg.r)
    got, bails = _port(wins, batch, packed, cfg)
    assert not any(errs)
    assert list(bails) == errs
    assert got == want


@pytest.mark.parametrize("corrupt", ["run0", "bad_type"])
def test_corrupted_plane_bails(planes, corrupt):
    """A cell on the path with run 0 or an unknown type: the host traceback
    records an error and the port bails on that window only."""
    wins, batch, packed, cfg = planes["synthetic"]
    packed = packed.clone()
    j = 1
    w = wins[j]
    # the first cell the traceback reads: (n_ins, n_del)
    t = w.n_ins + w.n_del
    lane = int(w.inss_local[t]) - w.n_ins + cfg.r
    if corrupt == "run0":
        packed[j, t, lane] = packed[j, t, lane] & 7
    else:
        packed[j, t, lane] = (packed[j, t, lane] & ~7) | 7
    _, errs = _host(wins, packed, cfg.r)
    _, bails = _port(wins, batch, packed, cfg)
    assert errs[j] and bails[j]
    assert list(bails) == errs


def test_midpath_corruption_bails(planes):
    """A zero-run cell deeper in the path (after some emitted runs)."""
    wins, batch, packed, cfg = planes["synthetic"]
    packed = packed.clone()
    j = 0
    w = wins[j]
    typ, run = tdp.unpack_planes(packed)
    arow, acol, steps = w.n_ins, w.n_del, 0
    while steps < 5:                       # walk five runs down the path
        t = arow + acol
        lane = int(w.inss_local[t]) - arow + cfg.r
        ty, rn = int(typ[j, t, lane]), int(run[j, t, lane])
        if ty in (tdp.INS, tdp.LEN):
            arow -= rn
        elif ty in (tdp.DEL, tdp.SHR):
            acol -= rn
        else:
            arow, acol = arow - rn, acol - rn
        steps += 1
    t = arow + acol
    lane = int(w.inss_local[t]) - arow + cfg.r
    packed[j, t, lane] = 0
    want, errs = _host(wins, packed, cfg.r)
    got, bails = _port(wins, batch, packed, cfg)
    assert errs[j] and bails[j] and not bails[1:].any()
    assert got[1:] == want[1:]


def test_tb_cuda_wrapper_on_cpu(planes):
    """On CPU tensors the kernel wrapper runs the plain traceback and
    counts no launch."""
    wins, batch, packed, cfg = planes["random"]
    before = tb_cuda.launches
    got = _port(wins, batch, packed, cfg, fn=tb_cuda.traceback)
    assert tb_cuda.launches == before
    want = _port(wins, batch, packed, cfg)
    assert got[0] == want[0] and list(got[1]) == list(want[1])
