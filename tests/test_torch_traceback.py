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
from npore_tpu_torch.ops.traceback import MAT, decode, traceback
from npore_tpu_torch.testing.planes import path_group, random_cigar

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


# --- planes written along a chosen CIGAR (npore_tpu_torch/testing/planes.py)

RUN_LENS = (31, 32, 33, 64, 100)
# each run sits between ops of another kind, so it stays one run
AROUND = {"I": ("=X=", "=X="), "D": ("=X=", "=X="), "M": ("==I", "D==")}


def _jax_path(w, packed_w, r):
    """traceback_window over one window's (R, 64) planes: (cigar, error)."""
    pk = packed_w.numpy()
    e = []
    cig = traceback_window(pk & 7, pk >> 3, w.inss_local, w.seq, w.ref,
                           w.n_ins, w.n_del, r, e)
    return cig, bool(e)


def _plain_path(wins, batch, packed):
    out = traceback(packed, batch, AlignConfig())
    ends = np.array([w.n_ins + w.n_del for w in wins])
    cigs, bails = decode(out.meta.numpy(), out.cig.numpy(), ends)
    return cigs, list(bails)


@pytest.mark.parametrize("op,n", [(op, n) for op in "IDM" for n in RUN_LENS])
def test_path_run_equals_jax(op, n):
    """One I, D or MAT run of n ops (MAT mixing '=' and 'X'): the plain
    traceback and traceback_window both walk the chosen CIGAR back."""
    rng = np.random.default_rng(n)
    body = op * n if op != "M" else "".join(
        rng.choice(["=", "X"], n, p=[0.8, 0.2]))
    pre, post = AROUND[op]
    cigar = pre + body + post
    wins, batch, packed = path_group([cigar], seed=n)
    assert (n,) == tuple(c[3] for c in wins[0].cells
                         if c[3] == n and (op != "M" or c[2] == 0))
    got, bails = _plain_path(wins, batch, packed)
    want, err = _jax_path(wins[0], packed[0], 30)
    assert got == [want] == [cigar]
    assert bails == [err] == [False]


def test_path_long_window_equals_jax():
    """A window of more than 4,000 rows with nanopore-like error rates."""
    cigar = random_cigar(np.random.default_rng(4), 2200)
    wins, batch, packed = path_group([cigar], seed=4)
    assert packed.shape[1] >= 4000
    got, bails = _plain_path(wins, batch, packed)
    want, err = _jax_path(wins[0], packed[0], 30)
    assert got == [want] == [cigar]
    assert bails == [err] == [False]


@pytest.mark.parametrize("edge", ["overshoot", "row_first"])
def test_path_mat_run_past_an_edge(edge):
    """A MAT run longer than the rows and columns left. Past (0, 0) it
    stops there without a bail; reaching row 0 with columns left, it bails
    and keeps the bytes it emitted. traceback_window slices the bases with
    Python's wrapping slices, so it reads the run clipped to the edge; past
    row 0 it then meets the next cell, zeroed here, and records an error at
    the same bytes."""
    cigar = ("" if edge == "overshoot" else "DDD") + "==X==I" + "=XIID=" * 9
    wins, batch, packed = path_group([cigar], seed=1)
    w = wins[0]
    mat = -1 if edge == "overshoot" else -2       # the first MAT run's cell
    t, lane, typ, n = w.cells[mat]
    assert (typ, n) == (MAT, 5)
    clipped = packed.clone()
    packed[0, t, lane] = MAT | (n + 4) << 3
    if edge == "row_first":
        t_d, lane_d, _, _ = w.cells[-1]            # the DDD before it
        packed[0, t_d, lane_d] = clipped[0, t_d, lane_d] = 0
    got, bails = _plain_path(wins, batch, packed)
    want, err = _jax_path(w, clipped[0], 30)
    assert got == [want]
    assert bails == [err] == [edge == "row_first"]
    assert want == (cigar if edge == "overshoot" else cigar[3:])


@pytest.mark.parametrize("R", [1, 64, 1407, 2812, 20000])
@pytest.mark.parametrize("B", [1, 33, 1024])
def test_tb_launch_plan(B, R):
    """K2's launch plan: the CTA's rings fit the shared memory, a group of
    up to 1,056 windows is one CTA an SM, and a window's tiles cover its
    rows [0, R) exactly, each at most a tile."""
    plan = tb_cuda.launch_plan(B, R)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.smem_bytes == plan.windows_per_cta * plan.stages * (
        plan.tile_rows * (tdp.LW * 4 + 4) + 8)
    assert (plan.ctas - 1) * plan.windows_per_cta < B \
        <= plan.ctas * plan.windows_per_cta
    assert plan.ctas <= tb_cuda.SMS
    assert plan.tile_rows % 8 == 0
    tiles = tb_cuda.tiles(R, plan.tile_rows)
    assert [row for lo, hi in reversed(tiles) for row in range(lo, hi)] \
        == list(range(R))
    assert all(0 < hi - lo <= plan.tile_rows for lo, hi in tiles)
