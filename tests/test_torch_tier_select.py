"""The k-select of the two-tier probe (kernel K3): the port's plain version
equals the probe's numpy reference bit for bit, and the probe's Pallas
kernel (interpret mode) equals that same reference, so the port is held to
the TPU kernel. The CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda_kernels.py)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from npore_tpu_torch.ops import tier_select_cuda
from npore_tpu_torch.ops.tier_select import tier_select_plain
from npore_tpu_torch.scripts import probe_cond

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (W, Qx, LANES, Q, N): the probe's shape; ragged lanes with Qx > Q and a
# wrapping (k - 1) % Q; and five warps a row whose tier votes differ
SHAPES = {"probe": (32, 16, 128, 16, 256), "ragged": (7, 20, 96, 10, 300),
          "split": (4, 16, 160, 12, 100)}


def numpy_reference(x, n_steps, q, run0=None):
    """scripts/probe_cond.py:67-75, for any shape and start counts."""
    W, _, lanes = x.shape
    acc = np.zeros((W, lanes), np.float32)
    run = np.zeros((W, lanes), np.int64) if run0 is None else \
        run0.astype(np.int64)
    for i in range(n_steps):
        k_c = (run % 23) + (i % 7)
        cv = np.full((W, lanes), 1e9, np.float32)
        for kk in range(1, 13):
            cv = np.where(k_c == kk, x[:, (kk - 1) % q, :], cv)
        acc += np.where(cv < 1e9, cv, 0.0)
        run += 1
    return acc


def make_input(name, seed=0):
    """The probe's arange % 97 input, or seeded values (one at the
    sentinel) with start counts that mix both tiers in a row; in "split"
    the first warp of each row starts at 0, so in its first steps it takes
    the low tier while the other warps of the row take the full one."""
    W, qx, lanes, q, n = SHAPES[name]
    if name == "probe":
        x = (np.arange(W * qx * lanes, dtype=np.float32)
             .reshape(W, qx, lanes) % 97)
        return x, None
    rng = np.random.default_rng(seed)
    x = (rng.random((W, qx, lanes), dtype=np.float32) * 200 - 50)
    x[0, 0, 0] = 2e9
    run0 = rng.integers(-50, 50, (W, lanes)).astype(np.int32)
    if name == "split":
        run0[:, :tier_select_cuda.WARP] = 0
    return x, run0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_equals_probe_numpy_reference(name):
    x, run0 = make_input(name)
    _, _, _, q, n = SHAPES[name]
    want = numpy_reference(x, n, q, run0)
    got = tier_select_plain(torch.from_numpy(x), n, q,
                            None if run0 is None else torch.from_numpy(run0))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    if run0 is None:        # the probe's own call: zeros as start counts
        assert np.array_equal(numpy_reference(x, n, q, np.zeros_like(
            want, dtype=np.int32)), want)


def test_probe_pallas_interpret_matches_reference(capsys):
    """The TPU kernel, run by the probe's own entry point in interpret mode,
    equals the numpy reference (it asserts so) on the probe's input, which
    the plain version matches bit for bit above."""
    spec = importlib.util.spec_from_file_location(
        "probe_cond_jax", os.path.join(REPO, "scripts", "probe_cond.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(interpret=True)
    assert "ok=True" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_wrapper_on_cpu_runs_plain(name):
    x, run0 = make_input(name, seed=1)
    _, _, _, q, n = SHAPES[name]
    xt = torch.from_numpy(x)
    r0 = None if run0 is None else torch.from_numpy(run0)
    before = tier_select_cuda.launches
    got = tier_select_cuda.tier_select(xt, n, q, r0)
    assert tier_select_cuda.launches == before
    assert torch.equal(got, tier_select_plain(xt, n, q, r0))


def test_wrapper_rejects_other_devices():
    x = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tier_select_cuda.tier_select(x, 4, 4)


def test_probe_entry_point_on_cpu(capsys):
    assert probe_cond.main(device="cpu") is True
    assert "ok=True" in capsys.readouterr().out
    x = probe_cond.probe_input("cpu")
    want, _ = make_input("probe")
    assert np.array_equal(x.numpy(), want)


def warp_vote_reference(x, n_steps, q, run0=None):
    """numpy model of the CUDA kernel's tier choice: the (W, LANES)
    elements in row-major order, each WARP of them voting once a step
    whether any has k in 5..12, and taking ladder<12> if so, else the
    4-rung ladder. Also returns, per step, whether the warps of one row
    voted differently."""
    W, _, lanes = x.shape
    warp = (np.arange(W * lanes) // tier_select_cuda.WARP).reshape(W, lanes)
    acc = np.zeros((W, lanes), np.float32)
    run = np.zeros((W, lanes), np.int64) if run0 is None else \
        run0.astype(np.int64)
    split = []
    for i in range(n_steps):
        k = (run % 23) + (i % 7)
        vote = np.zeros(warp.max() + 1, bool)
        np.logical_or.at(vote, warp.ravel(), ((k > 4) & (k <= 12)).ravel())
        need = vote[warp]
        split.append(bool((need.any(axis=1) & ~need.all(axis=1)).any()))
        top = np.where(need, 12, 4)
        cv = np.full((W, lanes), 1e9, np.float32)
        for kk in range(1, 13):
            cv = np.where((k == kk) & (kk <= top), x[:, (kk - 1) % q, :], cv)
        acc += np.where(cv < 1e9, cv, 0.0)
        run += 1
    return acc, split


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_warp_vote_equals_plain(name):
    """The per-warp tier vote gives the plain (untiered) sums bit for bit,
    also where the warps of one row take different tiers."""
    x, run0 = make_input(name)
    _, _, _, q, n = SHAPES[name]
    got, split = warp_vote_reference(x, n, q, run0)
    want = tier_select_plain(torch.from_numpy(x), n, q, None if run0 is None
                             else torch.from_numpy(run0))
    assert np.array_equal(got, want.numpy())
    if name == "split":
        assert any(split)
