"""The port's data mesh (npore_tpu_torch/parallel/mesh.py) against the JAX
package's: the sharded DP step over 8 CPU devices gives the planes and op
counts of the JAX step over the 8 virtual CPU devices of conftest, on the
same pack_batch inputs; the confusion reduce, the engine over several
devices and purity's mesh= give what one device gives. Tolerances are
exact throughout: integers and bit-equal planes."""
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as g
from npore_tpu.parallel import mesh as jm
from npore_tpu_torch.cli import purity as tpur
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.engine.cuda_engine import CudaEngine
from npore_tpu_torch.golden.align import align as golden_align
from npore_tpu_torch.ops import band_dp as tdp
from npore_tpu_torch.ops import dp_cuda
from npore_tpu_torch.ops.tables import tables_from_numpy
from npore_tpu_torch.parallel import mesh as tm

from test_torch_dp import SMALL, random_cases
from test_torch_engine import _items, chunked_cases

torch.set_num_threads(2)

CPU = torch.device("cpu")
N_DEV = 8


@pytest.fixture(scope="module")
def steps():
    """One step of the JAX sharded DP and of the port's over 8 devices, on
    __graft_entry__'s 16 windows (production config, 256 rows)."""
    import jax
    import jax.numpy as jnp
    cfg, batch, tables = g._example_batch(2 * N_DEV)
    jmesh = jm.make_data_mesh(jax.devices("cpu")[:N_DEV])
    jt, jr, jc = jm.make_sharded_step(jmesh, g.R_MAX, cfg, cfg.max_n)(
        jm.shard_batch(batch, jmesh),
        type(tables)(*[jnp.asarray(x) for x in tables]))
    mesh = tm.make_data_mesh([CPU] * N_DEV)
    tabs = {"sub": torch.from_numpy(np.asarray(tables.sub_flat)),
            "cont": torch.from_numpy(np.asarray(tables.cont).reshape(
                2, cfg.max_n, 101, 128))}
    before = dp_cuda.launches
    planes, counts = tm.make_sharded_step(mesh, AlignConfig())(
        tm.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                       mesh), tabs)
    assert dp_cuda.launches == before        # CPU shards run the plain DP
    return (np.asarray(jt), np.asarray(jr), np.asarray(jc)), planes, counts


def test_sharded_step_planes_equal_jax(steps):
    (jt, jr, _), planes, _ = steps
    assert len(planes) == N_DEV
    assert all(tuple(p.shape) == (2, g.R_MAX, 64) for p in planes)
    typ, run = tdp.unpack_planes(torch.cat(planes))
    assert np.array_equal(typ.numpy(), jt)
    assert np.array_equal(run.numpy(), jr)


def test_sharded_step_op_counts_equal_jax(steps):
    (jt, jr, jc), _, counts = steps
    assert counts.dtype == torch.int64 and counts.shape == (5,)
    assert np.array_equal(counts.numpy(), jc)
    live = jr > 0
    assert np.array_equal(counts.numpy(),
                          np.bincount(jt[live], minlength=5))
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_step_equals_unsharded(score_matrices, n):
    """Over 1, 2 and 4 CPU shards the planes are one unsharded DP's."""
    sub_scores, np_scores, _, _ = score_matrices
    from test_torch_dp import windows_of
    from npore_tpu_torch.engine import windows as tw
    wins = windows_of(random_cases(seed=5), SMALL)[:8]
    buf, layout = tw.pack_group(wins, max(w.b_rows for w in wins),
                                SMALL.max_n)
    batch = tw.tensor_views(torch.from_numpy(buf), layout)
    tabs = tables_from_numpy(sub_scores, np_scores, SMALL, CPU)
    mesh = tm.make_data_mesh([CPU] * n)
    planes, counts = tm.make_sharded_step(mesh, SMALL)(
        tm.shard_batch(batch, mesh), tabs)
    want = dp_cuda.band_dp(batch, tabs, SMALL)
    assert torch.equal(torch.cat(planes), want)
    assert torch.equal(counts, tm.op_counts(want))


def test_shard_batch_needs_an_even_split():
    batch = {"inss": torch.zeros(6, 10, dtype=torch.int32),
             "b_rows": torch.arange(6)}
    mesh = tm.make_data_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="evenly"):
        tm.shard_batch(batch, mesh)
    shards = tm.shard_batch(batch, tm.make_data_mesh(["cpu"] * 3))
    assert [s["b_rows"].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5]]
    shards[0]["b_rows"][0] = 9                # a shard owns its memory
    assert batch["b_rows"][0] == 0


def test_make_data_mesh():
    mesh = tm.make_data_mesh(["cpu", CPU])
    assert mesh.size == 2 and mesh.devices == (CPU, CPU)
    assert tm.make_data_mesh(mesh) is mesh
    with pytest.raises(ValueError):
        tm.make_data_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.make_data_mesh()


def test_reduce_confusion_matrices_equals_jax():
    import jax
    rng = np.random.default_rng(0)
    parts = (rng.integers(0, 100, (N_DEV, 5, 5)),
             rng.integers(0, 100, (N_DEV, 2, 4, 4)),
             rng.integers(0, 100, (N_DEV, 7)),
             rng.integers(0, 100, (N_DEV, 7)))
    want = jm.reduce_confusion_matrices(
        jm.make_data_mesh(jax.devices("cpu")[:N_DEV]), *parts)
    got = tm.reduce_confusion_matrices(tm.make_data_mesh(["cpu"] * N_DEV),
                                       *parts)
    for a, b, p in zip(got, want, parts):
        assert a.dtype == np.int64
        assert np.array_equal(a, b) and np.array_equal(a, p.sum(0))
    with pytest.raises(ValueError, match="shards"):
        tm.reduce_confusion_matrices(tm.make_data_mesh(["cpu"] * 3), *parts)


@pytest.mark.parametrize("name", ["random", "chunked"])
def test_engine_over_three_devices(score_matrices, name):
    """CudaEngine(plain=True) over [cpu] * 3, one group a few windows so
    the groups go round-robin: the CIGARs of one device, and golden's."""
    sub_scores, np_scores, _, _ = score_matrices
    cases, cfg = {"random": (random_cases(seed=11), SMALL),
                  "chunked": (chunked_cases(),
                              AlignConfig(max_b_rows=500))}[name]
    items = _items(cases)
    one = CudaEngine(sub_scores, np_scores, cfg, plain=True)
    three = CudaEngine(sub_scores, np_scores, cfg, plain=True,
                       devices=[CPU] * 3)
    assert one.devices == [CPU] and three.devices == [CPU] * 3
    seen = []
    submit = three._submit

    def counted(group):
        seen.append(len(group))
        return submit(group)
    three._submit = counted
    three.group_windows = 2
    got = three.align_batch(items)
    assert got == one.align_batch(items)
    assert len(seen) >= 3 and three.groups == len(seen)
    for it, c in zip(items, got):
        assert c == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)


def test_purity_moments_mesh_equals_unsharded():
    rng = np.random.default_rng(4)
    b = rng.integers(0, 200, (96, 5), dtype=np.int32)
    iv = rng.integers(0, 20, (96, tpur.INS_SLOTS), dtype=np.int32)
    want = tpur.gini_moments_device(b, iv, "cpu")
    for mesh in (["cpu"] * 4, tm.make_data_mesh(["cpu"] * 3)):
        got = tpur.gini_moments_device(b, iv, "cpu", mesh=mesh)
        assert all(x.dtype == np.int32 and np.array_equal(x, y)
                   for x, y in zip(got, want))
    with pytest.raises(ValueError, match="evenly"):
        tpur.gini_moments_device(b, iv, mesh=["cpu"] * 5)


@pytest.mark.parametrize("n", [2, 3])
def test_bam_purity_mesh_equals_unsharded(data_dir, n):
    """The fixture's columns, padded to the mesh and cut after: the scores
    of the unsharded device call, bit for bit."""
    bam = os.path.join(data_dir, "reads.bam")
    want = tpur.bam_purity(bam, None, None, None, 13, processes=1,
                           device="cpu")
    got = tpur.bam_purity(bam, None, None, None, 13, processes=1,
                          device="cpu", mesh=["cpu"] * n)
    assert got.shape == want.shape and len(want) > 0
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="mesh"):
        tpur.bam_purity(bam, None, None, None, 13, processes=1,
                        mesh=["cpu"] * n)


@pytest.mark.cuda
def test_sharded_step_on_the_card(score_matrices):
    """K1 over two shards on one card: bit-equal to one unsharded K1 call
    and to the plain DP, one launch a shard, counts = the planes'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_dp import synthetic_cases, windows_of
    from npore_tpu_torch.engine import windows as tw
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig()
    dev = torch.device("cuda", 0)
    wins = windows_of(synthetic_cases(), cfg)
    wins = wins[:len(wins) // 2 * 2]
    buf, layout = tw.pack_group(wins, max(w.b_rows for w in wins),
                                cfg.max_n)
    batch = tw.tensor_views(torch.from_numpy(buf).to(dev), layout)
    tabs = tables_from_numpy(sub_scores, np_scores, cfg, dev)
    mesh = tm.make_data_mesh([dev, dev])
    before = dp_cuda.launches
    planes, counts = tm.make_sharded_step(mesh, cfg)(
        tm.shard_batch(batch, mesh), tabs)
    torch.cuda.synchronize()
    assert dp_cuda.launches == before + 2
    whole = dp_cuda.band_dp(batch, tabs, cfg)
    assert torch.equal(torch.cat(planes), whole)
    assert torch.equal(whole, tdp.pack_planes(*tdp.window_dp(batch, tabs,
                                                             cfg)))
    assert torch.equal(counts.cpu(), tm.op_counts(whole).cpu())
