"""Kernels K1, K2, K3 and K4 on a CUDA card against their plain PyTorch
versions.

These need the card: on the CPU they skip. On a machine with one, run
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.engine.realigner import Realigner
from npore_tpu_torch.golden.align import align as golden_align
from npore_tpu_torch.ops import band_dp as tdp
from npore_tpu_torch.ops import dp_cuda, npinfo_cuda, tb_cuda, tier_select_cuda
from npore_tpu_torch.ops.tables import tables_from_numpy
from npore_tpu_torch.ops.tier_select import tier_select_plain
from npore_tpu_torch.ops.traceback import MAT, traceback
from npore_tpu_torch.testing.planes import path_group, random_cigar

from test_torch_dp import SETS, random_cases, synthetic_cases, windows_of
from test_torch_engine import _items
from test_torch_npinfo_device import GROUPS, group_of, seeded_rows
from test_torch_tier_select import SHAPES, make_input

pytestmark = pytest.mark.cuda

CASES = {name: (cases, cfg) for name, (cases, cfg) in SETS.items()}
CASES["synthetic"] = (synthetic_cases(), AlignConfig())


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _group(name, device):
    cases, cfg = CASES[name]
    wins = windows_of(cases, cfg)
    buf, layout = tw.pack_group(wins, max(w.b_rows for w in wins), cfg.max_n)
    return wins, tw.tensor_views(torch.from_numpy(buf).to(device), layout), cfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_k2_equal_plain(cuda_device, score_matrices, name):
    sub_scores, np_scores, _, _ = score_matrices
    wins, batch, cfg = _group(name, cuda_device)
    tabs = tables_from_numpy(sub_scores, np_scores, cfg, cuda_device)
    n1, n2 = dp_cuda.launches, tb_cuda.launches
    packed = dp_cuda.band_dp(batch, tabs, cfg)
    torch.cuda.synchronize()
    assert dp_cuda.launches == n1 + 1
    assert torch.equal(packed,
                       tdp.pack_planes(*tdp.window_dp(batch, tabs, cfg)))
    got = tb_cuda.traceback(packed, batch, cfg)
    torch.cuda.synchronize()
    assert tb_cuda.launches == n2 + 1
    assert torch.equal(got.buf, traceback(packed, batch, cfg).buf)
    assert int(got.meta[:, 1].sum()) == 0


@pytest.mark.parametrize("r,max_n", [(10, 3), (10, 6), (30, 3), (30, 6)])
def test_k1_equal_plain_past_one_wave(cuda_device, score_matrices, r, max_n):
    """K1 bit-equal to the plain DP on one group of more windows than one
    wave of CTAs holds: short reads with mixed row counts, so CTAs of the
    second wave and zero-filled tails are covered; the state ring's depth
    follows max_n."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(r=r, max_n=max_n)
    wins = windows_of(random_cases(seed=11, n_cases=1500), cfg)
    rows = [w.b_rows for w in wins]
    R = max(rows)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert len(wins) > dp_cuda.occupancy(cfg) * sms
    assert min(rows) < R // 2
    buf, layout = tw.pack_group(wins, R, cfg.max_n)
    batch = tw.tensor_views(torch.from_numpy(buf).to(cuda_device), layout)
    tabs = tables_from_numpy(sub_scores, np_scores[:max_n], cfg, cuda_device)
    packed = dp_cuda.band_dp(batch, tabs, cfg)
    torch.cuda.synchronize()
    assert torch.equal(packed,
                       tdp.pack_planes(*tdp.window_dp(batch, tabs, cfg)))


def test_k1_one_wave_at_production_config(cuda_device):
    """At least 8 CTAs of K1 fit an SM, so a 1024-window group runs in one
    wave on 132 SMs."""
    assert dp_cuda.occupancy(AlignConfig()) >= 8


def test_wrappers_reject_bad_inputs(cuda_device, score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    wins, batch, cfg = _group("toys", cuda_device)
    tabs = tables_from_numpy(sub_scores, np_scores, cfg, cuda_device)
    bad = dict(batch, seqbuf=batch["seqbuf"].to(torch.int32))
    with pytest.raises(ValueError):
        dp_cuda.band_dp(bad, tabs, cfg)
    packed = dp_cuda.band_dp(batch, tabs, cfg)
    with pytest.raises(ValueError):
        tb_cuda.traceback(packed[:, :, :32].contiguous(), batch, cfg)


def test_cuda_engine_matches_golden(cuda_device, score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    cases, cfg = CASES["synthetic"]
    items = _items(cases)
    eng = Realigner(sub_scores, np_scores, cfg, engine="cuda")
    got = eng.align_batch(items)
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)
    assert eng.bail_count == 0


def _k2_equal_plain(batch, packed, device):
    """K2 on the card against the plain traceback on the same tensors:
    the whole output buffer, bailed windows' partial bytes included."""
    batch = {k: v.to(device) for k, v in batch.items()}
    packed = packed.to(device)
    n = tb_cuda.launches
    got = tb_cuda.traceback(packed, batch, AlignConfig())
    torch.cuda.synchronize()
    assert tb_cuda.launches == n + 1
    want = traceback(packed, batch, AlignConfig())
    assert torch.equal(got.buf, want.buf)
    return want


def test_k2_long_windows(cuda_device):
    """Four windows of more than 20,000 rows (5.12 MB of planes each,
    streamed through the ring many times over)."""
    rng = np.random.default_rng(20)
    wins, batch, packed = path_group(
        [random_cigar(rng, 10600) for _ in range(4)], seed=20)
    assert min(len(w.inss_local) for w in wins) >= 20000
    out = _k2_equal_plain(batch, packed, cuda_device)
    assert int(out.meta[:, 1].sum()) == 0


@pytest.mark.parametrize("B", [1, 33, 1025])
def test_k2_ragged_groups(cuda_device, B):
    """Groups that leave warps of the last CTA idle, with windows of 2 to
    ~900 rows in one group."""
    rng = np.random.default_rng(B)
    cigars = [random_cigar(rng, int(n)) for n in rng.integers(1, 450, B)]
    out = _k2_equal_plain(*path_group(cigars, seed=B)[1:], cuda_device)
    assert int(out.meta[:, 1].sum()) == 0


@pytest.mark.parametrize("kind", ["run0", "bad_type", "midpath_zero",
                                  "lane_outside", "mat_past_row0"])
def test_k2_corrupted_planes(cuda_device, kind):
    """A corrupted cell at the start, the middle or the end of each path:
    K2 bails where the plain traceback does and keeps the same partial
    bytes."""
    rng = np.random.default_rng(3)
    cigars = ["DDD==X==I" + random_cigar(rng, int(n))
              for n in rng.integers(60, 500, 40)]
    wins, batch, packed = path_group(cigars, seed=3)
    for j, w in enumerate(wins):
        t, lane, typ, n = w.cells[(0, len(w.cells) // 2, -3)[j % 3]]
        if kind == "run0":
            packed[j, t, lane] = typ
        elif kind == "bad_type":
            packed[j, t, lane] = 5 + j % 3 | n << 3
        elif kind == "midpath_zero":
            packed[j, t, lane] = 0
        elif kind == "lane_outside":
            batch["inss"][j, 8 + t] += (-1) ** j * 40
        else:                   # the first MAT run, 5 long, made 9
            t, lane, typ, n = w.cells[-2]
            assert (typ, n) == (MAT, 5)
            packed[j, t, lane] = MAT | 9 << 3
    out = _k2_equal_plain(batch, packed, cuda_device)
    assert bool(out.meta[:, 1].all())
    assert int(out.meta[:, 0].max()) > 0


def test_k2_one_wave_at_a_full_group(cuda_device):
    """A 1024-window group is 128 CTAs of 8 windows, one CTA an SM."""
    plan = tb_cuda.launch_plan(1024, 1407)
    assert plan.ctas <= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert tb_cuda.occupancy(1024, 1407) >= 1


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k3_equal_plain(cuda_device, name):
    """Bit-equal (tolerance 0): both add in float32 in step order."""
    x, run0 = make_input(name)
    _, _, _, q, n = SHAPES[name]
    xt = torch.from_numpy(x).to(cuda_device)
    r0 = None if run0 is None else torch.from_numpy(run0).to(cuda_device)
    before = tier_select_cuda.launches
    got = tier_select_cuda.tier_select(xt, n, q, r0)
    torch.cuda.synchronize()
    assert tier_select_cuda.launches == before + 1
    assert torch.equal(got, tier_select_plain(xt, n, q, r0))
    with pytest.raises(ValueError):
        tier_select_cuda.tier_select(xt, n, q + 100)


def test_standardize_vcf_cuda_equals_golden(cuda_device, tmp_path, data_dir,
                                            stats_dir):
    """standardize_vcf with K1 and K2 writes the golden engine's files."""
    import gzip
    import os
    from npore_tpu_torch.cli import standardize_vcf as tstd
    argv = ["--vcf", os.path.join(data_dir, "test_std_vcf.vcf"),
            "--ref", os.path.join(data_dir, "test_std_ref.fasta"),
            "--stats_dir", stats_dir]
    pres = {}
    for engine in ("cuda", "golden"):
        pres[engine] = str(tmp_path / engine)
        n1 = dp_cuda.launches
        rl = tstd.run(argv + ["--out_prefix", pres[engine], "--engine",
                              engine])
        assert rl.bail_count == 0
        assert (dp_cuda.launches > n1) == (engine == "cuda")
    for suffix in (".vcf.gz", ".vcf.gz.tbi", "1.vcf.gz", "2.vcf.gz"):
        with open(pres["cuda"] + suffix, "rb") as a, \
                open(pres["golden"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    with gzip.open(pres["cuda"] + ".vcf.gz", "rt") as fh:
        assert sum(1 for l in fh if not l.startswith("#")) >= 4


def test_gini_moments_cuda_equal_cpu(cuda_device):
    from npore_tpu_torch.cli.purity import INS_SLOTS, gini_moments_device
    rng = np.random.default_rng(6)
    b = rng.integers(0, 9201, (100_000, 5)).astype(np.int32)
    iv = rng.integers(0, 1000, (100_000, INS_SLOTS)).astype(np.int32)
    got = gini_moments_device(b, iv)
    want = gini_moments_device(b, iv, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)


def _k4_check(wins, R, cfg, device):
    """K4 on a device buffer filled with 0xA5 around fill_group's prefix:
    every array equal to pack_group's and the planes to the plain scan's
    on the same device tensors."""
    want, layout = tw.pack_group(wins, R, cfg.max_n)
    head = tw.fill_group(wins, R, cfg.max_n)
    off = len(head)
    buf = torch.full((tw.group_nbytes(layout),), 0xA5, dtype=torch.uint8,
                     device=device)
    buf[:off].copy_(torch.from_numpy(head))
    batch = tw.tensor_views(buf, layout)
    n0 = npinfo_cuda.launches
    npinfo_cuda.fill_planes(batch, cfg)
    torch.cuda.synchronize()
    assert npinfo_cuda.launches == n0 + 1
    got = buf.cpu().numpy()
    for k, o, shape, dt in layout:
        n = int(np.prod(shape)) * dt.itemsize
        assert np.array_equal(got[o:o + n], want[o:o + n]), k
    planes = {k: batch[k].clone() for k in tw.PLANES}
    npinfo_cuda.fill_planes_plain(batch, cfg)
    for k in tw.PLANES:
        assert torch.equal(planes[k], batch[k]), k


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_k4_equal_pack_group_and_plain(cuda_device, data_dir, name):
    items, cfg = GROUPS[name](data_dir)
    wins, R = group_of(items, cfg)
    _k4_check(wins, R, cfg, cuda_device)


@pytest.mark.parametrize("max_n,max_l", [(6, 100), (3, 7), (1, 100)])
def test_k4_seeded_rows(cuda_device, max_n, max_l):
    """K4 against the plain scan on seeded repeat-dense rows (N runs and
    tails, rows ending in periodic runs that hold an N, runs past max_l,
    runs of more than 128 units, where the kernel clamps its run byte) up
    to whole-contig widths: 1,024 threads and about 120 KB of shared
    memory a row at 20,001 positions. Each row's length is
    min(n_ins + 1, guard), taken from either side of the min in turn."""
    rows = seeded_rows(seed=2, n_rows=61, max_len=3000)     # 72 rows
    rng = np.random.default_rng(4)
    rows += [rng.integers(0, 5, 20001).astype(np.uint8),
             np.tile(np.array([1, 2, 2], np.uint8), 6667),
             np.tile(np.array([2, 3], np.uint8), 400),
             np.tile(np.array([1, 2, 4, 3, 3, 1], np.uint8), 150)]
    A = 80 + max(len(r) for r in rows) + 40
    B = len(rows) // 2
    assert len(rows) == 2 * B
    cfg = AlignConfig(max_n=max_n, max_l=max_l)
    batch = {k: torch.zeros(B, A, dtype=torch.int8) for k in
             ("seqbuf", "refbuf")}
    batch.update({k: torch.zeros(B, dtype=torch.int32) for k in
                  npinfo_cuda.LENGTHS})
    for i, r in enumerate(rows[:2 * B]):
        side = i // B
        batch[("seqbuf", "refbuf")[side]][i % B, 80:80 + len(r)] = \
            torch.from_numpy(r.astype(np.int8))
        span, guard = (("n_ins", "seq_guard"), ("n_del", "ref_guard"))[side]
        batch[span][i % B] = len(r) - 1 + 7 * (i % 2)
        batch[guard][i % B] = len(r) + 7 * (1 - i % 2)
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    for k in tw.PLANES:
        batch[k] = torch.full((B, A, max_n), 0x5A, dtype=torch.int8,
                              device=cuda_device)
    npinfo_cuda.fill_planes(batch, cfg)
    torch.cuda.synchronize()
    got = {k: batch[k].clone() for k in tw.PLANES}
    npinfo_cuda.fill_planes_plain(batch, cfg)
    for k in tw.PLANES:
        assert torch.equal(got[k], batch[k]), k


def test_k4_rejects_bad_inputs(cuda_device):
    cfg = AlignConfig()
    wins, R = group_of(GROUPS["repeats"](None)[0], cfg)
    layout = tw.group_layout(len(wins), R, cfg.max_n)
    buf = torch.zeros(tw.group_nbytes(layout), dtype=torch.uint8,
                      device=cuda_device)
    batch = tw.tensor_views(buf, layout)
    with pytest.raises(ValueError):
        npinfo_cuda.fill_planes(dict(batch, l_ref=batch["l_ref"][:, :-1]),
                                cfg)
    with pytest.raises(ValueError):
        npinfo_cuda.fill_planes(batch, AlignConfig(max_n=9))
    with pytest.raises(ValueError):                  # the lengths' scalars
        npinfo_cuda.fill_planes(dict(batch, n_del=batch["n_del"].long()),
                                cfg)


def test_cuda_engine_launches_k4_once_a_group(cuda_device, score_matrices,
                                              monkeypatch):
    """The engine scans every group on the card: one K4 launch a group,
    golden CIGARs."""
    from npore_tpu_torch.engine import cuda_engine
    sub_scores, np_scores, _, _ = score_matrices
    cases, cfg = CASES["synthetic"]
    items = _items(cases)
    eng = cuda_engine.CudaEngine(sub_scores, np_scores, cfg,
                                 devices=[cuda_device])
    eng.group_windows = 3
    n0 = npinfo_cuda.launches
    got = eng.align_batch(items)
    assert npinfo_cuda.launches - n0 == eng.groups > 1
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)
