"""The port's n-polymer scan (``ops/npinfo_device.py``, the plain version of
kernel K4) against the JAX package's device scan and the exact scanners,
and the device-built group buffer (``windows.fill_group`` + the scan)
against the host packer ``windows.pack_group``, byte for byte. Tolerance:
exact everywhere (integer planes)."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npore_tpu.ops.npinfo_device import np_info_device as jax_np_info_device
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.engine.cuda_engine import CudaEngine
from npore_tpu_torch.engine.realigner import AlignItem
from npore_tpu_torch.golden.align import align as golden_align
from npore_tpu_torch.golden.npinfo import get_np_info
from npore_tpu_torch.native import np_info
from npore_tpu_torch.ops import npinfo_cuda
from npore_tpu_torch.ops.npinfo_device import np_info_device
from npore_tpu_torch.ops.npinfo_host import get_np_info_vec
from npore_tpu_torch.scripts import bench_engine, fuzz_parity
from npore_tpu_torch.testing import synth

from test_torch_windows import _fixture_items, _repeat_items

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded_rows(seed: int = 0, n_rows: int = 40, max_len: int = 400):
    """Rows of random bases, n-polymer runs of periods 1-6 (some longer
    than max_l = 100), N runs inside and at the end, rows that end in a
    periodic run holding an N (ANANAN and ANANA among them: a scan must
    stop at the row's length, since the N matches the zero padding), and
    the two long runs of the int8 check: a 300-base homopolymer and a
    150-unit dinucleotide. Bases 0 = N, 1-4 = ACGT."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        n = int(rng.integers(1, max_len))
        parts = []
        while sum(len(p) for p in parts) < n:
            u = rng.random()
            if u < 0.35:
                parts.append(rng.integers(1, 5, int(rng.integers(1, 20))))
            elif u < 0.45:
                parts.append(np.zeros(int(rng.integers(1, 5)), np.int64))
            else:
                unit = rng.integers(1, 5, int(rng.integers(1, 7)))
                parts.append(np.tile(unit, int(rng.integers(2, 70))))
        row = np.concatenate(parts)[:n]
        if i % 4 == 0:                               # an N tail
            row = np.concatenate([row, np.zeros(int(rng.integers(1, 6)),
                                                np.int64)])
        rows.append(row)
    rows += [bases_to_int(seq) for _, seq, _ in synth.n_tail_reads(rng, 6)]
    rows += [np.full(300, 1), np.tile([2, 3], 150),
             np.concatenate([[4], np.tile([1, 2, 3], 40), [0, 0]])]
    return [r.astype(np.uint8) for r in rows]


def padded(rows, extra: int = 13) -> np.ndarray:
    P = max(len(r) for r in rows) + extra
    out = np.zeros((len(rows), P), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


@pytest.fixture(scope="module")
def rows():
    return seeded_rows()


@pytest.mark.parametrize("max_n,max_l", [(1, 100), (2, 100), (3, 100),
                                         (4, 100), (5, 100), (6, 100),
                                         (6, 5), (3, 11)])
def test_plain_equals_jax_np_info_device(rows, max_n, max_l):
    """L equal and L_IDX == 0 equal to the JAX scan's LZ plane."""
    x = padded(rows)
    want_l, want_lz = jax_np_info_device(jnp.asarray(x), max_n, max_l)
    got_l, got_i = np_info_device(torch.from_numpy(x), max_n, max_l)
    assert got_l.dtype == got_i.dtype == torch.int32
    assert got_l.shape == (len(rows), max_n, x.shape[1])
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert np.array_equal((got_i == 0).numpy().astype(np.int32),
                          np.asarray(want_lz))


@pytest.mark.parametrize("max_l", [100, 3, 7, 11])
@pytest.mark.parametrize("max_n", [6, 3])
def test_plain_equals_exact_scanners(rows, max_n, max_l):
    """L and the full L_IDX equal golden, the port's C++ np_info and the
    vectorised host scan; zero past each row's end."""
    x = padded(rows)
    lengths = torch.tensor([len(r) for r in rows])
    got_l, got_i = np_info_device(torch.from_numpy(x), max_n, max_l,
                                  lengths)
    for i, r in enumerate(rows):
        want = get_np_info(r, max_n, max_l)
        assert np.array_equal(np_info(r, max_n, max_l), want)
        assert np.array_equal(get_np_info_vec(r, max_n, max_l), want)
        n = len(r)
        assert np.array_equal(got_l[i, :, :n].numpy().T, want[:, 0]), i
        assert np.array_equal(got_i[i, :, :n].numpy().T, want[:, 1]), i
        assert not got_l[i, :, n:].any() and not got_i[i, :, n:].any()


def test_long_runs_fit_int8(rows):
    """A 300-base homopolymer and a 150-unit dinucleotide: L_IDX stays at
    most max_l, so the int8 planes hold it (a wrap to 0 would read as a
    repeat start in K1)."""
    x = padded(rows[-3:-1])
    L, I = np_info_device(torch.from_numpy(x), 6, 100)
    assert int(L.max()) == 100 and int(I.max()) == 100
    assert int(I[0, 0].max()) == 100 and int(I[1, 1].max()) == 100


def test_scan_stops_at_row_length():
    """ANANAN has a 3-unit dinucleotide run at 0, 2 and 4; ANANA has none.
    Past the row both read as N, so zero padding alone gives ANANA a third
    unit (its last N matches the padding): the lengths stop the runs."""
    x = padded([np.array([1, 0, 1, 0, 1, 0]), np.array([1, 0, 1, 0, 1])], 4)
    L, I = np_info_device(torch.from_numpy(x), 6, 100, torch.tensor([6, 5]))
    want = np.zeros((2, 6, 10), np.int32)
    want[0, 1, [0, 2, 4]] = 3
    assert np.array_equal(L.numpy(), want)
    assert np.array_equal(I[0, 1, :6].numpy(), [0, 0, 1, 0, 2, 0])
    assert not I[1].any()
    L, _ = np_info_device(torch.from_numpy(x), 6, 100)
    assert L[1, 1, 0] == 3                   # what the padding alone gives


def test_empty_and_tiny_rows():
    x = np.array([[0, 0, 0], [1, 1, 1], [2, 0, 0]], np.int32)
    L, I = np_info_device(torch.from_numpy(x), 6, 100)
    want = np.zeros((3, 6, 3), np.int32)
    want[1, 0] = 3
    assert np.array_equal(L.numpy(), want)
    assert np.array_equal(I[1, 0].numpy(), [0, 1, 2])


def mixed_items(per_bucket: int = 3):
    """Seeded reads of bench.py's four length buckets (chip_smoke.py's
    mixed set, fewer reads a bucket)."""
    rng = np.random.default_rng(7)
    ref = synth.make_ref(rng, 6000)
    out = []
    for lo, hi in ((120, 170), (260, 350), (430, 690), (950, 1400)):
        for _ in range(per_bucket):
            pos, seq, cig = synth.make_read(rng, ref, min_len=lo, max_len=hi)
            span = sum(c != "I" for c in cig)
            out.append((bases_to_int(ref[pos:pos + span]), bases_to_int(seq),
                        cig))
    return out


def n_tail_items(n_reads: int = 20):
    """Seeded reads dense in periodic runs that hold an N, each ending in
    one (``synth.n_tail_reads``), ANANAN and ANANA first."""
    return [(bases_to_int(ref), bases_to_int(seq), cig) for ref, seq, cig
            in synth.n_tail_reads(np.random.default_rng(11), n_reads)]


GROUPS = {
    "fixture": lambda d: (_fixture_items(d), AlignConfig()),
    "mixed": lambda d: (mixed_items(), AlignConfig()),
    "chunked": lambda d: (_fixture_items(d)[:3],
                          AlignConfig(r=10, max_b_rows=20)),
    "repeats": lambda d: (_repeat_items(), AlignConfig()),
    "ntails": lambda d: (n_tail_items(), AlignConfig()),
    "ntails_chunked": lambda d: (n_tail_items()[:12],
                                 AlignConfig(r=10, max_b_rows=20)),
}


def group_of(items, cfg):
    wins = []
    for i, (ref, seq, cig) in enumerate(items):
        wins += tw.build_windows(ref, seq, cig, cfg, aln_idx=i)
    wins.sort(key=lambda w: w.b_rows)
    return wins, max(w.b_rows for w in wins)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_fill_group_and_scan_equal_pack_group(data_dir, name):
    """fill_group's prefix plus the scan's planes give pack_group's buffer,
    byte for byte: on a zeroed buffer the whole buffer, on one filled with
    0xA5 every array (so the scan writes every byte of its planes)."""
    items, cfg = GROUPS[name](data_dir)
    wins, R = group_of(items, cfg)
    want, layout = tw.pack_group(wins, R, cfg.max_n)
    head = tw.fill_group(wins, R, cfg.max_n)
    off = tw.prefix_nbytes(layout)
    assert len(head) == off
    assert [e[0] for e in layout[-4:]] == list(tw.PLANES)
    for fill in (0, 0xA5):
        buf = torch.full((tw.group_nbytes(layout),), fill, dtype=torch.uint8)
        buf[:off] = torch.from_numpy(head)
        n0 = npinfo_cuda.launches
        npinfo_cuda.fill_planes(tw.tensor_views(buf, layout), cfg)
        assert npinfo_cuda.launches == n0         # the plain version
        got = buf.numpy()
        if fill == 0:
            assert np.array_equal(got, want)
        for k, o, shape, dt in layout:
            n = int(np.prod(shape)) * dt.itemsize
            assert np.array_equal(got[o:o + n], want[o:o + n]), k
    # into a pinned-style caller buffer: only the prefix is written
    out = np.full(tw.group_nbytes(layout) + 7, 0x5A, np.uint8)
    got_head = tw.fill_group(wins, R, cfg.max_n, out=out)
    assert np.shares_memory(got_head, out)
    assert np.array_equal(out[:off], want[:off])
    assert (out[off:] == 0x5A).all()


def test_fill_planes_rejects_other_devices():
    cfg = AlignConfig()
    wins, R = group_of(_repeat_items(), cfg)
    layout = tw.group_layout(len(wins), R, cfg.max_n)
    buf = torch.empty(tw.group_nbytes(layout), dtype=torch.uint8,
                      device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        npinfo_cuda.fill_planes(tw.tensor_views(buf, layout), cfg)


@pytest.mark.parametrize("A,threads,staged,smem", [
    (1527, 128, True, 23712),       # the fixture group
    (2892, 192, True, 42816),       # a mixed group
    (20121, 1024, False, 122720),   # whole-contig windows
    (npinfo_cuda.largest_A(6), 1024, False, 232448)])
def test_launch_plan_shapes(A, threads, staged, smem):
    """K4's launch: staged where the two planes fit the shared memory, else
    unstaged; the widest accepted row fills it exactly."""
    plan = npinfo_cuda.launch_plan(A, 6)
    assert plan == (threads, staged, smem)
    assert plan.smem_bytes == npinfo_cuda.smem_bytes(A, 6, staged)


def test_launch_plan_fits_shared_memory_or_raises():
    for max_n in range(1, npinfo_cuda.MAX_N + 1):
        top = npinfo_cuda.largest_A(max_n)
        for A in (81, 121, 1011, 1527, 2892, 5000, 20121, top - 1, top):
            plan = npinfo_cuda.launch_plan(A, max_n)
            assert 0 < plan.smem_bytes <= 232448
            assert plan.smem_bytes == npinfo_cuda.smem_bytes(A, max_n,
                                                             plan.staged)
            assert plan.threads % 32 == 0 and 128 <= plan.threads <= 1024
            if plan.staged:         # staged wherever it fits
                continue
            assert npinfo_cuda.smem_bytes(A, max_n, True) > 232448
        with pytest.raises(ValueError, match="shared memory"):
            npinfo_cuda.launch_plan(top + 1, max_n)


def test_threads_for_shapes():
    assert npinfo_cuda.threads_for(80 + 1407 + 40) == 128
    assert npinfo_cuda.threads_for(80 + 2812 + 40) == 192
    assert npinfo_cuda.threads_for(80 + 20001 + 40) == 1024
    for A in (121, 1527, 5000, 20121, 33000):
        t = npinfo_cuda.threads_for(A)
        assert t % 32 == 0 and 128 <= t <= 1024


@pytest.mark.parametrize("max_l", [20, 60])
def test_torch_engine_small_max_l_matches_golden(score_matrices, max_l):
    """The engine scans at the configuration's max_l, as the golden aligner
    does (pack_group scans at 100 whatever the configuration): runs longer
    than max_l realign to golden's CIGARs."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_l=max_l)
    items = [AlignItem(*it) for it in _repeat_items()]
    got = CudaEngine(sub_scores, np_scores, cfg, plain=True).align_batch(
        items)
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)


@pytest.mark.parametrize("cfg", [AlignConfig(),
                                 AlignConfig(r=10, max_b_rows=20)],
                         ids=["whole", "chunked"])
def test_torch_engine_n_tails_match_golden(score_matrices, cfg):
    """Reads and windows that end in periodic runs holding an N realign to
    golden's CIGARs through the plain engine (the planes themselves are
    held to pack_group's above)."""
    sub_scores, np_scores, _, _ = score_matrices
    items = [AlignItem(*it) for it in n_tail_items(8)]
    got = CudaEngine(sub_scores, np_scores, cfg, plain=True).align_batch(
        items)
    for it, g in zip(items, got):
        assert g == golden_align(it.ref, it.seq, it.cigar, sub_scores,
                                 np_scores, cfg)


def _jax_fuzz_script():
    path = os.path.join(REPO, "scripts", "fuzz_parity.py")
    spec = importlib.util.spec_from_file_location("jax_fuzz_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 3])
def test_fuzz_cases_equal_jax_script(seed):
    """The ported fuzzer draws the JAX script's cases from a seed."""
    jax_fuzz = _jax_fuzz_script()
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(30):
        assert fuzz_parity.make_case(a) == jax_fuzz.make_case(b)


def test_fuzz_torch_engine_20_cases(capsys):
    assert fuzz_parity.main(["20", "0", "--engine", "torch"]) == 0
    assert "parity: 20/20" in capsys.readouterr().out


def test_fuzz_reports_a_mismatch(monkeypatch, capsys):
    """A wrong CIGAR from the engine makes the fuzzer exit 1."""
    real = CudaEngine.align_batch
    monkeypatch.setattr(
        CudaEngine, "align_batch",
        lambda self, items: ["I" + c[1:] if i == 1 else c
                             for i, c in enumerate(real(self, items))])
    assert fuzz_parity.main(["3", "1", "--engine", "torch"]) == 1
    assert "MISMATCH case 1" in capsys.readouterr().out


def test_bench_engine_torch():
    out = bench_engine.run(replicas=1, engine="torch", passes=1)
    assert out["reads"] == 10 and out["bails"] == 0 and out["best"] > 0
