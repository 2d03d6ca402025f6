"""The port's multi-rank layer (npore_tpu_torch/parallel/distributed.py):
its host functions equal the JAX package's on the same seeded inputs, its
collectives are exact on gloo, and the realign CLI run as two ranks
reproduces the golden SAM and the JAX package's confusion counts.

Ranks are subprocesses that meet at a TCP store on a port picked free, so
parallel test workers never share one."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from npore_tpu.parallel import distributed as jd
from npore_tpu_torch.parallel import distributed as td
from npore_tpu_torch.scripts import multihost_scaling as mh

from test_cli_realign import _parse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _regions(seed):
    rng = np.random.default_rng(seed)
    out = []
    for c in rng.permutation(int(rng.integers(1, 6))):
        lo = 0
        for _ in range(int(rng.integers(1, 8))):
            hi = lo + int(rng.integers(1, 10 ** 5))
            out.append((f"chr{c}", lo, hi))
            lo = hi
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 8])
def test_shard_regions_equals_jax(seed, num_hosts):
    regions = _regions(seed)
    got = [td.shard_regions(regions, num_hosts, h) for h in range(num_hosts)]
    assert got == [jd.shard_regions(regions, num_hosts, h)
                   for h in range(num_hosts)]
    assert sorted(r for s in got for r in s) == sorted(regions)


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_stripe_reads_equals_jax(num_hosts):
    reads = list(np.random.default_rng(num_hosts).integers(0, 1000, 37))
    got = [list(td.stripe_reads(iter(reads), num_hosts, h))
           for h in range(num_hosts)]
    assert got == [list(jd.stripe_reads(iter(reads), num_hosts, h))
                   for h in range(num_hosts)]
    assert sorted(x for s in got for x in s) == sorted(reads)


@pytest.mark.parametrize("num_hosts", [1, 2, 5])
def test_host_out_path_equals_jax(num_hosts):
    for h in range(num_hosts):
        assert td.host_out_path("d/out", h, num_hosts) == \
            jd.host_out_path("d/out", h, num_hosts)


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_merge_host_sams_equals_jax(tmp_path, num_hosts):
    """Seeded per-host SAMs (shuffled records on three contigs, one record
    on a contig missing from @SQ) merge into the same bytes."""
    rng = np.random.default_rng(num_hosts)
    hdr = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:c2\tLN:1000",
           "@SQ\tSN:c1\tLN:500", "@PG\tPN:x\tID:x"]
    recs = [(f"r{i}", str(rng.choice(["c1", "c2", "c9"])),
             int(rng.integers(1, 400))) for i in range(40)]
    outs = {}
    for side, mod in (("jax", jd), ("torch", td)):
        pre = str(tmp_path / side)
        for h in range(num_hosts):
            with open(mod.host_out_path(pre, h, num_hosts), "w") as fh:
                for line in hdr:
                    fh.write(line + "\n")
                for i, (q, c, p) in enumerate(recs):
                    if i % num_hosts == h:
                        fh.write(f"{q}\t0\t{c}\t{p}\t60\t4M\t*\t0\t0\tACGT\t"
                                 f"IIII\n")
        with open(mod.merge_host_sams(pre, num_hosts), "rb") as fh:
            outs[side] = fh.read()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].count(b"\n") == len(hdr) + len(recs)


def test_init_single_host_noop(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert td.init_distributed(None, 1, None) == (0, 1)
    assert not torch.distributed.is_initialized()
    counts = [np.arange(5)]
    assert td.allreduce_counts(counts) is counts
    t = torch.arange(3)
    assert td.allreduce_sum(t) is t
    td.barrier("nothing")
    assert td.local_rank() == int(os.environ.get("LOCAL_RANK", 0))


def test_init_needs_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        td.init_distributed(None, 2, 0)


@pytest.mark.parametrize("ranks, ok", [
    ([("a", "cuda:0"), ("a", "cuda:1")], True),
    ([("a", "cuda:0"), ("b", "cuda:0")], True),
    ([("a", "cuda:0"), ("a", "cuda:0")], False),
    ([("a", "cuda:1"), ("a", "cuda:0"), ("a", "cuda:1")], False),
    ([("a", "cuda:0"), ("a", "cpu")], False),
])
def test_nccl_needs_a_card_a_rank(ranks, ok):
    if ok:
        td.check_nccl_map(ranks)
    else:
        with pytest.raises(RuntimeError, match="nccl"):
            td.check_nccl_map(ranks)


def test_one_rank_group_in_process():
    """A 1-rank gloo group: the collectives run and give their inputs
    back; a card-less rank takes no card; NCCL without a card raises and
    leaves no group behind."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less rank map")
    td.start_group(f"localhost:{mh.free_port()}", 1, 0)
    try:
        counts = [np.arange(6, dtype=np.int64).reshape(2, 3),
                  np.full(4, 7, np.int32)]
        got = td.allreduce_counts(counts)
        assert all(g.dtype == c.dtype and np.array_equal(g, c)
                   for g, c in zip(got, counts))
        assert torch.equal(td.allreduce_sum(torch.arange(5)),
                           torch.arange(5))
        td.barrier("one")
        assert torch.distributed.get_world_size() == 1
        assert td.local_devices() == []
    finally:
        td.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.start_group(f"localhost:{mh.free_port()}", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()


RANK_CODE = """
import json, sys
import numpy as np, torch
from npore_tpu_torch.parallel import distributed as td
coord, rank = sys.argv[1], int(sys.argv[2])
assert td.init_distributed(coord, 3, rank) == (rank, 3)
counts = td.allreduce_counts([np.arange(4, dtype=np.int64) * (rank + 1),
                              np.array([[1 << 40, rank]], np.int64)])
s = td.allreduce_sum(torch.tensor([rank, 1]))
td.barrier("end")
td.shutdown()
print(json.dumps([c.tolist() for c in counts] + [s.tolist()]))
"""


def test_three_rank_collectives_are_exact():
    """Three ranks over gloo: int64 sums (one past 2^32) are exact on
    every rank."""
    coord = f"localhost:{mh.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, coord,
                               str(r)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(3)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = [[0, 6, 12, 18], [[3 << 40, 3]], [3, 3]]
    assert outs == [want] * 3


def _cli(data_dir, stats_dir):
    return ["--bam", os.path.join(data_dir, "reads.bam"),
            "--ref", os.path.join(data_dir, "ref.fasta"),
            "--stats_dir", stats_dir, "--engine", "torch"]


def _key(line):
    f = line.split("\t")
    return (f[2], int(f[3]), f[0])


def test_two_rank_realign_equals_golden_sam(tmp_path, data_dir, stats_dir):
    """`cli.realign --engine torch --num_hosts 2` as two processes (one
    region, so read stripes): the merged SAM equals the golden SAM on all
    fields of 10/10 records, with no bail."""
    pre = str(tmp_path / "two")
    row = mh.run_ranks(2, _cli(data_dir, stats_dir) + ["--out_prefix", pre],
                       str(tmp_path), "two")
    assert row["reads"] == 10
    assert [r["bails"] for r in row["ranks"]] == [0, 0]
    assert [r["loaded"] for r in row["ranks"]] == [[], []]
    for h in range(2):
        with open(td.host_out_path(pre, h, 2)) as fh:
            assert sum(not l.startswith("@") for l in fh) == 5
    got_h, got_r = _parse(pre + ".sam")
    want_h, want_r = _parse(os.path.join(data_dir, "npore_realigned.sam"))
    assert [h for h in got_h if h.startswith(("@HD", "@SQ"))] == \
        [h for h in want_h if h.startswith(("@HD", "@SQ"))]
    got_r.sort(key=_key)
    want_r.sort(key=_key)
    assert len(got_r) == len(want_r) == 10
    for g, w in zip(got_r, want_r):
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[:11] == wf[:11], gf[0]
        assert set(gf[11:]) == set(wf[11:]), gf[0]


def test_two_rank_recalc_equals_jax_counts(tmp_path, data_dir, stats_dir):
    """`--recalc_cms --recalc_exit` on two ranks in read-stripe mode: the
    counts come from region shards and are all-reduced once, so rank 0
    saves the JAX package's counts over all regions, not twice them."""
    from npore_tpu.config import AlignConfig, RealignConfig
    from npore_tpu.engine.regions import get_bam_regions
    from npore_tpu.engine.stats import calc_confusion_matrices_bam
    from npore_tpu.io.bam import open_alignment_file
    from npore_tpu.io.fasta import FastaFile
    from npore_tpu_torch.model.scores import load_confusion_matrices
    out_stats = str(tmp_path / "stats")
    cli = _cli(data_dir, out_stats) + ["--recalc_cms", "--recalc_exit",
                                       "--out_prefix", str(tmp_path / "o")]
    row = mh.run_ranks(2, cli, str(tmp_path), "recalc")
    assert [r["loaded"] for r in row["ranks"]] == [[], []]
    got = load_confusion_matrices(out_stats)
    bam, ref = (os.path.join(data_dir, n) for n in ("reads.bam", "ref.fasta"))
    cfg = RealignConfig(bam=bam, ref=ref, align=AlignConfig(max_n=6,
                                                            max_l=100))
    fa = FastaFile(ref)
    regions = get_bam_regions(cfg, fa, open_alignment_file(bam))
    want = calc_confusion_matrices_bam(bam, fa, regions, cfg, processes=1)
    assert len(regions) == 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert want[0].sum() > 0


def test_scaling_script_sweeps_engines_with_max_reads_and_pinned_cores(
        tmp_path, data_dir, stats_dir, capsys):
    """``--engines``, ``--max_reads`` and ``--pin_cores``, the JAX
    script's flags (scripts/multihost_scaling.py): each engine's 1-rank
    and 2-rank runs of the first 4 reads, each rank on its own core
    (taskset), the merged SAM = the 1-rank SAM."""
    rc = mh.main(["--hosts", "2", "--engines", "torch", "--max_reads", "4",
                  "--pin_cores", "1", "--bam",
                  os.path.join(data_dir, "reads.bam"), "--stats_dir",
                  stats_dir, "--workdir", str(tmp_path)])
    assert rc == 0
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    assert [(r["engine"], r["hosts"], r["reads"]) for r in rows] == [
        ("torch", 1, 4), ("torch", 2, 4)]
    assert all(r["records_match_1host"] for r in rows)
    assert [x["reads"] for x in rows[1]["ranks"]] == [2, 2]
    with open(tmp_path / "torch_r0_n2.rank1.log") as fh:
        assert "runtime" in fh.read()


@pytest.mark.parametrize("hosts, pin, ok", [(2, 1, True), (3, 0, True),
                                            (2, 10 ** 6, False)])
def test_pinned_ranks(hosts, pin, ok):
    """Rank h of n runs on cores [h * pin, (h + 1) * pin); more cores
    than the machine has stop the script before any rank starts."""
    cmd = ["python", "x"]
    if not ok:
        with pytest.raises(SystemExit, match="exceeds"):
            mh.check_pin(hosts, pin)
        return
    got = [mh.pinned(cmd, h, hosts, pin) for h in range(hosts)]
    assert got == ([cmd] * hosts if not pin else
                   [["taskset", "-c", f"{h * pin}-{h * pin + pin - 1}"]
                    + cmd for h in range(hosts)])
