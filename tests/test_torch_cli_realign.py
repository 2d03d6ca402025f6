"""The port's realign CLI (--engine torch: the plain PyTorch DP and
traceback on the CPU) reproduces the reference's golden SAM on all fields,
and writes the same file as the JAX package's CLI with the golden engine."""
import os

import pytest
import torch

from test_cli_realign import _parse

torch.set_num_threads(2)


def _run(main, tmp_path, data_dir, stats_dir, engine, name):
    pre = str(tmp_path / name)
    rc = main(["--bam", os.path.join(data_dir, "reads.bam"),
               "--ref", os.path.join(data_dir, "ref.fasta"),
               "--out_prefix", pre, "--stats_dir", stats_dir,
               "--engine", engine])
    assert rc == 0
    return pre + ".sam"


@pytest.fixture(scope="module")
def torch_sam(tmp_path_factory, data_dir, stats_dir):
    from npore_tpu_torch.cli.realign import main
    return _run(main, tmp_path_factory.mktemp("torch"), data_dir, stats_dir,
                "torch", "out")


def _key(line):
    f = line.split("\t")
    return (f[2], int(f[3]), f[0])


def test_torch_cli_golden_sam_header(torch_sam, data_dir):
    got_h, _ = _parse(torch_sam)
    want_h, _ = _parse(os.path.join(data_dir, "npore_realigned.sam"))
    assert [h for h in got_h if h.startswith(("@HD", "@SQ"))] == \
        [h for h in want_h if h.startswith(("@HD", "@SQ"))]
    assert any(h.startswith("@PG\tPN:realigner\tID:realigner")
               for h in got_h)


def test_torch_cli_golden_sam_records(torch_sam, data_dir):
    _, got_r = _parse(torch_sam)
    _, want_r = _parse(os.path.join(data_dir, "npore_realigned.sam"))
    got_r.sort(key=_key)
    want_r.sort(key=_key)
    assert len(got_r) == len(want_r) == 10
    for g, w in zip(got_r, want_r):
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[:11] == wf[:11], (gf[0], gf[:11], wf[:11])
        assert set(gf[11:]) == set(wf[11:]), gf[0]


def test_torch_cli_equals_jax_golden_cli(torch_sam, tmp_path, data_dir,
                                         stats_dir):
    from npore_tpu.cli.realign import main as jax_main
    want = _run(jax_main, tmp_path, data_dir, stats_dir, "golden", "jax")
    got_h, got_r = _parse(torch_sam)
    want_h, want_r = _parse(want)
    assert got_h == want_h
    assert sorted(got_r) == sorted(want_r)
