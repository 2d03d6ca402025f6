"""The frozen generator writes the port's generator's files byte for byte."""
import dataclasses
import filecmp
import json

import pytest

from benchmark.traffic import genome_bam
from npore_tpu_torch.testing import genome_reads as gr


@pytest.mark.parametrize("seed", [29, 2**31 + 5])
def test_genome_bam_equals_the_ports_generator(tmp_path, seed):
    layout = json.loads(json.dumps(dataclasses.asdict(gr.REDUCED)))
    mine = genome_bam.write(str(tmp_path / "mine"), genome_bam.make(
        seed, genome_bam.Layout.from_json(layout)))
    fasta, bam = gr.write_genome_reads(
        str(tmp_path / "port"), gr.make_genome_reads(seed, gr.REDUCED))
    assert filecmp.cmp(mine["fasta"], fasta, shallow=False)
    assert filecmp.cmp(mine["bam"], bam, shallow=False)


def test_expected_records_are_the_ports(tmp_path):
    g = gr.make_genome_reads(7, gr.REDUCED)
    layout = json.loads(json.dumps(dataclasses.asdict(gr.REDUCED)))
    paths = genome_bam.write(str(tmp_path), genome_bam.make(
        7, genome_bam.Layout.from_json(layout)))
    with open(paths["expected"]) as fh:
        rows = [json.loads(line) for line in fh]
    want = gr.expected_output(g)
    assert [r["qname"] for r in rows] == [r.qname for r in want]
    assert [r["cigar"] for r in rows] == [r.cli_cigar for r in want]
    assert [r["seq"] for r in rows] == [r.aligned_seq for r in want]




@pytest.fixture(scope="module")
def confusion_reads():
    """The cell's own layout, with its confusion-count noise, on three
    contigs of 1 Mbp and 200 reads."""
    t = json.load(open("benchmark/traffic/wgs_bam.json"))["layout"]
    t.update(contigs=[["chr1", 1_000_000], ["chr2", 1_000_000],
                      ["chrM", 16569]], primary=200, chrm_reads=4,
             n_spanning=2, supplementary=5, secondary=5, unmapped=5)
    layout = genome_bam.Layout.from_json(t)
    return genome_bam.make(2**31 + 3, layout), layout


def test_confusion_noise_cigars_spell_the_reads(confusion_reads):
    g, _ = confusion_reads
    for r in g.reads:
        if r.kind == genome_bam.UNMAPPED:
            continue
        c = r.ecigar
        ref = g.fasta.get(r.rname)
        seq = r.seq[r.clips[0]:len(r.seq) - r.clips[1]] \
            if r.seq != "*" else None
        assert c[0] in "=X" and c[-1] in "=X"
        qi, ri = 0, r.pos
        for op in c:
            if op in "=X":
                if ref is not None and seq is not None:
                    assert (seq[qi] == ref[ri]) == (op == "="), r.qname
                qi, ri = qi + 1, ri + 1
            elif op == "I":
                qi += 1
            else:
                ri += 1
        assert ri - r.pos == r.span
        if seq is not None:
            assert qi == len(seq)


def test_confusion_noise_follows_the_counts(confusion_reads):
    """Substitutions, and the length errors of the n-polymer runs, at the
    rates the counts give, within 6 binomial standard deviations."""
    import numpy as np
    g, layout = confusion_reads
    noise = genome_bam.ConfusionNoise(layout.noise)
    subs = np.load("benchmark/configs/guppy5_stats/subs_cm.npy")[1:, 1:]
    p_sub = 1 - np.trace(subs) / subs.sum()
    nps = np.load("benchmark/configs/guppy5_stats/nps_cm.npy"
                  ).astype(np.float64)
    n_x = n_kept = 0
    p_hp, n_hp, wrong_hp = [], 0, 0
    for r in g.reads:
        if r.kind != genome_bam.PRIMARY or r.spans_gap:
            continue
        n_x += r.ecigar.count("X")
        n_kept += r.ecigar.count("X") + r.ecigar.count("=")
        contig = np.frombuffer(g.fasta[r.rname].encode(), np.uint8)
        a, per, units = noise.runs(r.rname, contig, r.pos, r.span)
        ref_at = np.concatenate(([0], np.cumsum(
            np.frombuffer(r.ecigar.encode(), np.uint8) != ord("I"))))
        # a homopolymer of 5 units read at another length: an indel at
        # its start
        for s in a[(per == 1) & (units == 5)]:
            i = int(np.searchsorted(ref_at, s))
            n_hp += 1
            wrong_hp += r.ecigar[i] in "ID"
            p_hp.append(1 - nps[0, 5, 5] / nps[0, 5].sum())
    assert abs(n_x - p_sub * n_kept) < 6 * np.sqrt(p_sub * n_kept) + 1
    want = float(np.sum(p_hp))
    assert n_hp > 500
    assert abs(wrong_hp - want) < 6 * np.sqrt(want) + 1


def test_confusion_noise_is_seeded(tmp_path):
    t = json.load(open("benchmark/traffic/wgs_bam.json"))["layout"]
    from .conftest import TINY
    layout = genome_bam.Layout.from_json({**t, **TINY})
    a = genome_bam.write(str(tmp_path / "a"), genome_bam.make(11, layout))
    b = genome_bam.write(str(tmp_path / "b"), genome_bam.make(11, layout))
    for k in ("fasta", "bam", "expected"):
        assert filecmp.cmp(a[k], b[k], shallow=False)
