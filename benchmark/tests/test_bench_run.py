"""Whole runs of the harness on the CPU, past its look for a card: the
keys of the result line; ``correct`` true on a sound run and false with
the timed path broken underneath (half the records left out, an answer
altered where it is made); no result without a card."""
import subprocess
import sys

import pytest

from benchmark import harness
from npore_tpu_torch.engine.realigner import Realigner

from .conftest import run_tiny


def test_sound_run(cache):
    code, res = run_tiny(cache)
    assert code == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks" and "breakdown" not in res
    assert len(res["calls_s"]) == res["attempted"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"realign_kb_per_s", "peak_host_gb",
                                   "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    assert res["checks"]["cigars_differing"] == {"value": 0, "limit": 0}


def test_traced_run_reads_the_program_metrics(cache):
    code, res = run_tiny(cache, trace=True)
    assert code == 0 and res["correct"]
    assert "breakdown" in res and list(res)[-1] == "checks"
    m = res["metrics"]
    # no device on the CPU: the trace's readers find nothing to read
    assert "device_idle_share.realign" not in m
    assert "dp_roofline.realign" not in m
    for name in ("cli_start_share.realign", "finalize_emit_us_per_kb.realign",
                 "decode_wait_us_per_kb.realign",
                 "device_wait_share.realign"):
        assert m[name]["value"] >= 0, name
    assert 0 < m["cli_start_share.realign"]["value"] < 100


def _drop_half(orig):
    def finalize(self, meta, cigars):
        return [r for i, r in enumerate(orig(self, meta, cigars)) if i % 2]
    return finalize


def _alter(orig):
    def finalize(self, meta, cigars):
        out = list(orig(self, meta, cigars))
        out[0].cigar = "1I" + out[0].cigar
        return out
    return finalize


@pytest.mark.parametrize("fault,check", [(_drop_half, "records_missing"),
                                         (_alter, "cigars_differing")])
def test_a_broken_timed_path_is_not_correct(cache, monkeypatch, fault,
                                            check):
    monkeypatch.setattr(Realigner, "_finalize_records",
                        fault(Realigner._finalize_records))
    code, res = run_tiny(cache)
    assert code == 0 and not res["correct"]
    assert res["checks"][check]["value"] > 0


def test_no_result_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "realign.wgs", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
