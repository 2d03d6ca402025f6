"""The cells cut to a size the CPU runs in seconds: the cells' own files
with a tiny genome and a dozen short reads, and the plain PyTorch engine
in place of the card's."""
import pytest

from benchmark import harness

TINY = dict(contigs=[["chr1", 40000], ["chr2", 30000], ["chr3", 20000],
                     ["chrM", 16569]],
            unplaced=["chrUn_1", 5000], decoy=["decoy_1", 5000], lead_n=2000,
            long_gap=[500, 1000], primary=12, median=1200,
            lengths=[800, 1600], chrm_reads=2, n_spanning=2, no_md=1,
            m_ops=2, decoy_reads=1, supplementary=2, secondary=2,
            unmapped=2, clip=[1, 200])
SEED = 2**31 + 11


def tiny_cell() -> dict:
    cell = harness.load_cell("realign.wgs")
    cell["name"] = "test.tiny"
    cell["workload"]["traffic"]["layout"].update(TINY)
    return cell


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def run_tiny(cache, trace=False, seed=SEED, cell=None):
    return harness.run_cell(cell or tiny_cell(), seed, 0.5, trace, 0.0,
                            engine="torch", require_device=False,
                            device="cpu", cache=cache)
