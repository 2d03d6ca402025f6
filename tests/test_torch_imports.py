"""The PyTorch port loads no JAX, and picks devices without silent fallback."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "npore_tpu_torch",
    "npore_tpu_torch.device",
    "npore_tpu_torch.ops.tables",
    "npore_tpu_torch.ops.band_dp",
    "npore_tpu_torch.ops.traceback",
    "npore_tpu_torch.ops.dp_cuda",
    "npore_tpu_torch.ops.tb_cuda",
    "npore_tpu_torch.engine.windows",
    "npore_tpu_torch.engine.cuda_engine",
    "npore_tpu_torch.engine.realigner",
    "npore_tpu_torch.cli.realign",
]


@pytest.fixture(scope="module")
def jax_loaded():
    """In a fresh interpreter, import the modules one after another and
    record after each whether ``jax`` is in sys.modules."""
    code = (
        "import importlib, json, sys\n"
        f"out = {{m: (importlib.import_module(m), 'jax' in sys.modules)[1]"
        f" for m in {MODULES!r}}}\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax(jax_loaded, module):
    assert jax_loaded[module] is False


def test_cuda_engine_needs_a_card():
    from npore_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        resolve_device("cuda")


def test_torch_engine_device_and_names():
    from npore_tpu_torch.device import resolve_device
    assert resolve_device("torch") == torch.device("cpu")
    assert resolve_device("torch", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("auto")


def test_realigner_cuda_engine_raises_without_card(score_matrices):
    from npore_tpu_torch.engine.realigner import Realigner
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sub_scores, np_scores, _, _ = score_matrices
    with pytest.raises(RuntimeError):
        Realigner(sub_scores, np_scores, engine="cuda")


def test_cli_multi_host_is_not_supported(tmp_path, data_dir, stats_dir):
    from npore_tpu_torch.cli.realign import main
    with pytest.raises(NotImplementedError):
        main(["--bam", os.path.join(data_dir, "reads.bam"),
              "--ref", os.path.join(data_dir, "ref.fasta"),
              "--out_prefix", str(tmp_path / "o"), "--stats_dir", stats_dir,
              "--engine", "torch", "--num_hosts", "2"])
