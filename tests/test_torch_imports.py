"""The PyTorch port loads no JAX and nothing of the JAX package, and picks
devices without silent fallback."""
import ast
import glob
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
    "npore_tpu_torch.config",
    "npore_tpu_torch.constants",
    "npore_tpu_torch.device",
    "npore_tpu_torch.native",
    "npore_tpu_torch.io.cigar",
    "npore_tpu_torch.io.sam",
    "npore_tpu_torch.io.fasta",
    "npore_tpu_torch.io.bgzf",
    "npore_tpu_torch.io.bam_writer",
    "npore_tpu_torch.io.pileup",
    "npore_tpu_torch.io.bam",
    "npore_tpu_torch.io.bam_native",
    "npore_tpu_torch.golden",
    "npore_tpu_torch.golden.npinfo",
    "npore_tpu_torch.golden.align",
    "npore_tpu_torch.model.scores",
    "npore_tpu_torch.model.plots",
    "npore_tpu_torch.ops._build",
    "npore_tpu_torch.ops.npinfo_host",
    "npore_tpu_torch.ops.tables",
    "npore_tpu_torch.ops.band_dp",
    "npore_tpu_torch.ops.traceback",
    "npore_tpu_torch.ops.tier_select",
    "npore_tpu_torch.ops.dp_cuda",
    "npore_tpu_torch.ops.tb_cuda",
    "npore_tpu_torch.ops.tier_select_cuda",
    "npore_tpu_torch.engine.regions",
    "npore_tpu_torch.engine.stats",
    "npore_tpu_torch.engine.windows",
    "npore_tpu_torch.engine.cuda_engine",
    "npore_tpu_torch.engine.realigner",
    "npore_tpu_torch.cli.realign",
    "npore_tpu_torch.scripts.probe_cond",
    "npore_tpu_torch.scripts.kernel_ab",
    "npore_tpu_torch.testing.synth",
    "npore_tpu_torch.testing.planes",
]
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "npore_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]


def _is_jax_package(name):
    return name == "npore_tpu" or name.startswith("npore_tpu.")


def test_every_port_module_is_listed():
    listed = {m.replace(".", os.sep) for m in MODULES}
    for f in PORT_FILES[:-1]:
        mod = f[:-3].replace(os.sep + "__init__", "")
        assert mod in listed or f.endswith("__init__.py"), f


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_the_jax_package(path):
    """Neither the port nor chip_smoke.py imports ``npore_tpu``, a module
    of it, or ``jax`` (the port's own modules import each other
    relatively)."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not _is_jax_package(n), f"{path}:{node.lineno} {n}"
            assert n.split(".")[0] != "jax", f"{path}:{node.lineno} {n}"


def test_cli_in_fresh_interpreter_loads_no_jax(tmp_path, data_dir,
                                               stats_dir):
    """Import every port module, run the realign CLI with --engine torch on
    the fixture, and list what of jax and npore_tpu got loaded."""
    argv = ["--bam", os.path.join(data_dir, "reads.bam"),
            "--ref", os.path.join(data_dir, "ref.fasta"),
            "--out_prefix", str(tmp_path / "o"), "--stats_dir", stats_dir,
            "--engine", "torch"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from npore_tpu_torch.cli.realign import main\n"
        f"rc = main({argv!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'npore_tpu' or "
        "m.startswith('npore_tpu.'))\n"
        "print(json.dumps({'rc': rc, 'loaded': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "loaded": []}
    with open(tmp_path / "o.sam") as fh:
        assert sum(1 for line in fh if not line.startswith("@")) == 10


@pytest.fixture(scope="module")
def jax_loaded():
    """In a fresh interpreter, import the modules one after another and
    record after each whether ``jax`` or ``npore_tpu`` is in sys.modules."""
    code = (
        "import importlib, json, sys\n"
        f"out = {{m: (importlib.import_module(m), 'jax' in sys.modules or "
        f"'npore_tpu' in sys.modules)[1] for m in {MODULES!r}}}\n"
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
