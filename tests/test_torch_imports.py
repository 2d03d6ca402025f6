"""The PyTorch port loads no JAX and nothing of the JAX package, and picks
devices without silent fallback."""
import ast
import glob
import importlib.util
import json
import os
import re
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
    "npore_tpu_torch.tracing",
    "npore_tpu_torch.native",
    "npore_tpu_torch.io.cigar",
    "npore_tpu_torch.io.sam",
    "npore_tpu_torch.io.fasta",
    "npore_tpu_torch.io.bgzf",
    "npore_tpu_torch.io.bam_writer",
    "npore_tpu_torch.io.pileup",
    "npore_tpu_torch.io.bam",
    "npore_tpu_torch.io.bam_native",
    "npore_tpu_torch.io.vcf",
    "npore_tpu_torch.golden",
    "npore_tpu_torch.golden.npinfo",
    "npore_tpu_torch.golden.align",
    "npore_tpu_torch.golden.debug",
    "npore_tpu_torch.model.scores",
    "npore_tpu_torch.model.plots",
    "npore_tpu_torch.ops._build",
    "npore_tpu_torch.ops.npinfo_host",
    "npore_tpu_torch.ops.npinfo_device",
    "npore_tpu_torch.ops.tables",
    "npore_tpu_torch.ops.band_dp",
    "npore_tpu_torch.ops.traceback",
    "npore_tpu_torch.ops.tier_select",
    "npore_tpu_torch.ops.dp_cuda",
    "npore_tpu_torch.ops.tb_cuda",
    "npore_tpu_torch.ops.tier_select_cuda",
    "npore_tpu_torch.ops.npinfo_cuda",
    "npore_tpu_torch.engine.regions",
    "npore_tpu_torch.engine.stats",
    "npore_tpu_torch.engine.windows",
    "npore_tpu_torch.engine.cuda_engine",
    "npore_tpu_torch.engine.realigner",
    "npore_tpu_torch.engine.bam_stream",
    "npore_tpu_torch.cli.realign",
    "npore_tpu_torch.cli.standardize_vcf",
    "npore_tpu_torch.cli.bed",
    "npore_tpu_torch.cli.filter",
    "npore_tpu_torch.cli.purity",
    "npore_tpu_torch.parallel",
    "npore_tpu_torch.parallel.distributed",
    "npore_tpu_torch.parallel.mesh",
    "npore_tpu_torch.scripts.probe_cond",
    "npore_tpu_torch.scripts.kernel_ab",
    "npore_tpu_torch.scripts.multihost_scaling",
    "npore_tpu_torch.scripts.dryrun_multichip",
    "npore_tpu_torch.scripts.fuzz_parity",
    "npore_tpu_torch.scripts.bench_engine",
    "npore_tpu_torch.scripts.genome_scale",
    "npore_tpu_torch.scripts.tag_unphased",
    "npore_tpu_torch.scripts.sankey",
    "npore_tpu_torch.scripts.plot_sankey",
    "npore_tpu_torch.testing.synth",
    "npore_tpu_torch.testing.planes",
    "npore_tpu_torch.testing.chunks",
    "npore_tpu_torch.testing.long_reads",
    "npore_tpu_torch.testing.genome_reads",
]
# sankey.py, a verbatim copy of scripts/sankey.py, imports matplotlib when
# it is imported; the imports of every module leave it out where
# matplotlib is missing (plot_sankey imports it only to draw)
NEEDS_MATPLOTLIB = ["npore_tpu_torch.scripts.sankey"]
HAVE_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None
IMPORTABLE = [m for m in MODULES
              if HAVE_MATPLOTLIB or m not in NEEDS_MATPLOTLIB]
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "npore_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]

PORT_SHELL = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "npore_tpu_torch", "**", "*.sh"),
              recursive=True))


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


def test_port_shell_scripts_are_found():
    assert {os.path.basename(p) for p in PORT_SHELL} >= {
        "align.sh", "calc_beds.sh", "purity.sh", "realign_pipeline.sh"}


@pytest.mark.parametrize("path", PORT_SHELL)
def test_no_shell_script_runs_the_jax_package(path):
    """No port shell script names a ``npore_tpu.`` module (only
    ``npore_tpu_torch.``), runs a script of the JAX package's
    ``scripts/``, or imports ``jax``."""
    with open(os.path.join(REPO, path)) as fh:
        for i, line in enumerate(fh, 1):
            assert not re.search(r"\bnpore_tpu\.", line), f"{path}:{i}"
            assert not re.search(r"\bimport jax\b|\bfrom jax\b", line), \
                f"{path}:{i}"
            assert "scripts/" not in line.split("#")[0], f"{path}:{i}"


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
        f"for m in {IMPORTABLE!r}: importlib.import_module(m)\n"
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


@pytest.mark.parametrize("cli", ["standardize_vcf", "bed", "filter",
                                 "purity"])
def test_cli_help_loads_no_jax(cli):
    """``python -m npore_tpu_torch.cli.<cli> --help`` in a fresh
    interpreter: it prints its usage and loads neither jax nor
    npore_tpu."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        f"    runpy.run_module('npore_tpu_torch.cli.{cli}', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'npore_tpu' or "
        "m.startswith('npore_tpu.'))\n"
        "print(json.dumps({'rc': rc, 'loaded': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("usage:")
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": []}


@pytest.fixture(scope="module")
def jax_loaded():
    """In a fresh interpreter, import the modules one after another and
    record after each whether ``jax`` or ``npore_tpu`` is in sys.modules."""
    code = (
        "import importlib, json, sys\n"
        f"out = {{m: (importlib.import_module(m), 'jax' in sys.modules or "
        f"'npore_tpu' in sys.modules)[1] for m in {IMPORTABLE!r}}}\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", [
    pytest.param(m, marks=pytest.mark.skipif(
        m not in IMPORTABLE, reason="needs matplotlib")) for m in MODULES])
def test_import_loads_no_jax(jax_loaded, module):
    assert jax_loaded[module] is False


def test_plot_sankey_needs_matplotlib_only_to_draw():
    """With matplotlib blocked, plot_sankey imports and prints its usage;
    drawing a figure then raises ImportError."""
    code = (
        "import runpy, sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        "    runpy.run_module('npore_tpu_torch.scripts.plot_sankey', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from npore_tpu_torch.scripts import plot_sankey as ps\n"
        "try:\n"
        "    ps.disc_pie(ps.VcfCounts(), '.')\n"
        "except ImportError:\n"
        "    print('no matplotlib')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("usage:") and lines[-1] == "no matplotlib"


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


def test_cli_multi_host_is_not_supported(tmp_path, data_dir, stats_dir,
                                        monkeypatch):
    """Multi-host runs are supported (tests/test_torch_distributed.py), but
    not without a coordinator: the CLI refuses to start one rank alone."""
    from npore_tpu_torch.cli.realign import main
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        main(["--bam", os.path.join(data_dir, "reads.bam"),
              "--ref", os.path.join(data_dir, "ref.fasta"),
              "--out_prefix", str(tmp_path / "o"), "--stats_dir", stats_dir,
              "--engine", "torch", "--num_hosts", "2"])
    assert not os.path.exists(tmp_path / "o.sam")


def test_dryrun_multichip_in_fresh_interpreter_loads_no_jax():
    """``python -m npore_tpu_torch.scripts.dryrun_multichip --device cpu``:
    the sharded step and the engine over two CPU devices pass, and the
    run loads neither jax nor npore_tpu."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['x', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('npore_tpu_torch.scripts.dryrun_multichip', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'npore_tpu' or "
        "m.startswith('npore_tpu.'))\n"
        "print(json.dumps({'rc': rc, 'loaded': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert any("sharded step ok" in l for l in lines)
    assert any("golden-exact" in l for l in lines)
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": []}


@pytest.mark.parametrize("script,argv,expect", [
    ("fuzz_parity", ["5", "0", "--engine", "torch"], "parity: 5/5"),
    ("bench_engine", ["--help"], "usage:"),
    ("genome_scale", ["--help"], "usage:"),
    ("plot_sankey", ["--help"], "usage:"),
    ("tag_unphased", [os.path.join(REPO, "tests", "data", "reads.bam"),
                      os.devnull], "tagged 0 unphased reads")])
def test_script_in_fresh_interpreter_loads_no_jax(script, argv, expect):
    """The ported fuzzer (5 cases on the plain path) and the engine bench's
    usage, in a fresh interpreter: exit 0, and neither jax nor npore_tpu
    loaded."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['x'] + {argv!r}\n"
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_module('npore_tpu_torch.scripts.{script}', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'npore_tpu' or "
        "m.startswith('npore_tpu.'))\n"
        "print(json.dumps({'rc': rc, 'loaded': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert any(expect in l for l in lines)
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": []}
