"""The PyTorch port stands alone and never falls back silently.

(d) importing every `abpoa_tpu_torch` module, the native host graph's
    included, pulls in neither `jax` nor any `abpoa_tpu` module (checked in
    a fresh interpreter), nor do the run telemetry (`obs`) and `warm`
    alone; the kernels' and the native graph's sources ship as package
    data.
(e) with no CUDA device, the default `Params()` and the CLI raise instead of
    running on the CPU, and `device="cpu"` runs.
Every single-set configuration of the JAX package finalizes: `-b < 0`,
`-G`, the per-read route outside global mode (`-i` with read-id outputs,
`-Q -d > 1`), those with read-id outputs (MSA, GFA, `-a 1`, `-d > 1`, with
`use_read_ids` set), `-i`, `-g`, `-l`, `-S` and `-p`; the flag sets once
refused run on the CPU and equal the JAX CLI, and `-b -1` reproduces its
golden.
"""
import os
import subprocess
import sys

import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch.device import resolve_device
from abpoa_tpu_torch.params import Params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import abpoa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(abpoa_tpu_torch.__path__,
                                                "abpoa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "abpoa_tpu" or m.startswith("abpoa_tpu."))
print(",".join(names), ",".join(bad))
"""

# the modules of the fused route, which must be among those imported
FUSED_ROUTE = {"abpoa_tpu_torch.align." + m for m in (
    "buckets", "eligibility", "device_graph", "fused_dp_kernel",
    "backtrack_kernel", "edge_sort_kernel", "topo_kernel", "fused_loop")}
# the per-read and seeded routes' host graph and tables
NATIVE_GRAPH = {"abpoa_tpu_torch.native", "abpoa_tpu_torch.native.graph",
                "abpoa_tpu_torch.align.tables", "abpoa_tpu_torch.align.banded",
                "abpoa_tpu_torch.seed", "abpoa_tpu_torch.convert"}
# the server and the postmortem (`why`, the flight recorder)
SERVE = {"abpoa_tpu_torch.serve", "abpoa_tpu_torch.serve.admission",
         "abpoa_tpu_torch.serve.server", "abpoa_tpu_torch.obs.why",
         "abpoa_tpu_torch.obs.flight", "abpoa_tpu_torch.obs.tally"}
# the lockstep and map routes
BATCHED = {"abpoa_tpu_torch.align.dp_chunk", "abpoa_tpu_torch.io.gaf",
           "abpoa_tpu_torch.parallel", "abpoa_tpu_torch.parallel.lockstep",
           "abpoa_tpu_torch.parallel.map_driver",
           "abpoa_tpu_torch.parallel.runner",
           "abpoa_tpu_torch.parallel.scheduler",
           "abpoa_tpu_torch.parallel.shard"}


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def test_port_imports_neither_jax_nor_abpoa_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names, _, bad = proc.stdout.strip().partition(" ")
    names = set(names.split(","))
    assert len(names) >= 36
    assert FUSED_ROUTE | NATIVE_GRAPH | BATCHED | SERVE <= names
    assert bad == ""


_IMPORT_OBS = """
import sys
import abpoa_tpu_torch.obs, abpoa_tpu_torch.kernels.warm
import abpoa_tpu_torch.obs.perf, abpoa_tpu_torch.obs.slo, abpoa_tpu_torch.obs.top
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "abpoa_tpu" or m.startswith("abpoa_tpu."))
print(",".join(bad))
"""


def test_telemetry_imports_neither_jax_nor_abpoa_tpu():
    """The run-telemetry layer and `warm` on their own, in a fresh
    interpreter: no jax and no abpoa_tpu module comes with them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_OBS], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""


_IMPORT_SERVE = """
import sys
import abpoa_tpu_torch.serve, abpoa_tpu_torch.obs.why
import abpoa_tpu_torch.obs.flight
from abpoa_tpu_torch.serve import server
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "abpoa_tpu" or m.startswith("abpoa_tpu."))
print(",".join(bad), "torch" in sys.modules)
"""


def test_server_imports_neither_jax_nor_abpoa_tpu():
    """The server, `why` and the flight recorder on their own, in a fresh
    interpreter: torch and numpy, no jax and no abpoa_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SERVE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["True"]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card contract is moot")


def test_default_params_raise_without_card():
    _no_card()
    assert Params().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Params().finalize()
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")


def test_cli_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([os.path.join(DATA_DIR, "seq.fa")])


def test_module_entry_point_fails_without_card():
    _no_card()
    proc = subprocess.run(
        [sys.executable, "-m", "abpoa_tpu_torch", os.path.join(DATA_DIR, "seq.fa")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_cpu_device_runs(capsys):
    abpt = Params(device="cpu").finalize()
    assert abpt.torch_device == torch.device("cpu")
    assert cli.main([os.path.join(DATA_DIR, "seq4.fa"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(">Consensus_sequence\n")


@pytest.mark.parametrize("name", ["tpu", "mps:0x"])
def test_unknown_device_rejected(name):
    with pytest.raises(ValueError):
        Params(device=name).finalize()


@pytest.mark.parametrize("fields", [
    {"use_qv": True, "max_n_cons": 2},           # -Q -d 2
    {"incr_fn": "g.gfa", "out_msa": True},       # -i -r 1
    {"incr_fn": "g.gfa", "align_mode": 1},       # -i -m 1: the fused route
    {"out_pog": "g.png"},                        # -g
    {"disable_seeding": False},                  # -S
    {"progressive_poa": True},                   # -p
    {"use_qv": True, "max_n_cons": 2, "gap_open2": 0},       # -Q -d 2 -O 4
    {"incr_fn": "g.gfa", "out_gfa": True, "gap_open1": 0},   # -i -r 3 -O 0
    {"disable_seeding": False, "align_mode": 1},  # -S -m 1: the fused route
    {"wb": -1},                                  # unbanded
    {"inc_path_score": True},                    # -G
    {"wb": -1, "disable_seeding": False},        # -S -b -1
    {"inc_path_score": True, "disable_seeding": False},  # -S -G
    # the per-read route outside global mode
    {"use_qv": True, "max_n_cons": 2, "align_mode": 2},  # -Q -d 2 -m 2
    {"incr_fn": "g.gfa", "out_msa": True, "align_mode": 1},  # -i -r 1 -m 1
    # -p -i x.gfa -r 1 -m 2: outside global mode -p is ignored (the JAX
    # package's plain_route), and -i with read ids is per read
    {"progressive_poa": True, "incr_fn": "g.gfa", "out_msa": True,
     "align_mode": 2},
])
def test_lifted_configs_finalize(fields):
    abpt = Params(device="cpu")
    for k, v in fields.items():
        setattr(abpt, k, v)
    assert abpt.finalize()._finalized


@pytest.mark.parametrize("fields", [
    {"max_n_cons": 2},                           # -d 2
    {"out_msa": True},                           # -r 1
    {"out_gfa": True},                           # -r 3
    {"cons_algrm": 1},                           # -a 1
])
def test_read_id_configs_finalize(fields):
    abpt = Params(device="cpu")
    assert not abpt.use_read_ids
    for k, v in fields.items():
        setattr(abpt, k, v)
    assert abpt.finalize().use_read_ids


@pytest.mark.parametrize("fields,gap_mode,wb", [
    ({"gap_open1": 0}, 0, 10),                   # linear gaps
    ({"gap_open2": 0}, 1, 10),                   # affine gaps
    ({"align_mode": 1}, 2, -1),                  # local: unbanded
    ({"align_mode": 2, "zdrop": 50}, 2, 10),     # extend with Z-drop
])
def test_configs_of_the_fused_route_finalize(fields, gap_mode, wb):
    abpt = Params(device="cpu")
    for k, v in fields.items():
        setattr(abpt, k, v)
    abpt.finalize()
    assert (abpt.gap_mode, abpt.wb) == (gap_mode, wb)


_GFA = os.path.join(DATA_DIR, "seq10.gfa")


@pytest.mark.parametrize("fa,flags", [
    ("heter.fq", ["-Q", "-d", "2", "-m", "1"]),
    ("seq4.fa", ["-i", _GFA, "-r", "1", "-m", "2"]),
    ("seq.fa", ["-S", "-b", "-1"]), ("seq.fa", ["-G"]),
    ("seq.fa", ["-S", "-G"]),
    ("seq4.fa", ["-p", "-i", _GFA, "-r", "1", "-m", "2"])])
def test_cli_rejects_flags_outside_the_slice(fa, flags, capsys):
    """The flag sets the port refused before B2 ran every mode: each now
    runs on the CPU and equals the JAX CLI."""
    from test_torch_pipeline import _jax_cli
    argv = [os.path.join(DATA_DIR, fa), *flags]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == _jax_cli(argv)


@pytest.mark.parametrize("args,head", [
    (["-l", os.path.join("tests", "data", "list.txt")], ">Consensus_sequence"),
    (["-l", os.path.join("tests", "data", "list.txt"), "--lockstep", "on",
      "--mesh", "2"], ">Consensus_sequence"),
    ([os.path.join("tests", "data", "seq4.fa"), "-i",
      os.path.join("tests", "data", "seq10.gfa")], ">Consensus_sequence"),
    ([os.path.join("tests", "data", "seq.fa"), "-S"], ">Consensus_sequence"),
    ([os.path.join("tests", "data", "seq4.fa"), "-i",
      os.path.join("tests", "data", "seq10.gfa"), "-r", "1", "-O", "0"],
     ">1\n"),
])
def test_cli_runs_the_lifted_flags(args, head, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)  # list.txt names its files from the root
    # --mesh writes ABPOA_TPU_MESH: setenv (not delenv, which records
    # nothing for an unset variable) has it removed after the test
    monkeypatch.setenv("ABPOA_TPU_MESH", "0")
    assert cli.main([*args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(head)


@pytest.mark.parametrize("flag,value,field,want", [
    ("-e", "5", "end_bonus", 5),
    ("-k", "15", "k", 15),
    ("-w", "7", "w", 7),
    ("-n", "300", "min_w", 300),
    ("-q", "0.3", "min_freq", 0.3),
])
def test_cli_stores_the_flags_of_the_jax_cli(flag, value, field, want):
    ns = cli.build_parser().parse_args(["x.fa", flag, value])
    assert getattr(cli.args_to_params(ns), field) == want


def test_cli_noband_names_its_item(capsys):
    """`-b -1`, once refused naming its ROADMAP item, reproduces its
    golden (the per-read route, B2 unbanded)."""
    assert cli.main([os.path.join(DATA_DIR, "seq.fa"), "--device", "cpu",
                     "-b", "-1"]) == 0
    with open(os.path.join(ROOT, "tests", "golden", "seq_noband.txt")) as fp:
        assert capsys.readouterr().out == fp.read()


def test_kernel_sources_ship_as_package_data():
    import fnmatch
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fp:
        cfg = tomllib.load(fp)["tool"]["setuptools"]
    assert any(fnmatch.fnmatch("abpoa_tpu_torch", pat)
               for pat in cfg["packages"]["find"]["include"])
    patterns = cfg["package-data"]["abpoa_tpu_torch"]
    csrc = os.path.join(ROOT, "abpoa_tpu_torch", "csrc")
    sources = [f"csrc/{f}" for f in os.listdir(csrc) if f.endswith(".cu")]
    sources.append("native/host_core.cpp")
    assert os.path.isfile(os.path.join(ROOT, "abpoa_tpu_torch", sources[-1]))
    assert sources and all(any(fnmatch.fnmatch(s, p) for p in patterns)
                           for s in sources)
