"""`--mesh N` through the CLIs on the CPU (a mesh of N x cpu), against the
JAX package's `--mesh` runs on its virtual CPU mesh and the port's
unsharded runs, byte for byte:
- `-l tests/data/list.txt --lockstep on --mesh 2`, in the default
  consensus and `-r 2`, with each lockstep implementation
  (ABPOA_TPU_LOCKSTEP_IMPL=split|device), == the JAX CLI's `--device jax
  --lockstep on --mesh 2` == the port without `--mesh`; the groups run
  over (cpu, cpu);
- `map --mesh 2` == the JAX CLI's `map --device jax --mesh 2` == the
  port's unsharded map, with `-V 1`'s route line;
- `--mesh -1` is an error (rc 1).
The uneven meshes through the CLI (`-l` and `map`, no JAX) are in
test_torch_shard.py.
"""
import contextlib
import io
import os

import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch.parallel import runner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """Both CLIs write --mesh into ABPOA_TPU_MESH: undone after each test
    (setenv, since delenv records nothing for an unset variable)."""
    monkeypatch.setenv("ABPOA_TPU_MESH", "0")
    monkeypatch.delenv("ABPOA_TPU_LOCKSTEP_K", raising=False)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    os.environ.pop("ABPOA_TPU_MESH", None)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def meshes(monkeypatch):
    """The meshes the `-l` groups ran over."""
    seen = []
    real = runner.flush_lockstep_group

    def flush(group, abpt, mesh=None):
        seen.append(mesh)
        return real(group, abpt, mesh)

    monkeypatch.setattr(runner, "flush_lockstep_group", flush)
    return seen


_JAX = {}


def _jax_list(flags):
    from abpoa_tpu.cli import main as jax_main
    key = tuple(flags)
    if key not in _JAX:
        _JAX[key] = _run(jax_main, ["-l", "tests/data/list.txt", *flags,
                                    "--device", "jax", "--lockstep", "on",
                                    "--mesh", "2"])
    return _JAX[key]


@pytest.mark.parametrize("impl", ["split", "device"])
@pytest.mark.parametrize("flags", [[], ["-r", "2"]], ids=["cons", "r2"])
def test_list_mesh2_equals_jax_and_unsharded(monkeypatch, meshes, impl,
                                             flags):
    monkeypatch.chdir(ROOT)  # list.txt names its files from the root
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    argv = ["-l", "tests/data/list.txt", *flags, "--device", "cpu",
            "--lockstep", "on"]
    sharded = _run(cli.main, argv + ["--mesh", "2"])
    assert meshes and all(m == (CPU, CPU) for m in meshes)
    meshes.clear()
    plain = _run(cli.main, argv)
    assert meshes and all(m is None for m in meshes)
    want = _jax_list(flags)
    assert sharded[:2] == plain[:2] == want[:2]
    assert sharded[0] == 0 and sharded[1]


def test_map_mesh2_equals_jax_and_unsharded():
    from abpoa_tpu.cli import main as jax_main
    argv = ["map", "-g", os.path.join(DATA_DIR, "seq10.gfa"),
            os.path.join(DATA_DIR, "seq4.fa")]
    sharded = _run(cli.main, argv + ["--device", "cpu", "--mesh", "2",
                                     "-V", "1"])
    plain = _run(cli.main, argv + ["--device", "cpu"])
    want = _run(jax_main, argv + ["--device", "jax", "--mesh", "2", "-V", "1"])
    assert sharded[:2] == plain[:2] == want[:2] and sharded[0] == 0
    line = ("route sharded: sharded map K=16 over mesh=2 "
            "(2 x per-chip k_cap 8)")
    assert line in sharded[2] and line in want[2]


@pytest.mark.parametrize("sub", [[], ["map"]], ids=["consensus", "map"])
def test_negative_mesh_is_an_error(sub):
    argv = ([*sub, "-g", os.path.join(DATA_DIR, "seq10.gfa")] if sub else [])
    argv += [os.path.join(DATA_DIR, "seq4.fa"), "--device", "cpu",
             "--mesh", "-1"]
    rc, out, err = _run(cli.main, argv)
    assert rc == 1 and out == "" and "--mesh must be >= 0" in err
