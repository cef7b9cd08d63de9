"""The port's CLI with the guide-tree order (`-p`) against the JAX CLI, byte
for byte (tolerance 0), on tests/data/sim2k.fa's first 4 reads:
`-S -p -n 200` alone and with `-O 0`, `-O 4`, `-s`, `-r 1`, `-r 3` and
`-d 2`, and `-p` alone (one window a read, from the source to the sink).
`-S -m 1` and `-p -m 2` take the fused route, as in the JAX package (its
`plain_route`); `seq4.fa -i seq10.gfa -S` seeds onto the restored graph.
"""
import os

import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as tfl

from test_torch_fused_route import _port_cli
from test_torch_pipeline import _jax_cli
from test_torch_seed_cli import EXTRA, seeded_equals_jax

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


@pytest.mark.parametrize("extra", EXTRA, ids=lambda e: " ".join(e) or "plain")
def test_guide_tree_cli_equals_jax(tmp_path, extra):
    calls, windows, fused = seeded_equals_jax(
        tmp_path, ["-S", "-p", "-n", "200", *extra])
    assert (calls, windows, fused) == (3, 3, 0)


def test_guide_tree_alone_equals_jax(tmp_path):
    assert seeded_equals_jax(tmp_path, ["-p"]) == (3, 3, 0)


@pytest.mark.parametrize("flags", [["-S", "-m", "1"], ["-p", "-m", "2"]])
def test_seeding_outside_global_mode_takes_the_fused_route(tmp_path, flags):
    calls, windows, fused = seeded_equals_jax(tmp_path, flags)
    assert (calls, windows, fused) == (0, 0, 4)  # the loop takes every read


def test_seeding_onto_a_restored_graph_equals_jax():
    args = [os.path.join(DATA_DIR, "seq4.fa"), "-i",
            os.path.join(DATA_DIR, "seq10.gfa"), "-S"]
    tfl.reset_stats()
    calls = banded.stats["reads"]
    assert _port_cli(args + ["--device", "cpu"]) == _jax_cli(args)
    # both new reads go onto the restored graph, one window each
    assert (banded.stats["reads"] - calls, tfl.stats["reads"]) == (2, 0)
