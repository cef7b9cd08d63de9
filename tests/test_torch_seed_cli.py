"""The port's CLI on the seeded route (`-S`, B2's plain version batched over
each read's windows on the CPU) against the JAX CLI (its numpy host route),
byte for byte (tolerance 0), on tests/data/sim2k.fa's first 4 reads.

`-S -n 200` alone and with `-O 0`, `-O 4`, `-s`, `-r 1`, `-r 3` and `-d 2`
(one window a read: at k = 19 sim2k's reads share no chained anchor), and
`-S -k 11 -w 5 -n 50` with and without `-O 4` (12-16 windows a read). The
`-p` sets are in test_torch_seed_cli_p.py.
"""
import pytest
import torch

from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as tfl

from test_torch_fused_route import _port_cli
from test_torch_pipeline import _first_reads, _jax_cli

torch.set_num_threads(1)

EXTRA = [[], ["-O", "0"], ["-O", "4"], ["-s"], ["-r", "1"], ["-r", "3"],
         ["-d", "2"]]


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def seeded_equals_jax(tmp_path, flags, n_reads=4):
    """The port CLI's output of sim2k's first reads with `flags` equals the
    JAX CLI's; returns (B2 calls, windows, fused-loop reads) of the port's
    run."""
    path = _first_reads(tmp_path, "sim2k.fa", n_reads)
    tfl.reset_stats()
    b2 = dict(banded.stats)
    got = _port_cli([path, "--device", "cpu", *flags])
    assert got == _jax_cli([path, *flags])
    assert got
    return (banded.stats["reads"] - b2["reads"],
            banded.stats["windows"] - b2["windows"], tfl.stats["reads"])


@pytest.mark.parametrize("extra", EXTRA, ids=lambda e: " ".join(e) or "plain")
def test_seeded_cli_equals_jax(tmp_path, extra):
    calls, windows, fused = seeded_equals_jax(tmp_path, ["-S", "-n", "200", *extra])
    assert (calls, windows, fused) == (3, 3, 0)  # reads 2-4, one window each


@pytest.mark.parametrize("extra", [[], ["-O", "4"]],
                         ids=lambda e: " ".join(e) or "convex")
def test_seeded_windows_cli_equals_jax(tmp_path, extra):
    calls, windows, fused = seeded_equals_jax(
        tmp_path, ["-S", "-k", "11", "-w", "5", "-n", "50", *extra])
    assert calls == 3 and windows >= 30 and fused == 0
