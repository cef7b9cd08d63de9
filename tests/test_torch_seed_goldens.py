"""The seeded goldens and the per-read configurations that B2's linear and
affine instantiations lift, on the CPU, byte for byte (tolerance 0).

- `seq.fa -S -p`, `rcmix.fa -s -S -n 200` and `rcmix.fa -s -S -p -n 200`
  through the port's CLI reproduce tests/golden/seq_Sp.txt, rcmix_sS.txt
  and rcmix_sSp.txt (the seeded route: B2's plain version batched over
  each read's windows), with B1 never launched;
- `-i` with read ids in linear gaps (`-r 1 -O 0`), `-Q -d 2` in affine
  gaps (`-O 4`) and the Python API in linear gaps equal the JAX package's
  output: the per-read route, which refused them before.
"""
import os

import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as tfl

from test_torch_fused_route import _port_cli
from test_torch_list_pyapi import _pair, _same, _seqs
from test_torch_pipeline import _jax_cli

torch.set_num_threads(1)


def _path(fn):
    return os.path.join(DATA_DIR, fn)


@pytest.mark.parametrize("fa,flags,golden", [
    ("seq.fa", ["-S", "-p"], "seq_Sp.txt"),
    ("rcmix.fa", ["-s", "-S", "-n", "200"], "rcmix_sS.txt"),
    ("rcmix.fa", ["-s", "-S", "-p", "-n", "200"], "rcmix_sSp.txt"),
])
def test_seeded_cli_reproduces_golden(fa, flags, golden):
    tfl.reset_stats()
    calls = banded.stats["reads"]
    out = _port_cli([_path(fa), *flags, "--device", "cpu"])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert out == fp.read()
    assert tfl.stats["reads"] == 0
    assert banded.stats["reads"] - calls >= 7  # every read after the first


@pytest.mark.parametrize("args", [
    ["seq4.fa", "-i", "seq10.gfa", "-r", "1", "-O", "0"],
    ["heter.fq", "-Q", "-d", "2", "-O", "4"],
])
def test_lifted_per_read_configs_equal_jax_cli(args):
    argv = [_path(a) if "." in a else a for a in args]
    tfl.reset_stats()
    calls = banded.stats["reads"]
    assert _port_cli(argv + ["--device", "cpu"]) == _jax_cli(argv)
    assert tfl.stats["reads"] == 0 and banded.stats["reads"] > calls


def test_pyapi_linear_gaps_equal_jax():
    a, b = _pair(gap_open1=0)
    calls = banded.stats["reads"]
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=True)
    assert banded.stats["reads"] - calls == 9
    _same(res, b.msa(_seqs("seq.fa"), out_cons=True, out_msa=True))
