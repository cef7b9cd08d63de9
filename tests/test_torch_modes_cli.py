"""B2's and X1w's remaining modes through the port's CLI and Python API on
the CPU.

- Goldens the port never held before: `-b -1` (seq_noband.txt, B2
  unbanded), `-c` and `-c -t BLOSUM62.mtx` on amino acids (aa_cons.txt,
  aa_blosum62.txt) and `-r 5` (seq_r5.txt), byte for byte;
- the flag sets of `chip_smoke.py` phase B that have no golden: `-G` in
  global, local and extend mode, `-m 2 -z 20 -b -1`, `-S -G`, `-S -b -1`,
  `-i -r 1 -m 1`, `-Q -d 2 -m 2`, each equal to the JAX CLI, on the route
  the port gives it (B2 per read or batched, and no B1);
- `-l` with `-i` in local mode, a set of one read among the list's,
  equals the JAX CLI;
- on rcmix.fa with `-m 2 -z 100` the per-read and fused routes differ, in
  the JAX package as in the port, and each route equals its JAX
  counterpart (a reference-side difference, ROADMAP.md §C).
"""
import os

import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp

from test_torch_fused_route import _port_cli
from test_torch_list_pyapi import _jax_main, _port_main
from test_torch_pipeline import _jax_cli

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _path(fn):
    return os.path.join(DATA_DIR, fn)


@pytest.mark.parametrize("fa,flags,golden", [
    ("seq.fa", ["-b", "-1"], "seq_noband.txt"),
    ("aa.fa", ["-c"], "aa_cons.txt"),
    ("aa.fa", ["-c", "-t", _path("BLOSUM62.mtx")], "aa_blosum62.txt"),
    ("seq.fa", ["-r", "5"], "seq_r5.txt"),
])
def test_cli_reproduces_golden(fa, flags, golden):
    out = _port_cli([_path(fa), *flags, "--device", "cpu"])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert out == fp.read()


# (input, flags, the route: B2 one read at a time or batched over windows)
FLAG_SETS = [
    ("seq.fa", ["-G"], "per-read"),
    ("heter.fa", ["-G", "-m", "1"], "per-read"),
    ("rcmix.fa", ["-G", "-m", "2", "-z", "20", "-O", "0"], "per-read"),
    ("rcmix.fa", ["-m", "2", "-z", "20", "-b", "-1"], "per-read"),
    ("heter.fa", ["-b", "-1", "-O", "4"], "per-read"),
    ("seq.fa", ["-S", "-G"], "seeded"),
    ("rcmix.fa", ["-S", "-b", "-1", "-n", "200"], "seeded"),
    ("seq4.fa", ["-i", _path("seq10.gfa"), "-r", "1", "-m", "1"], "per-read"),
    ("heter.fq", ["-Q", "-d", "2", "-m", "2"], "per-read"),
]


@pytest.mark.parametrize("fa,flags,route", FLAG_SETS)
def test_cli_flag_sets_match_jax_cli(fa, flags, route):
    argv = [_path(fa), *flags]
    b2, b1 = banded.stats["launches"], fused_dp.launches
    assert _port_cli(argv + ["--device", "cpu"]) == _jax_cli(argv)
    assert banded.stats["launches"] > b2 and fused_dp.launches == b1


def test_list_with_incremental_local_matches_jax_cli(tmp_path):
    """`-l` with `-i -m 1 -r 1`: every set is aligned onto the restored
    graph by B2 in local mode, the one-read set too."""
    one = tmp_path / "one.fa"
    one.write_text(">r\nCGTCAATCTATCGAAGCATACGCGGCAGAGCCGAAGACC\n")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{_path('seq4.fa')}\n{one}\n")
    argv = [str(lst), "-l", "-i", _path("seq10.gfa"), "-m", "1", "-r", "1"]
    reads = banded.stats["reads"]
    got = _port_main(argv)
    assert got[0] == 0 and got[:2] == _jax_main(argv)[:2]
    assert banded.stats["reads"] - reads == 3


def test_extend_zdrop_routes_differ_as_in_jax(tmp_path):
    """A reference-side difference (ROADMAP.md §C): on rcmix.fa's reads
    (both strands) with `-m 2 -z 100`, the per-read route and the fused
    route give different outputs in the JAX package (its host engine and
    its fused loop), and the port's two routes differ the same way: each
    equals its JAX counterpart."""
    import io
    from abpoa_tpu.cli import args_to_params, build_parser
    from abpoa_tpu.pipeline import Abpoa, msa_from_file
    argv = [_path("rcmix.fa"), "-m", "2", "-z", "100"]
    buf = io.StringIO()
    ns = build_parser().parse_args(argv + ["--device", "jax"])
    msa_from_file(Abpoa(), args_to_params(ns).finalize(), ns.input, buf)
    jax_fused, jax_host = buf.getvalue(), _jax_cli(argv)
    assert jax_fused != jax_host
    assert _port_cli(argv + ["--device", "cpu"]) == jax_fused  # fused route
    # the same reads through the port's per-read route (as -Q -d 2 or a
    # restored graph would send them)
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.pipeline import (Abpoa as PortAbpoa, _ingest_records,
                                          _select_graph, output, poa,
                                          want_native)
    abpt = cli.args_to_params(cli.build_parser().parse_args(
        argv + ["--device", "cpu"])).finalize()
    ab = PortAbpoa()
    seqs, weights = _ingest_records(ab, abpt, read_fastx(argv[0]))
    _select_graph(ab, want_native(abpt))
    poa(ab, abpt, seqs, weights, 0)
    out = io.StringIO()
    output(ab, abpt, out)
    assert out.getvalue() == jax_host
