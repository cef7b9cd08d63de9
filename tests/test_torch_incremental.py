"""Incremental alignment (`-i`) and qv-weighted clustering (`-Q -d > 1`)
through the port's CLI on the CPU.

- `seq4.fa -i seq10.gfa`, `seq4.fa -i seq10.msa` and `heter.fq -d 2 -Q`
  reproduce tests/golden byte for byte;
- `-i` equals the JAX CLI with read-id outputs (`-r 1`, `-r 3`, `-a 1`,
  `-d 2`: the per-read route, kernel B2's plain version) and without them
  (`-s`, `-m 1`, `-m 2`, `-O 0`: the fused loop from the restored state),
  and with one new read (the per-read route);
- the per-read route in local and extend mode (`-i -r 1 -m 1`, `-i -d 2
  -m 2`, `-Q -d 2 -m 1`, one new read with `-i -m 2`, and `-l` with `-i
  -m 2` whose second set holds one read) equals the JAX CLI;
- with `-s` on the fused route the new reads' strand flags land on their
  own slots, after the restored reads';
- the qv-weighted graph of `-Q -d 2`, per-read weights included, equals
  the JAX host route's.
"""
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch import cli, convert
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file

from test_torch_fused_route import _port_cli
from test_torch_pipeline import _jax_cli

torch.set_num_threads(1)


def _path(fn):
    return os.path.join(DATA_DIR, fn)


def _routes(args):
    """The port CLI's output of args on the CPU, with the reads the fused
    loop attempted and the reads B2 aligned."""
    tfl.reset_stats()
    b2 = banded.stats["reads"]
    out = _port_cli(args + ["--device", "cpu"])
    return out, tfl.stats["reads"], banded.stats["reads"] - b2


@pytest.mark.parametrize("args,golden,route", [
    (["seq4.fa", "-i", "seq10.gfa"], "incr_gfa.txt", "fused"),
    (["seq4.fa", "-i", "seq10.msa"], "incr_msa.txt", "fused"),
    (["heter.fq", "-d", "2", "-Q"], "heterq_d2Q.txt", "per-read"),
])
def test_cli_reproduces_golden(args, golden, route):
    out, fused, b2 = _routes([_path(a) if "." in a else a for a in args])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert out == fp.read()
    assert (fused > 0, b2 > 0) == (route == "fused", route == "per-read")


@pytest.mark.parametrize("restore,flags,route", [
    ("seq10.gfa", ["-r", "1"], "per-read"),
    ("seq10.msa", ["-r", "3"], "per-read"),
    ("seq10.gfa", ["-a", "1"], "per-read"),
    ("seq10.msa", ["-d", "2"], "per-read"),
    ("seq10.gfa", ["-s"], "fused"),
    ("seq10.msa", ["-m", "1"], "fused"),
    ("seq10.gfa", ["-m", "2"], "fused"),
    ("seq10.msa", ["-O", "0"], "fused"),
])
def test_incremental_matches_jax_cli(restore, flags, route):
    args = [_path("seq4.fa"), "-i", _path(restore), *flags]
    out, fused, b2 = _routes(args)
    assert out == _jax_cli(args)
    # the fused loop aligns both new reads onto the restored graph
    assert (fused, b2) == ((2, 0) if route == "fused" else (0, 2))


@pytest.mark.parametrize("flags", [[], ["-r", "1"]])
def test_one_read_onto_a_restored_graph_matches_jax_cli(tmp_path, flags):
    path = tmp_path / "one.fa"
    rec = read_fastx(_path("seq4.fa"))[1]
    path.write_text(f">{rec.name}\n{rec.seq}\n")
    args = [str(path), "-i", _path("seq10.gfa"), *flags]
    out, fused, b2 = _routes(args)
    assert out == _jax_cli(args)
    assert (fused, b2) == (0, 1)


@pytest.mark.parametrize("args", [
    ["seq4.fa", "-i", "seq10.gfa", "-r", "1", "-m", "1"],
    ["seq4.fa", "-i", "seq10.msa", "-d", "2", "-m", "2"],
    ["heter.fq", "-Q", "-d", "2", "-m", "1"],
])
def test_per_read_configs_outside_b2_raise(args):
    """Once refused (B2 aligned in global mode only): the per-read route
    in local and extend mode now equals the JAX CLI, with B2 and no B1."""
    argv = [_path(a) if "." in a else a for a in args]
    out, fused, b2 = _routes(argv)
    assert out == _jax_cli(argv)
    assert fused == 0 and b2 > 0


def test_one_read_outside_b2_raises_before_output(tmp_path, capsys):
    """One new read onto a restored graph in extend mode (B2, once
    refused) equals the JAX CLI; with two reads the fused loop takes the
    same configuration."""
    path = tmp_path / "one.fa"
    path.write_text(">r\nCGTCAATCTATCGAAGCATACGCGGCAGAGCCGAAGACC\n")
    argv = [str(path), "-i", _path("seq10.gfa"), "-m", "2"]
    out, fused, b2 = _routes(argv)
    assert out == _jax_cli(argv) and (fused, b2) == (0, 1)
    path.write_text(">r\nCGTCAATCTATCGAAGCATACG\n>s\nCGTCAATCTATCGAAGCATACG\n")
    assert cli.main(argv + ["--device", "cpu"]) == 0


def test_list_with_incremental_outside_b2_raises_before_output(tmp_path, capsys):
    """`-l` with `-i -m 2` (once refused: a set may hold one read, which
    only B2 aligns) equals the JAX CLI, the one-read set included."""
    from test_torch_list_pyapi import _jax_main, _port_main
    one = tmp_path / "one.fa"
    one.write_text(">r\nCGTCAATCTATCGAAGCATACGCGGCAGAGCCGAAGACC\n")
    lst = tmp_path / "list.txt"
    lst.write_text(f"{_path('seq4.fa')}\n{one}\n")
    argv = [str(lst), "-l", "-i", _path("seq10.gfa"), "-m", "2"]
    b2 = banded.stats["reads"]
    got = _port_main(argv)
    assert got[0] == 0 and got[:2] == _jax_main(argv)[:2]
    assert banded.stats["reads"] - b2 == 1  # the one-read set
    # with read ids in global mode the same list runs, set by set
    argv = [str(lst), "-l", "-i", _path("seq10.gfa"), "-r", "1", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.count(">") > 0


def _with_jax(args):
    """(port Abpoa, its output, JAX Abpoa, its output) of a CLI run of args,
    the port on the CPU, the JAX package on its numpy host route."""
    from abpoa_tpu.cli import args_to_params as jax_params
    from abpoa_tpu.cli import build_parser as jax_parser
    from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
    from abpoa_tpu.pipeline import msa_from_file as jax_msa
    ab, buf = Abpoa(), io.StringIO()
    ns = cli.build_parser().parse_args(args + ["--device", "cpu"])
    msa_from_file(ab, cli.args_to_params(ns).finalize(), ns.input, buf)
    jab, jbuf = JaxAbpoa(), io.StringIO()
    jns = jax_parser().parse_args(args + ["--device", "numpy"])
    jax_msa(jab, jax_params(jns).finalize(), jns.input, jbuf)
    return ab, buf.getvalue(), jab, jbuf.getvalue()


def test_strand_flags_of_new_reads_follow_the_restored_reads(tmp_path):
    """Both new reads come reversed: the fused loop flags them, at slots
    10 and 11, as the JAX host route does; the restored reads' flags stay."""
    comp = str.maketrans("ACGT", "TGCA")
    path = tmp_path / "rc.fa"
    path.write_text("".join(f">{r.name}\n{r.seq.translate(comp)[::-1]}\n"
                            for r in read_fastx(_path("seq4.fa"))))
    tfl.reset_stats()
    ab, out, jab, jout = _with_jax([str(path), "-i", _path("seq10.gfa"), "-s"])
    assert tfl.stats["rc_reads"] == 2
    assert ab.is_rc == jab.is_rc == [False] * 10 + [True, True]
    assert out == jout


def test_qv_weighted_graph_matches_jax_host_route():
    """heter.fq -d 2 -Q: the per-read route's graph, per-read qv weights
    included, equals the JAX host route's, and survives `convert`."""
    ab, out, jab, jout = _with_jax([_path("heter.fq"), "-d", "2", "-Q"])
    got, want = convert.graph_to_numpy(ab.graph), convert.graph_to_numpy(jab.graph)
    assert got["read_weight_w"].size > 0 and got["read_weight_w"].max() > 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert.graph_to_numpy(convert.graph_from_numpy(got))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    assert out == jout
