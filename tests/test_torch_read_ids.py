"""Read ids on the fused route, and the outputs that read them, on the CPU.

- `python -m abpoa_tpu_torch` (through `cli.main`'s parser and pipeline)
  reproduces the goldens of tests/golden byte for byte: majority vote
  (`-a 1`), the MSA (`-r 2`), the GFA (`-r 4`), two and three clustered
  consensus sequences (`-d 2`, `-d 3`) and `-d 2 -r 2`;
- the port's CLI equals the JAX package's CLI on MSA and GFA runs in every
  align mode, with `-s`, with `-d 3 -a 1`, with `-q`, and on a one-read file
  (the per-read route, which fuses the read with its id);
- the read-id bitsets of a set of more than 64 reads (several 64-bit words
  an edge) equal those of the JAX package's host route, edge for edge, and
  survive `convert`'s round trip;
- a read that collides (sequential fusion) records the path it took: with
  collisions forced on every read the MSA equals the ordinary run's and the
  JAX CLI's;
- a read attempt that fails (capacity growth, also of the first read) writes
  no path: a run grown from tiny capacities gives the ordinary MSA;
- recording the paths adds no host sync, and makes no tensor off the
  state's device.
"""
import functools
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.io.fastx import read_fastx

from test_torch_fused_route import _port_cli
from test_torch_pipeline import _jax_cli

torch.set_num_threads(1)


def _path(fa):
    return os.path.join(DATA_DIR, fa)


@pytest.mark.parametrize("fa,flags,golden", [
    ("seq.fa", ["-a", "1"], "ref_msa.txt"),
    ("seq.fa", ["-r", "2"], "seq_r2.txt"),
    ("seq.fa", ["-r", "4"], "seq_r4.txt"),
    ("heter.fa", ["-d", "2"], "ref_heter.txt"),
    ("heter.fa", ["-d", "2", "-r", "2"], "heter_d2r2.txt"),
    ("3alleles.fa", ["-d", "3"], "3alleles_d3.txt"),
])
def test_cli_read_id_outputs_reproduce_golden(fa, flags, golden):
    tfl.reset_stats()
    got = _port_cli([_path(fa), "--device", "cpu", *flags])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert got == fp.read()
    assert tfl.stats["reads"] > 0  # the fused route ran


@pytest.mark.parametrize("fa,flags", [
    ("seq.fa", ["-r", "1"]),
    ("seq.fa", ["-r", "3"]),
    ("seq.fa", ["-m", "1", "-r", "2"]),
    ("seq.fa", ["-m", "2", "-r", "2"]),
    ("rcmix.fa", ["-s", "-r", "1"]),
    ("rcmix.fa", ["-s", "-r", "4"]),
    ("3alleles.fa", ["-d", "3", "-a", "1"]),
    ("heter.fa", ["-d", "2", "-q", "0.3"]),
])
def test_cli_read_id_outputs_match_jax_cli(fa, flags):
    got = _port_cli([_path(fa), "--device", "cpu", *flags])
    assert got == _jax_cli([_path(fa), *flags])
    if "-s" in flags:  # some rows are named for their reverse strand
        assert "_reverse_complement" in got or "-\t*" in got


@pytest.mark.parametrize("r", ["1", "2"])
def test_one_read_msa_matches_jax_cli(tmp_path, r):
    """One read takes the per-read route: `add_sequence` with its read id;
    its MSA row is the read."""
    path = tmp_path / "one.fa"
    path.write_text(">only_read\nACGTACGTTAGCCATGNACGT\n")
    got = _port_cli([str(path), "--device", "cpu", "-r", r])
    assert got == _jax_cli([str(path), "-r", r])
    assert got.startswith(">only_read\nACGTACGTTAGCCATGNACGT\n")


def test_bitsets_past_64_reads_match_the_jax_host_route():
    """3alleles.fa has 126 reads: two words an edge, in the replay and in
    `convert`."""
    from abpoa_tpu.cli import args_to_params, build_parser
    from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
    from abpoa_tpu.pipeline import msa_from_file as jax_msa
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    path = _path("3alleles.fa")
    ab = Abpoa()
    ns = cli.build_parser().parse_args([path, "--device", "cpu", "-r", "1"])
    msa_from_file(ab, cli.args_to_params(ns).finalize(), path, io.StringIO())
    jab = JaxAbpoa()
    ns = build_parser().parse_args([path, "-r", "1", "--device", "numpy"])
    jax_msa(jab, args_to_params(ns).finalize(), path, io.StringIO())
    got, want = convert.graph_to_numpy(ab.graph), convert.graph_to_numpy(jab.graph)
    assert got["out_read_ids"].shape[1] == 2
    assert got["out_read_ids"][:, 1].any()  # reads 64.. are set
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert.graph_to_numpy(convert.graph_from_numpy(got))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)


def test_forced_collisions_record_the_sequential_paths(monkeypatch):
    want = _port_cli([_path("seq.fa"), "--device", "cpu", "-r", "2"])
    real = tfl._fuse_vectorized

    def colliding(*a, **k):
        out = list(real(*a, **k))
        out[4] = torch.ones((), dtype=torch.bool)
        return tuple(out)

    monkeypatch.setattr(tfl, "_fuse_vectorized", colliding)
    tfl.reset_stats()
    got = _port_cli([_path("seq.fa"), "--device", "cpu", "-r", "2"])
    assert tfl.stats["collisions"] == 9
    assert got == want == _jax_cli([_path("seq.fa"), "-r", "2"])


def test_failed_attempts_write_no_path(monkeypatch):
    """Node capacity below the first read, one edge slot and a 16-column
    band: node, edge and band growth each rerun a read."""
    want = _port_cli([_path("seq.fa"), "--device", "cpu", "-r", "1"])
    monkeypatch.setattr(tfl, "progressive_poa_fused", functools.partial(
        tfl.progressive_poa_fused, init_caps=(32, 1, 1, 16)))
    tfl.reset_stats()
    got = _port_cli([_path("seq.fa"), "--device", "cpu", "-r", "1"])
    grown = tfl.stats["grow"]
    for err in (tfl.ERR_NODE_CAP, tfl.ERR_EDGE_CAP, tfl.ERR_BAND_CAP):
        assert grown.get(err, 0) > 0, (err, grown)
    assert tfl.stats["host_errs"] > 0  # the seed read was refused once
    assert got == want


def test_path_recording_adds_no_host_sync():
    tfl.reset_stats()
    _port_cli([_path("heter.fa"), "--device", "cpu", "-r", "2"])
    s = tfl.stats
    assert s["syncs"] == s["reads"] - s["host_errs"] + s["kahn"]
    # every read's path has one node a base (no read is reverse-complemented)
    lens = [len(r.seq) for r in read_fastx(_path("heter.fa"))]
    assert tfl.last_state.path_lens.tolist() == lens


@pytest.mark.parametrize("fa,flags", [("seq.fa", ["-r", "2"]),
                                      ("rcmix.fa", ["-s", "-r", "1"])])
def test_path_buffers_stay_on_the_state_device(fa, flags):
    """As test_fused_route_keeps_tensors_on_the_state_device, with paths."""
    want = _port_cli([_path(fa), "--device", "cpu", *flags])
    torch.set_default_device("meta")
    try:
        got = _port_cli([_path(fa), "--device", "cpu", *flags])
    finally:
        torch.set_default_device(None)
    assert got == want
