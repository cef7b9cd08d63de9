"""The port's fused route from the entry points, on the CPU.

- `python -m abpoa_tpu_torch` (through `cli.main`) reproduces the goldens of
  tests/golden byte for byte on the fused route: the default, affine
  (`-O 4`), linear (`-O 0`), local (`-m 1`) and extend (`-m 2`) consensus,
  and equals the JAX package's CLI for `-m 2 -z 50`;
- a run started from tiny capacities grows through every error code a
  fixture can reach (node, edge, aligned-group and band capacity) and ends
  with the graph of an ordinary run, also when the first read does not fit;
- the collision path (sequential fusion, then the Kahn repair) gives the
  graph of the vectorised path when it is forced on every read;
- a diverged backtrack raises instead of falling back;
- every tensor the loop makes stays on the state's device (checked with
  `meta` as the default device, so a tensor made without a device cannot
  meet one made with it);
- one host sync per read, plus one per Kahn repair and per `-s` check;
- the per-read route (`pipeline.poa`, kernel B2) stays reachable and gives
  the fused route's consensus.
"""
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.banded_kernel import banded_dp
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.pipeline import Abpoa, _ingest_records, output, poa

from test_torch_fused_loop import _reads


# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)


def _port_cli(args):
    buf = io.StringIO()
    ns = cli.build_parser().parse_args(args)
    abpt = cli.args_to_params(ns).finalize()
    from abpoa_tpu_torch.pipeline import msa_from_file
    msa_from_file(Abpoa(), abpt, ns.input, buf)
    return buf.getvalue()


@pytest.mark.parametrize("flags,golden", [
    ([], "ref_consensus.txt"),
    (["-O", "4"], "seq_affine.txt"),
    (["-O", "0"], "seq_linear.txt"),
    (["-m", "1"], "seq_m1.txt"),
    (["-m", "2"], "seq_m2.txt"),
])
def test_cli_fused_route_reproduces_golden(flags, golden):
    tfl.reset_stats()
    got = _port_cli([os.path.join(DATA_DIR, "seq.fa"), "--device", "cpu", *flags])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert got == fp.read()
    assert tfl.stats["reads"] == 9  # the fused route ran every read but the first


def test_cli_extend_zdrop_matches_jax_cli():
    from abpoa_tpu.cli import args_to_params, build_parser
    from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
    from abpoa_tpu.pipeline import msa_from_file as jax_msa
    path = os.path.join(DATA_DIR, "seq.fa")
    buf = io.StringIO()
    ns = build_parser().parse_args([path, "-m", "2", "-z", "50", "--device", "numpy"])
    jax_msa(JaxAbpoa(), args_to_params(ns).finalize(), ns.input, buf)
    assert _port_cli([path, "--device", "cpu", "-m", "2", "-z", "50"]) == buf.getvalue()


def _run(fa, n=None, init_caps=None, **kw):
    abpt = Params(device="cpu")
    for k, v in kw.items():
        setattr(abpt, k, v)
    abpt.finalize()
    seqs, w = _reads(fa, abpt)
    if n:
        seqs, w = seqs[:n], w[:n]
    tfl.reset_stats()
    pg, _, _ = tfl.progressive_poa_fused(seqs, w, abpt, init_caps=init_caps)
    return convert.graph_to_numpy(pg), tfl.last_state


def test_tiny_capacities_grow_to_the_same_graph():
    want, _ = _run("sim2k.fa", 4)
    got, st = _run("sim2k.fa", 4, init_caps=(2048, 1, 1, 16))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    grown = tfl.stats["grow"]
    for err in (tfl.ERR_NODE_CAP, tfl.ERR_EDGE_CAP, tfl.ERR_ALIGN_CAP,
                tfl.ERR_BAND_CAP):
        assert grown.get(err, 0) > 0, (err, grown)


def test_first_read_past_node_capacity_grows():
    """A node capacity below the first read's chain is a node-capacity
    error like any other: the seed is not committed, N grows, the run
    resumes and ends with the ordinary graph."""
    want, _ = _run("seq.fa")
    got, st = _run("seq.fa", init_caps=(32, 8, 8, 128))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tfl.stats["grow"].get(tfl.ERR_NODE_CAP, 0) > 0
    assert st.g.caps[0] > 32


def test_forced_collision_path_gives_the_same_graph(monkeypatch):
    want, st0 = _run("seq.fa")
    real = tfl._fuse_vectorized

    def colliding(*a, **k):
        out = list(real(*a, **k))
        out[4] = torch.ones((), dtype=torch.bool)
        return tuple(out)

    monkeypatch.setattr(tfl, "_fuse_vectorized", colliding)
    got, st = _run("seq.fa")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert st.collisions == st.kahn_runs == 9
    assert st0.collisions == 0


def test_diverged_backtrack_raises(monkeypatch):
    real = tfl.backtrack

    def failing(*a, **k):
        ops, res = real(*a, **k)
        res = res.clone()
        res[5] = 1
        return ops, res

    monkeypatch.setattr(tfl, "backtrack", failing)
    with pytest.raises(RuntimeError, match="backtrack"):
        _run("seq.fa")


@pytest.mark.parametrize("fa,flags", [
    ("rcmix.fa", ["-s"]), ("seq.fa", []), ("seq.fa", ["-m", "1"]),
    ("seq.fa", ["-m", "2", "-z", "20"]), ("seq.fa", ["-O", "0"]),
    ("seq.fa", ["-O", "4"])])
def test_fused_route_keeps_tensors_on_the_state_device(fa, flags):
    """With `meta` as the default device, a tensor made without an explicit
    device lands on meta and any op mixing it with the state's CPU tensors
    fails; the run must still match the ordinary one."""
    path = os.path.join(DATA_DIR, fa)
    want = _port_cli([path, "--device", "cpu", *flags])
    torch.set_default_device("meta")
    try:
        got = _port_cli([path, "--device", "cpu", *flags])
    finally:
        torch.set_default_device(None)
    assert got == want


def test_growth_keeps_tensors_on_the_state_device():
    """The same check through every capacity growth."""
    want, _ = _run("sim2k.fa", 4)
    torch.set_default_device("meta")
    try:
        got, _ = _run("sim2k.fa", 4, init_caps=(2048, 1, 1, 16))
    finally:
        torch.set_default_device(None)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_one_host_sync_per_read():
    _, st = _run("rcmix.fa", amb_strand=True)
    s = tfl.stats
    on_card = s["reads"] - s["host_errs"]
    assert on_card >= 7 and s["rc_reads"] > 0
    # the flags, the Kahn repairs' ok, and the -s threshold of every read
    assert s["syncs"] == on_card + s["kahn"] + on_card
    _, st = _run("heter.fa", 8, init_caps=(640, 8, 8, 128))
    s = tfl.stats
    assert s["host_errs"] > 0
    assert s["syncs"] == s["reads"] - s["host_errs"] + s["kahn"]


def test_per_read_route_stays_reachable():
    """`pipeline.poa` (kernel B2, host fusion) gives the fused route's
    consensus on the first 6 reads of sim2k."""
    recs = read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))[:6]
    abpt = Params(device="cpu").finalize()
    outs = []
    for route in ("per-read", "fused"):
        ab = Abpoa()
        seqs, weights = _ingest_records(ab, abpt, recs)
        launches = banded_dp.launches
        if route == "per-read":
            poa(ab, abpt, seqs, weights, 0)
            assert banded_dp.launches == launches  # plain version on the CPU
        else:
            from abpoa_tpu_torch.pipeline import _run_fused_device
            _run_fused_device(ab, abpt, seqs, weights)
        buf = io.StringIO()
        output(ab, abpt, buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0]) > 1900
