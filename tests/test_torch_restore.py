"""The restore of `-i` and the fused loop's start from a restored graph, on
the CPU, against the JAX package.

- `io/restore.py`'s `restore_graph` builds the graph the JAX package's
  builds from tests/data/seq10.gfa and seq10.msa, with read ids on and off:
  nodes, edges and their weights, read-id bitsets, aligned groups,
  `read_weight`, and the restored reads' names and strand flags;
- `fused_loop.state_from_host_graph` uploads it as the JAX package's
  `_state_from_host_graph` does, field by field, at the capacities both
  packages pick (`restored_caps`);
- a run from the restored state that starts at the restored graph's own
  capacities grows its nodes, edge slots, aligned slots and band, and gives
  the output of the run at the planned capacities and of the JAX CLI;
- the fused loop refuses a restored graph with read-id outputs (the
  per-read route takes those).
"""
import functools
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.io.restore import restore_graph
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.pipeline import Abpoa

from test_torch_fused_route import _port_cli
from test_torch_pipeline import _jax_cli

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _restored(fn, read_ids):
    """(port Abpoa, JAX Abpoa, port Params, JAX Params) after restoring fn."""
    from abpoa_tpu.params import Params as JaxParams
    from abpoa_tpu.io.restore import restore_graph as jax_restore
    from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
    path = os.path.join(DATA_DIR, fn)
    abpt = Params(device="cpu", incr_fn=path, out_msa=read_ids)
    jabpt = JaxParams()
    jabpt.device, jabpt.incr_fn, jabpt.out_msa = "numpy", path, read_ids
    abpt.finalize(), jabpt.finalize()
    ab, jab = Abpoa(), JaxAbpoa()
    restore_graph(ab, abpt)
    jax_restore(jab, jabpt)
    return ab, jab, abpt, jabpt


@pytest.mark.parametrize("read_ids", [False, True])
@pytest.mark.parametrize("fn", ["seq10.gfa", "seq10.msa"])
def test_restore_graph_matches_jax(fn, read_ids):
    ab, jab, abpt, _ = _restored(fn, read_ids)
    assert abpt.use_read_ids == read_ids
    got, want = convert.graph_to_numpy(ab.graph), convert.graph_to_numpy(jab.graph)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["out_read_ids"].any() == read_ids
    assert ab.graph.node_n > 80 and ab.n_seq == 10
    for attr in ("names", "comments", "quals", "seqs", "is_rc"):
        assert getattr(ab, attr) == getattr(jab, attr), attr
    assert not ab.graph.is_topological_sorted


def test_restore_of_nothing_warns_on_stdout(tmp_path, capsys):
    path = tmp_path / "empty.gfa"
    path.write_text("H\tVN:Z:1.0\n")
    ab = Abpoa()
    restore_graph(ab, Params(device="cpu", incr_fn=str(path)).finalize())
    out = capsys.readouterr()
    assert out.out == f"Warning: no graph/sequence restored from '{path}'.\n"
    assert out.err == "" and ab.graph.node_n == 2


@pytest.mark.parametrize("fn", ["seq10.gfa", "seq10.msa"])
def test_state_from_host_graph_matches_jax(fn):
    from abpoa_tpu.align import fused_loop as jfl
    ab, jab, abpt, jabpt = _restored(fn, False)
    ab.graph.topological_sort(abpt)
    jab.graph.topological_sort(jabpt)
    qmax = 120
    N, E, A = tfl.restored_caps(ab.graph, qmax)
    n0 = jab.graph.node_n
    maxdeg = max(max(len(nd.in_ids), len(nd.out_ids)) for nd in jab.graph.nodes)
    maxaln = max(len(nd.aligned_ids) for nd in jab.graph.nodes)
    assert (N, E, A) == (jfl._bucket(n0 + 2 * (qmax + 2) + 64, 1024),
                         max(8, jfl._bucket_pow2(maxdeg + 1)),
                         max(8, jfl._bucket_pow2(maxaln + 1)))
    got = convert.fused_state_to_numpy(
        tfl.state_from_host_graph(ab.graph, N, E, A, "cpu"))
    want = convert.fused_state_to_numpy(jfl._state_from_host_graph(
        jab.graph, N, E, A, n_reads=1, Pcap=8, n_rc=1))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["node_n"] == n0 and got["remain"][:n0].any()


def test_state_of_a_graph_sorted_without_band_metadata():
    """Local mode sorts without max_remain; the upload computes it, equal to
    what a banded sort gives."""
    ab, _, abpt, _ = _restored("seq10.msa", False)
    g = ab.graph
    g.topological_sort(Params(device="cpu", align_mode=1).finalize())
    assert len(g.node_id_to_max_remain) == 0
    st = tfl.state_from_host_graph(g, 1024, 8, 8, "cpu")
    g.topological_sort(abpt)
    n = g.node_n
    np.testing.assert_array_equal(st.remain[:n].numpy(),
                                  g.node_id_to_max_remain[:n])


def test_growth_from_a_restored_state(monkeypatch):
    """heter.fa's reads onto seq10.msa's graph, from a node capacity two
    above it, edge and aligned slots as many as its largest degree and
    group and a 16-column band: every capacity grows from the restored
    state."""
    fa = os.path.join(DATA_DIR, "heter.fa")
    args = [fa, "-i", os.path.join(DATA_DIR, "seq10.msa"), "--device", "cpu"]
    tfl.reset_stats()
    want = _port_cli(args)
    ab, _, abpt, _ = _restored("seq10.msa", False)
    g = ab.graph
    g.topological_sort(abpt)
    maxdeg = max(max(len(nd.in_ids), len(nd.out_ids)) for nd in g.nodes)
    maxaln = max(len(nd.aligned_ids) for nd in g.nodes)
    monkeypatch.setattr(tfl, "progressive_poa_fused", functools.partial(
        tfl.progressive_poa_fused,
        init_caps=(g.node_n + 2, maxdeg, maxaln, 16)))
    tfl.reset_stats()
    got = _port_cli(args)
    grown = tfl.stats["grow"]
    for err in (tfl.ERR_NODE_CAP, tfl.ERR_EDGE_CAP, tfl.ERR_ALIGN_CAP,
                tfl.ERR_BAND_CAP):
        assert grown.get(err, 0) > 0, (err, grown)
    assert tfl.stats["upload_s"] > 0
    assert got == want == _jax_cli(args[:3])


def test_fused_loop_refuses_a_restored_graph_with_read_ids():
    ab, _, _, _ = _restored("seq10.gfa", True)
    abpt = Params(device="cpu", out_msa=True).finalize()
    seqs = [np.array([0, 1, 2, 3], np.uint8)] * 2
    with pytest.raises(RuntimeError, match="per-read route"):
        tfl.progressive_poa_fused(seqs, [np.ones(4, np.int64)] * 2, abpt,
                                  init_graph=ab.graph)
