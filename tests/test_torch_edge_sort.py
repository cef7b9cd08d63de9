"""Kernels S1 (the per-read edge sort) and K1 (the Kahn repair) against the
JAX package, on graphs made to hit their traps.

- S1: `edge_sort` on CPU tensors (its plain version `edge_sort_torch`)
  equals JAX `fused_loop._edge_sort` on graphs of the fused loop and on
  numpy-seeded slot rows with many equal weights and full rows
  (`chip_smoke.tie_graph`), E = 8, 16, 32;
- K1: `topo_sort_torch` equals JAX `device_graph.topo_sort` on the
  adversarial graphs of `chip_smoke.k1_graph`: unsorted slots that pass 1
  must not sort, a group member that is a later out slot of the same node, a
  node queued twice (the queue passes N), a cycle (ok = 0), a 40-slot hub,
  groups that lie past 4096 words into a node's record, and a random DAG
  with aligned neighbours;
- the fused loop runs S1 once per read attempt that reaches the fusion;
- K1's launch shapes (degree variant and record cache) fit the card's
  shared memory;
Every comparison is exact. The CUDA kernels are held against their plain
versions on the same graphs in test_torch_sort_twins.py, which imports no
JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import abpoa_tpu.align.device_graph as jdg
import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.edge_sort_kernel import edge_sort, edge_sort_torch
from abpoa_tpu_torch.align.topo_kernel import (SMEM_MAX, launch_shape,
                                               topo_sort_torch)

import chip_smoke
from test_torch_cuda_twins import aligned_read, make_params, port_state
from test_torch_sort_twins import TIE_E, tensors

torch.set_num_threads(1)

SLOTS = ("in_ids", "in_w", "out_ids", "out_w")
K1_OUT = SLOTS + ("i2n", "n2i", "remain", "ok")


def jax_graph(arrays):
    """A JAX DeviceGraph holding K1's input arrays (zeros elsewhere)."""
    in_ids, in_w, out_ids, out_w, in_cnt, out_cnt = arrays[:6]
    N, A = in_ids.shape[0], 2
    aligned, aligned_cnt, node_n = (arrays[6:9] if len(arrays) > 6 else
                                    (np.zeros((N, A), np.int32),
                                     np.zeros(N, np.int32), [N]))
    z = jnp.zeros(N, jnp.int32)
    return jdg.DeviceGraph(
        base=z, in_ids=jnp.asarray(in_ids), in_w=jnp.asarray(in_w),
        in_cnt=jnp.asarray(in_cnt), out_ids=jnp.asarray(out_ids),
        out_w=jnp.asarray(out_w), out_cnt=jnp.asarray(out_cnt),
        aligned=jnp.asarray(aligned), aligned_cnt=jnp.asarray(aligned_cnt),
        n_read=z, n_span=z, node_n=jnp.int32(int(node_n[0])),
        ok=jnp.bool_(True))


def graph_arrays(g):
    """K1's inputs of a port DeviceGraph, as numpy arrays."""
    return [t.numpy() for t in (g.in_ids, g.in_w, g.out_ids, g.out_w,
                                g.in_cnt, g.out_cnt, g.aligned,
                                g.aligned_cnt, g.node_n.reshape(1))]


@pytest.fixture(scope="module")
def loop_graphs():
    """name -> K1 input arrays of graphs the fused loop makes: one straight
    out of the fusion (before its edge sort) and a mid-run graph with
    aligned groups."""
    abpt, st, run, k, fwd = aligned_read("seq.fa", 6)
    g = tfl._fuse_vectorized(st.g, *fwd[:3], run.seqs[k], run.lens[k],
                             run.wgts[k])[0]
    heter = port_state("heter.fa", 8, make_params())[0].g
    return {"seq-fused-unsorted": graph_arrays(g),
            "heter-sorted": graph_arrays(heter)}


# ---- S1 ----------------------------------------------------------------------

def _check_sort(arrays):
    got = edge_sort(*tensors(arrays[:6]))
    want = jfl._edge_sort(jax_graph(arrays))
    for name, t in zip(SLOTS, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("E", TIE_E)
def test_edge_sort_matches_jax_on_ties(E):
    arrays = chip_smoke.tie_graph(E)
    got = _check_sort(arrays)
    in_cnt = arrays[4]
    # the graph has what it is for: full rows, tied weights inside a row's
    # count, rows the sort reorders, and rows past node_n copied unchanged
    full = np.nonzero(in_cnt == E)[0]
    assert full.size >= 5
    w = arrays[1][full[0]]
    assert len(set(w.tolist())) < E
    assert not np.array_equal(got[1].numpy(), arrays[1])
    np.testing.assert_array_equal(got[0].numpy()[80:], arrays[0][80:])


@pytest.mark.parametrize("name", ["seq-fused-unsorted", "heter-sorted"])
def test_edge_sort_matches_jax_on_loop_graphs(name, loop_graphs):
    _check_sort(loop_graphs[name])


def test_edge_sort_checks_inputs():
    arrays = tensors(chip_smoke.tie_graph(8)[:6])
    with pytest.raises(TypeError):
        edge_sort(arrays[0].long(), *arrays[1:])
    with pytest.raises(ValueError):
        edge_sort(arrays[0].t(), *arrays[1:])
    with pytest.raises(ValueError):
        edge_sort(*arrays[:4], arrays[4][:-1], arrays[5])
    with pytest.raises(ValueError, match="unsupported device"):
        edge_sort(*[t.to("meta") for t in arrays])


def test_fused_loop_sorts_once_per_attempt(monkeypatch):
    calls = []

    def counting(*args):
        calls.append(1)
        return edge_sort_torch(*args)

    monkeypatch.setattr(tfl, "edge_sort", counting)
    abpt = make_params()
    tfl.reset_stats()
    port_state("heter.fa", 8, abpt)
    s = tfl.stats
    assert s["reads"] > 0
    assert len(calls) == s["reads"] - s["host_errs"] + s["collisions"]


# ---- K1 ----------------------------------------------------------------------

def _check_topo(arrays):
    got = topo_sort_torch(*tensors(arrays))
    gs, i2n, n2i, remain, ok = jdg.topo_sort(jax_graph(arrays))
    want = [gs.in_ids, gs.in_w, gs.out_ids, gs.out_w, i2n, n2i, remain]
    for name, a, b in zip(K1_OUT, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got[7][0]) == int(ok)
    return got


@pytest.mark.parametrize("kind", chip_smoke.K1_GRAPHS)
def test_topo_sort_matches_jax_on_adversarial_graphs(kind):
    arrays = chip_smoke.k1_graph(kind)
    got = _check_topo(arrays)
    i2n, n2i, remain, ok = (t.numpy() for t in got[4:])
    if kind == "unsorted":
        # sorting the slots before pass 1 would give another order
        pre = [t.numpy() for t in edge_sort_torch(*tensors(arrays[:6]))]
        other = topo_sort_torch(*tensors(pre + arrays[4:]))
        assert not np.array_equal(other[4].numpy(), i2n)
    elif kind == "group_later_slot":
        assert i2n[:4].tolist() == [0, 3, 2, 1]
    elif kind == "queued_twice":
        assert i2n.tolist() == [0, 2, 3, 2, 4, 5] and n2i[2] == 3
        assert ok[0] == 1 and n2i[1] == 0  # the sink never came up
    elif kind == "wide_groups":
        # every slot of the source queued its target and 100 members
        assert ok[0] == 1 and i2n[:3].tolist() == [0, 2, 66]
        assert i2n[102] == 3 and n2i[165] == 101
    elif kind == "cycle":
        assert ok[0] == 0
        # what the walks reached: the source and node 4; the sink and 4 in
        # the reverse walk, every other node keeps 0
        assert i2n.tolist()[:3] == [0, 4, 0] and n2i[4] == 1
        assert remain.tolist()[:5] == [0, -1, 0, 0, 0]
    else:
        assert ok[0] == 1
        assert int(arrays[7].max()) > 0  # aligned groups are exercised


def test_launch_shapes_fit_shared_memory():
    # the headline's final graph: int8 degrees and the largest cache
    shape = launch_shape(103424, 16, 8)
    assert (shape["variant"], shape["cache"]) == ("s8", 64)
    # int32 degrees in device memory: the same cache
    assert launch_shape(103424, 16, 8, "g32")["cache"] == 64
    # E past int8's range, and an N past int8 degrees in shared memory
    assert launch_shape(4096, 128, 8)["variant"] == "g32"
    assert launch_shape(400000, 16, 8)["variant"] == "g32"
    # the widest records the fields allow: group offsets up to 8191 words
    assert launch_shape(176, 64, 100)["cache"] == 8
    for N, E, A in ((103424, 16, 8), (4096, 128, 8), (400000, 16, 8),
                    (48, 64, 2), (176, 64, 100)):
        assert launch_shape(N, E, A)["smem"] <= SMEM_MAX
    with pytest.raises(ValueError):
        launch_shape(64, 128, 8, "s8")
    with pytest.raises(ValueError):
        launch_shape(64, 64, 128)
    with pytest.raises(ValueError):
        launch_shape(64, 128, 64)
