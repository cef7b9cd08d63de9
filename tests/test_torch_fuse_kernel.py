"""Kernel F1, the sequential fusion of a colliding read
(`align/fuse_kernel.py` `fuse_alignment_lanes`), through its plain version
on the CPU, against the JAX package's `device_graph.fuse_alignment` on the
same graph and op stream: every graph array, ok and node_n, exactly, and
the node path against the vectorised fusion's where both apply:
- a real read's op stream onto heter.fa's graph after 8 reads;
- two mismatch columns onto two members of one aligned group (the
  collision the fused loop sends to F1);
- the capacity exits: ok false where the stream passes N (the second new
  node), E (an edge appended to a node whose slots are full) or A (a new
  member of a full aligned group), with N, E or A cut to the graph's own
  size;
- several lanes in one call, on a lane list, the others untouched, and the
  state's graph never written (the wrapper fuses into a copy).
The card twin is in test_torch_cuda_twins.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import abpoa_tpu.align.device_graph as jdg
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align.device_graph import DeviceGraph
from abpoa_tpu_torch.align.fuse_kernel import (fuse_alignment_lanes,
                                               lane_graph)
from abpoa_tpu_torch.align import fused_loop as tfl

from test_torch_cuda_twins import aligned_read
from test_torch_fused_steps import assert_graph_equal, jax_graph, t2j

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def read_case():
    return aligned_read("heter.fa", 8)


def _stack(g):
    return DeviceGraph(**{k: v[None].contiguous() for k, v in g.tensors().items()})


def _cut(g, N=None, E=None, A=None):
    """g with its capacities cut: N rows, E slots, A aligned slots (each
    at least what the graph holds)."""
    N = N or g.caps[0]
    E = E or g.caps[1]
    A = A or g.caps[2]
    kw = {}
    for k, v in g.tensors().items():
        if v.dim() == 0:
            kw[k] = v.clone()
        elif v.dim() == 1:
            kw[k] = v[:N].clone()
        else:
            kw[k] = v[:N, :(A if k == "aligned" else E)].clone()
    return DeviceGraph(**kw)


def _collision_stream(st):
    cnt = st.g.aligned_cnt.numpy()
    a = int(np.flatnonzero(cnt == cnt.max())[0])
    b = int(st.g.aligned[a, 0])
    bases = {int(st.g.base[x]) for x in [a] + st.g.aligned[a, :cnt[a]].tolist()}
    other = min(set(range(4)) - bases)
    T = 16
    fwd_op = torch.full((T,), 2, dtype=torch.int32)
    fwd_op[:2] = 0
    fwd_arg = torch.zeros(T, dtype=torch.int32)
    fwd_arg[0], fwd_arg[1] = a, b
    q = torch.full((T,), other, dtype=torch.int32)
    w = torch.ones(T, dtype=torch.int32)
    return fwd_op, fwd_arg, 2, q, 2, w


def _check(g, fwd_op, fwd_arg, n_fwd, q, qlen, w):
    """F1 (L = 1) == JAX's fuse_alignment; returns (graph, path)."""
    T = fwd_op.shape[0]
    got, path, plen = fuse_alignment_lanes(
        _stack(g), fwd_op[None], fwd_arg[None],
        torch.tensor([n_fwd], dtype=torch.int32), q[None], w[None],
        torch.tensor([qlen], dtype=torch.int32), q.shape[0] + 2)
    ops = torch.stack([fwd_op, fwd_arg], 1)
    ops[n_fwd:] = 0
    want = jdg.fuse_alignment(jax_graph(g), t2j(ops), jnp.int32(n_fwd),
                              t2j(q), jnp.int32(qlen), t2j(w),
                              C.SRC_NODE_ID, C.SINK_NODE_ID, max_ops=T)
    out = lane_graph(got, 0)
    assert_graph_equal(out, want)
    return out, path[0, :int(plen[0])].tolist()


def test_read_stream_matches_jax(read_case):
    abpt, st, run, k, fwd = read_case
    fwd_op, fwd_arg, n_fwd = fwd[:3]
    q, qlen, w = run.seqs[k], run.lens[k], run.wgts[k]
    before = {key: v.clone() for key, v in st.g.tensors().items()}
    out, path = _check(st.g, fwd_op, fwd_arg, int(n_fwd), q, qlen, w)
    vec = tfl._fuse_vectorized(st.g, fwd_op, fwd_arg, n_fwd, q, qlen, w)
    assert path == vec[1][:qlen].tolist() and len(path) == int(vec[2])
    assert bool(out.ok)
    for key, v in st.g.tensors().items():  # fused into a copy
        assert torch.equal(v, before[key]), key


def test_collision_stream_matches_jax(read_case):
    st = read_case[1]
    out, path = _check(st.g, *_collision_stream(st))
    assert int(out.node_n) == int(st.g.node_n) + 1
    assert path == [int(st.g.node_n)] * 2


def test_node_cap_exit_matches_jax(read_case):
    """N = node_n + 1: the second inserted node does not fit; the walk goes
    on past N, its reads of the rows past N clamped and its writes there
    dropped, as JAX's, and adds the sink edge from the last node."""
    abpt, st, run, k, fwd = read_case
    g = _cut(st.g, N=int(st.g.node_n) + 1)
    T = 8
    fwd_op = torch.full((T,), 2, dtype=torch.int32)
    q, w = run.seqs[k][:T].contiguous(), run.wgts[k][:T].contiguous()
    out, path = _check(g, fwd_op, torch.zeros(T, dtype=torch.int32), 4, q, 4, w)
    n0 = int(st.g.node_n)
    assert not bool(out.ok) and int(out.node_n) == n0 + 4
    assert path == [n0, n0 + 1, n0 + 2, n0 + 3]
    assert int(out.in_cnt[C.SINK_NODE_ID]) == int(st.g.in_cnt[C.SINK_NODE_ID]) + 1


def test_edge_cap_exit_matches_jax(read_case):
    """E cut to the graph's widest row: an insertion from that row's node
    appends an out edge to full slots."""
    abpt, st, run, k, fwd = read_case
    n = int(st.g.node_n)
    deg = torch.maximum(st.g.out_cnt[:n], st.g.in_cnt[:n])
    E = int(deg.max())
    g = _cut(st.g, E=E)
    v = int(torch.nonzero(st.g.out_cnt[:n] == E)[0, 0])
    T = 4
    fwd_op = torch.tensor([0, 2, 2, 2], dtype=torch.int32)
    fwd_arg = torch.tensor([v, 0, 0, 0], dtype=torch.int32)
    q = torch.full((T,), int(st.g.base[v]), dtype=torch.int32)
    out, _ = _check(g, fwd_op, fwd_arg, 2, q, 2, torch.ones(T, dtype=torch.int32))
    assert not bool(out.ok)


def test_aligned_cap_exit_matches_jax(read_case):
    """A cut to the largest group: a mismatch on a member of a full group
    adds a member the slots cannot hold."""
    st = read_case[1]
    g = _cut(st.g, A=int(st.g.aligned_cnt.max()))
    out, _ = _check(g, *_collision_stream(st))
    assert not bool(out.ok)


def test_lane_list_fuses_only_its_lanes(read_case):
    """Three lanes (the read's stream, the collision stream, the read's
    stream again) in one call on lanes [1, 2]: lane 0 stays the state's
    graph, lanes 1 and 2 equal their one-lane calls."""
    abpt, st, run, k, fwd = read_case
    fwd_op, fwd_arg, n_fwd = fwd[:3]
    q, qlen, w = run.seqs[k], run.lens[k], run.wgts[k]
    c_op, c_arg, c_n, c_q, c_ql, c_w = _collision_stream(st)
    T, Q = fwd_op.shape[0], q.shape[0]
    pad = lambda x, n, v=0: torch.cat([x, torch.full((n - x.shape[0],), v,  # noqa: E731
                                                     dtype=torch.int32)])
    ops = torch.stack([fwd_op, pad(c_op, T, 2), fwd_op])
    args = torch.stack([fwd_arg, pad(c_arg, T), fwd_arg])
    qs = torch.stack([q, pad(c_q, Q), q])
    ws = torch.stack([w, pad(c_w, Q, 1), w])
    stacked = DeviceGraph(**{key: torch.stack([v] * 3)
                             for key, v in st.g.tensors().items()})
    got, path, plen = fuse_alignment_lanes(
        stacked, ops, args, torch.tensor([int(n_fwd), c_n, int(n_fwd)],
                                         dtype=torch.int32), qs, ws,
        torch.tensor([qlen, c_ql, qlen], dtype=torch.int32), Q + 2,
        lanes=[1, 2])
    for key, v in st.g.tensors().items():
        assert torch.equal(getattr(got, key)[0], v), key
    assert int(plen[0]) == 0
    one, p1 = _check(st.g, c_op, c_arg, c_n, c_q, c_ql, c_w)
    two, p2 = _check(st.g, fwd_op, fwd_arg, int(n_fwd), q, qlen, w)
    for l, want, p in ((1, one, p1), (2, two, p2)):
        for key, v in want.tensors().items():
            assert torch.equal(getattr(got, key)[l], v), (l, key)
        assert path[l, :int(plen[l])].tolist() == p
