"""The port's fused-loop steps against their JAX twins, on the same state.

- kernel X1: `backtrack_torch` (the plain version of `csrc/backtrack.cu`)
  equals `fused_loop._backtrack_w` on the planes of the B1 cases of
  tests/test_torch_fused_dp.py, across gap modes, global/extend/local,
  int16/int32 and put_gap_on_right / put_gap_at_end;
- kernel K1: `topo_sort_torch` (the plain version of `csrc/topo_sort.cu`)
  equals `device_graph.topo_sort` on graphs carried across by `convert.py`,
  including one straight out of the fusion, before its edge sort;
- the torch steps `_build_tables`, `_fuse_vectorized`, `_splice_order`,
  `_finish_fusion` (kernel S1's plain version: the span update and the edge
  sort, in place), `_remain_doubling`, `_seed_state` and the sequential
  `fuse_alignment` equal their JAX twins (a synthetic op stream covers a
  group-root collision, which no fixture produces).
Every comparison is exact. The CUDA kernels X1 and K1 are compared with
their plain versions on the card in test_torch_cuda_twins.py, which holds
the cases and imports no JAX.
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import jax.numpy as jnp

import abpoa_tpu.align.device_graph as jdg
import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.backtrack_kernel import backtrack_torch
from abpoa_tpu_torch.align.device_graph import fuse_alignment
from abpoa_tpu_torch.align.topo_kernel import topo_sort_torch
from abpoa_tpu_torch.io.fastx import read_fastx

from test_torch_cuda_twins import (BT_CASES, _bt_inputs, _topo_args,
                                   aligned_read, build_cases, encode,
                                   make_params, topo_graph_cases)

# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)

GRAPH_FIELDS = ("base", "in_ids", "in_w", "in_cnt", "out_ids", "out_w",
                "out_cnt", "aligned", "aligned_cnt", "n_read", "n_span")


# ---- helpers: moving state across ---------------------------------------

def jax_graph(g):
    """The JAX DeviceGraph of a port DeviceGraph."""
    a = convert.fused_state_to_numpy(tfl.FusedState(
        g=g, order=g.base, n2i=g.base, remain=g.base))
    return jdg.DeviceGraph(**{k: jnp.asarray(a[k]) for k in GRAPH_FIELDS},
                           node_n=jnp.int32(a["node_n"]),
                           ok=jnp.bool_(a["ok"]))


def assert_graph_equal(port_g, jax_g):
    for k in GRAPH_FIELDS + ("node_n", "ok"):
        np.testing.assert_array_equal(getattr(port_g, k).numpy(),
                                      np.asarray(getattr(jax_g, k)), err_msg=k)


def t2j(t):
    return jnp.asarray(t.numpy())


# ---- X1 --------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_cases():
    return build_cases()


@pytest.mark.parametrize("name,right,at_end", BT_CASES)
def test_backtrack_torch_matches_jax(name, right, at_end, dp_cases):
    case = dp_cases[name]
    planes_etc, (bi, bj), sc, Qp = _bt_inputs(case)
    s = case[1]
    abpt = make_params()
    mat = torch.from_numpy(abpt.mat.astype(np.int32))
    e1, oe1, e2, oe2, inf = sc[4], sc[5], sc[6], sc[7], sc[3]
    R = planes_etc[0].shape[0]
    max_ops = R + Qp + 8
    bt_sc = torch.tensor([bi, bj, e1, oe1, e2, oe2, inf, max_ops],
                         dtype=torch.int32)
    kw = dict(max_ops=max_ops, gap_mode=s["gap_mode"], gap_on_right=right,
              put_gap_at_end=at_end, local=s["local"])
    ops, res = backtrack_torch(*planes_etc, mat, bt_sc, **kw)

    H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed, query = planes_etc
    pre_msk = np.arange(pre_idx.shape[1])[None, :] < pre_cnt.numpy()[:, None]
    want = jfl._backtrack_w(
        *[t2j(p) for p in (H, E1, E2, F1, F2, beg, end, pre_idx)],
        jnp.asarray(pre_msk), jnp.asarray(base_packed.numpy() & 0xFF),
        t2j(query), t2j(mat), jnp.int32(bi), jnp.int32(bj),
        *[jnp.int32(x) for x in (e1, oe1, e2, oe2, inf)], **kw)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want[0]))
    assert res.tolist() == [int(np.asarray(x)) for x in want[1:]]
    assert res[0] > 10  # a real walk


# ---- K1 --------------------------------------------------------------------

@pytest.fixture(scope="module")
def topo_graphs():
    return topo_graph_cases()


@pytest.mark.parametrize("name", ["seq-fused-unsorted", "heter-sorted",
                                  "sim2k-sorted"])
def test_topo_sort_torch_matches_jax(name, topo_graphs):
    g = topo_graphs[name]
    if name.startswith("heter"):
        assert int(g.aligned_cnt.max()) > 0  # aligned groups are exercised
    got = topo_sort_torch(*_topo_args(g))
    gs, i2n, n2i, remain, ok = jdg.topo_sort(jax_graph(g))
    want = [gs.in_ids, gs.in_w, gs.out_ids, gs.out_w, i2n, n2i, remain]
    for a, b, k in zip(got, want, ("in_ids", "in_w", "out_ids", "out_w",
                                   "i2n", "n2i", "remain")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert int(got[7][0]) == int(ok) == 1


# ---- the torch steps -------------------------------------------------------

@pytest.fixture(scope="module")
def read_case():
    return aligned_read("heter.fa", 8)


def test_build_tables_match_jax(read_case):
    abpt, st, run, k, fwd = read_case
    base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain_rows = \
        tfl._build_tables(st.g, st.order, st.n2i, st.remain)
    (base_r, j_pre_idx, pre_msk, j_out_idx, out_msk, _row_active,
     j_remain, mpl0, mpr0) = jfl._build_tables(
        jax_graph(st.g), t2j(st.order), t2j(st.n2i), t2j(st.remain))
    N = base_r.shape[0]
    src_out = (np.asarray(mpl0) == 1) & (np.asarray(mpr0) == 1) & (np.arange(N) > 0)
    np.testing.assert_array_equal(base_packed.numpy(),
                                  np.asarray(base_r) | (src_out.astype(np.int32) << 8))
    np.testing.assert_array_equal(pre_idx.numpy(), np.asarray(j_pre_idx))
    np.testing.assert_array_equal(pre_cnt.numpy(), np.asarray(pre_msk).sum(1))
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(j_out_idx))
    np.testing.assert_array_equal(out_cnt.numpy(), np.asarray(out_msk).sum(1))
    np.testing.assert_array_equal(remain_rows.numpy(), np.asarray(j_remain))


def _jax_fuse(st, fwd_op, fwd_arg, n_fwd, query, qlen, weight):
    return jfl._fuse_vectorized(jax_graph(st.g), t2j(fwd_op), t2j(fwd_arg),
                                jnp.int32(int(n_fwd)), t2j(query),
                                jnp.int32(qlen), t2j(weight))


def _compare_fusion(got, want):
    g2, path_nodes, L, path_new, collision, edge_cap, grp_full = got
    assert_graph_equal(g2, want[0])
    np.testing.assert_array_equal(path_nodes.numpy(), np.asarray(want[1]))
    assert int(L) == int(want[2])
    np.testing.assert_array_equal(path_new.numpy(), np.asarray(want[3]))
    assert [bool(collision), bool(edge_cap), bool(grp_full)] == \
        [bool(want[4]), bool(want[5]), bool(want[6])]


def test_fuse_splice_sort_remain_match_jax(read_case):
    abpt, st, run, k, fwd = read_case
    fwd_op, fwd_arg, n_fwd = fwd[:3]
    q, qlen, w = run.seqs[k], run.lens[k], run.wgts[k]
    got = tfl._fuse_vectorized(st.g, fwd_op, fwd_arg, n_fwd, q, qlen, w)
    want = _jax_fuse(st, fwd_op, fwd_arg, n_fwd, q, qlen, w)
    _compare_fusion(got, want)
    g2, path_nodes, L, path_new = got[:4]

    order2, n2i2 = tfl._splice_order(st.order, st.n2i, int(st.g.node_n),
                                     g2.node_n, path_nodes, L, path_new)
    j_order, j_n2i = jfl._splice_order(
        t2j(st.order), t2j(st.n2i), jnp.int32(int(st.g.node_n)),
        jnp.int32(int(g2.node_n)), want[1], want[2], want[3])
    np.testing.assert_array_equal(order2.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(n2i2.numpy(), np.asarray(j_n2i))

    gs = tfl._finish_fusion(g2, st.g)
    # the JAX loop's span update, then its sort (fused_loop.py:1446-1452)
    jg = want[0]
    nodes_r = jnp.arange(jg.n_span.shape[0], dtype=jnp.int32)
    j_gs = jfl._edge_sort(jg._replace(
        n_span=jnp.where(nodes_r < jg.node_n, jg.n_span + 1, jg.n_span)))
    assert_graph_equal(gs, j_gs)

    np.testing.assert_array_equal(tfl._remain_doubling(gs).numpy(),
                                  np.asarray(jfl._remain_doubling(j_gs)))


def test_seed_state_and_state_conversion_match_jax():
    abpt = make_params()
    seqs = [encode(abpt, r.seq) for r in read_fastx(os.path.join(DATA_DIR, "seq.fa"))]
    q = np.zeros(64, dtype=np.int32)
    q[: len(seqs[0])] = seqs[0]
    w = np.ones(64, dtype=np.int32)
    w[3] = 5
    qlen = len(seqs[0])
    j_st = jfl._seed_state(jfl.init_fused_state(256, 8, 8), jnp.asarray(q),
                           jnp.int32(qlen), jnp.asarray(w))
    st = tfl._seed_state(tfl.init_fused_state(256, 8, 8, "cpu"),
                         torch.from_numpy(q), qlen, torch.from_numpy(w))
    a, b = convert.fused_state_to_numpy(st), convert.fused_state_to_numpy(j_st)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back = convert.fused_state_to_numpy(convert.fused_state_from_numpy(b))
    for key in a:
        np.testing.assert_array_equal(back[key], b[key], err_msg=key)


def test_sequential_fusion_matches_jax(read_case):
    """`fuse_alignment` on a real read's op stream."""
    abpt, st, run, k, fwd = read_case
    fwd_op, fwd_arg, n_fwd = fwd[:3]
    q, qlen, w = run.seqs[k], run.lens[k], run.wgts[k]
    got, path = fuse_alignment(st.g, fwd_op, fwd_arg, int(n_fwd), q, qlen, w)
    ops = torch.stack([fwd_op, fwd_arg], 1)
    ops[int(n_fwd):] = 0
    want = jdg.fuse_alignment(jax_graph(st.g), t2j(ops), jnp.int32(int(n_fwd)),
                              t2j(q), jnp.int32(qlen), t2j(w),
                              C.SRC_NODE_ID, C.SINK_NODE_ID,
                              max_ops=ops.shape[0])
    assert_graph_equal(got, want)
    # with no collision the vectorised fusion gives the same graph and the
    # same path, one node a base of the read
    vec = tfl._fuse_vectorized(st.g, fwd_op, fwd_arg, n_fwd, q, qlen, w)
    assert_graph_equal(vec[0], want)
    assert len(path) == int(vec[2]) == qlen
    assert path == vec[1][:qlen].tolist()


def test_collision_stream_matches_jax(read_case):
    """Two mismatch columns on two members of one aligned group: the
    vectorised fusion flags a collision and the sequential fusion, which
    the loop then takes, equals JAX's."""
    abpt, st, *_ = read_case
    cnt = st.g.aligned_cnt.numpy()
    a = int(np.flatnonzero(cnt > 0)[0])
    b = int(st.g.aligned[a, 0])
    bases = {int(st.g.base[x]) for x in [a] + st.g.aligned[a, : cnt[a]].tolist()}
    other = min(set(range(4)) - bases)
    T = 16
    fwd_op = torch.full((T,), 2, dtype=torch.int32)
    fwd_op[:2] = 0
    fwd_arg = torch.zeros(T, dtype=torch.int32)
    fwd_arg[0], fwd_arg[1] = a, b
    q = torch.full((T,), other, dtype=torch.int32)
    w = torch.ones(T, dtype=torch.int32)
    got = tfl._fuse_vectorized(st.g, fwd_op, fwd_arg, torch.tensor(2), q, 2, w)
    want = _jax_fuse(st, fwd_op, fwd_arg, 2, q, 2, w)
    _compare_fusion(got, want)
    assert bool(got[4])
    seq, seq_path = fuse_alignment(st.g, fwd_op, fwd_arg, 2, q, 2, w)
    ops = torch.stack([fwd_op, fwd_arg], 1)
    ops[2:] = 0
    j_seq = jdg.fuse_alignment(jax_graph(st.g), t2j(ops), jnp.int32(2), t2j(q),
                               jnp.int32(2), t2j(w), C.SRC_NODE_ID,
                               C.SINK_NODE_ID, max_ops=T)
    assert_graph_equal(seq, j_seq)
    # the second column reuses the node the first one created: one new
    # node, where the vectorised fusion made two
    assert int(seq.node_n) == int(st.g.node_n) + 1
    assert seq_path == [int(st.g.node_n)] * 2
    assert int(got[0].node_n) == int(st.g.node_n) + 2
