"""The device lockstep's pieces on the CPU:
- read-id outputs (`-r 2`, MSA; `-r 3`, GFA): the lanes' recorded paths give
  JAX's batch and the port's set-by-set bitsets;
- collisions forced in one lane only: that lane takes kernel F1's
  sequential fusion and a Kahn repair every read, the others do not, and
  every set's graph and paths equal the unforced runs (the sequential and
  vectorised fusions agree where nothing collides);
- each lane step of `align/fused_lanes.py` against its single-set function
  of `fused_loop`, lane by lane, on three graphs of uneven sizes stacked
  into lanes, with the kernels' lane wrappers (B1, X1, S1, K1, F1, their
  plain versions here) against their single-set wrappers, on every lane
  and on a lane list;
- the CLI: `-l --lockstep on` with ABPOA_TPU_LOCKSTEP_IMPL=device equals
  `--lockstep off` and the JAX CLI on a list of tests/data sets, and
  launches the device lockstep.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch.align import fused_lanes as fla
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.fused_lanes import progressive_poa_fused_batch
from abpoa_tpu_torch.align.backtrack_kernel import backtrack, backtrack_lanes
from abpoa_tpu_torch.align.device_graph import fuse_alignment
from abpoa_tpu_torch.align.edge_sort_kernel import (finish_fusion_,
                                                    finish_fusion_lanes_)
from abpoa_tpu_torch.align.fuse_kernel import (fuse_alignment_lanes,
                                               lane_graph)
from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp, fused_dp_lanes
from abpoa_tpu_torch.align.topo_kernel import topo_sort, topo_sort_lanes

from test_torch_fused_batch import (assert_same_graph, check_sets, file_set,
                                    params, sim_set)

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [dict(out_msa=True), dict(out_gfa=True)],
                         ids=["r2", "r3"])
def test_read_ids_match_jax(kw):
    tp, jp = params(**kw)
    sets = [file_set(tp, "seq.fa"), file_set(tp, "seq4.fa"),
            sim_set(tp, 9, 5)]
    got = check_sets(sets, tp, jp)
    for pg, _ in got:
        assert any(any(nd.read_ids) for nd in pg.nodes)


def test_collisions_forced_in_one_lane(monkeypatch):
    tp, jp = params(out_msa=True)
    sets = [file_set(tp, "seq.fa"), sim_set(tp, 11, 6), file_set(tp, "seq4.fa")]
    want = [tfl.progressive_poa_fused(s, w, tp) for s, w in sets]
    real, real_round = fla._fuse_vectorized_l, fla._read_round
    live = {}

    def round_(run, ls, N):
        live["sets"] = ls.sets
        return real_round(run, ls, N)

    def colliding(*a, **k):
        out = list(real(*a, **k))
        if 1 in live["sets"]:  # set 1's lane, while it lives
            out[4] = out[4].clone()
            out[4][live["sets"].index(1)] = True
        return tuple(out)

    monkeypatch.setattr(fla, "_read_round", round_)
    monkeypatch.setattr(fla, "_fuse_vectorized_l", colliding)
    tfl.reset_stats()
    got = progressive_poa_fused_batch([s for s, _ in sets],
                                          [w for _, w in sets], tp)
    assert tfl.stats["collisions"] == len(sets[1][0]) - 1
    for (pg, rc), (wpg, _, wrc) in zip(got, want):
        assert_same_graph(pg, wpg, "forced collision")
        assert rc == wrc


# ---- the lane steps against the single-set steps --------------------------

def _states(tp, sets, n_reads):
    """The single-set loop's state after n_reads[i] reads of set i, padded
    to common capacities, and each set's next read."""
    sts = []
    for (s, w), k in zip(sets, n_reads):
        tfl.progressive_poa_fused(s[:k], w[:k], tp)
        sts.append(tfl.last_state)
    N = max(st.g.caps[0] for st in sts)
    E = max(st.g.caps[1] for st in sts)
    A = max(st.g.caps[2] for st in sts)
    sts = [tfl._grow_state(st, N, E, A) for st in sts]
    return sts, (N, E, A)


def _single(tp, st, query, weight, qp, qlen, W, inf, local):
    """One read's single-set steps: (tables, dp args, DP outputs, best cell,
    X1 outputs, forward ops)."""
    tables = tfl._build_tables(st.g, st.order, st.n2i, st.remain)
    args = tfl.dp_inputs(tp, st, tables, qp, qlen, W, inf, local)
    out = fused_dp(*args, gap_mode=tp.gap_mode, plane16=False, local=local)
    best = tfl.best_cell(out[0], out[5], out[6], args[2], args[3],
                         st.g.node_n.reshape(1), out[8], qlen, inf, local)
    return tables, args, out, best


@pytest.mark.parametrize("kw", [{}, dict(align_mode=1)], ids=["global", "local"])
def test_lane_steps_match_single_set_steps(kw):
    tp, _ = params(**kw)
    local = tp.align_mode == 1
    sets = [file_set(tp, "seq.fa"), sim_set(tp, 31, 6), file_set(tp, "heter.fa")]
    ks = [6, 3, 4]
    sts, (N, E, A) = _states(tp, sets, ks)
    Qp = max(len(s) for ss, _ in sets for s in ss) + 8
    W = 256 if not local else 512
    inf = -(1 << 28)
    mat = torch.from_numpy(np.ascontiguousarray(tp.mat.astype(np.int32)))
    qs, ws, qps, qlens = [], [], [], []
    for (s, w), k in zip(sets, ks):
        sp, wp, ln, qp = tfl._pad_read_set([s[k]], [w[k]], Qp, tp.mat.astype(np.int32), tp.m)
        qs.append(torch.from_numpy(sp[0]))
        ws.append(torch.from_numpy(wp[0]))
        qps.append(torch.from_numpy(qp[0]))
        qlens.append(int(ln[0]))
    L = len(sets)
    g = fla.stack_graphs([st.g for st in sts])
    order = torch.stack([st.order for st in sts])
    n2i = torch.stack([st.n2i for st in sts])
    remain = torch.stack([st.remain for st in sts])
    query, weight, qp = torch.stack(qs), torch.stack(ws), torch.stack(qps)

    tables_l = fla._build_tables_l(g, order, n2i, remain)
    args_l, ql = fla.dp_inputs_l(tp, g, remain, tables_l, qp, qlens, W, inf,
                                 local)
    out_l = fused_dp_lanes(*args_l, gap_mode=tp.gap_mode, plane16=False,
                           local=local)
    best_l = fla.best_cell_l(out_l[0], out_l[5], out_l[6], args_l[2],
                             args_l[3], g.node_n, out_l[8], ql, inf, local)
    max_ops = N + Qp + 8
    bt = torch.tensor([tp.gap_ext1, tp.gap_oe1, tp.gap_ext2, tp.gap_oe2, inf,
                       max_ops], dtype=torch.int32)
    sc_l = torch.cat([best_l[0][:, None], best_l[1][:, None],
                      bt.expand(L, 6)], 1).contiguous()
    bkw = dict(max_ops=max_ops, gap_mode=tp.gap_mode, gap_on_right=False,
               put_gap_at_end=False, local=local)
    ops_l, res_l = backtrack_lanes(*out_l[:7], args_l[2], args_l[3],
                                   args_l[1], query, mat, sc_l, **bkw)
    fwd_l = fla.forward_ops_l(ops_l, res_l, order, best_l[1], ql, max_ops)
    rc_l = fla._rc_read_l(query, weight, ql, mat)
    fus_l = fla._fuse_vectorized_l(g, *fwd_l, query, ql, weight)
    sp_l = fla._splice_order_l(order, n2i, g.node_n, fus_l[0].node_n,
                               fus_l[1], fus_l[2], fus_l[3])
    bad_l = fla._order_violated_l(fus_l[0], sp_l[1])
    rem_l = fla._remain_doubling_l(fus_l[0])
    seed_l = fla._seed_state_l(g, query, ql, weight)

    for l, st in enumerate(sts):
        tables, args, out, best = _single(tp, st, qs[l], ws[l], qps[l],
                                          qlens[l], W, inf, local)
        for a, b in zip(tables_l, tables):
            assert torch.equal(a[l], b)
        for a, b in zip(args_l, args):
            assert torch.equal(a[l], b)
        rows = int(st.g.node_n) - 1
        for q in range(5):
            assert torch.equal(out_l[q][l, :rows], out[q][:rows])
        for a, b in zip(out_l[5:], out[5:]):
            assert torch.equal(a[l].reshape(-1), b.reshape(-1))
        for a, b in zip(best_l, best):
            assert int(a[l]) == int(b)
        sc = torch.cat([torch.stack([best[0], best[1]]).to(torch.int32), bt])
        ops, res = backtrack(*out[:7], args[2], args[3], args[1], qs[l], mat,
                             sc, **bkw)
        assert torch.equal(ops_l[l], ops) and torch.equal(res_l[l], res)
        fwd = tfl.forward_ops(ops, res, st.order, best[1], qlens[l], max_ops)
        for a, b in zip(fwd_l, fwd):
            assert torch.equal(a[l], b)
        for a, b in zip(rc_l, tfl._rc_read(qs[l], ws[l], qlens[l], mat)):
            assert torch.equal(a[l], b)
        fus = tfl._fuse_vectorized(st.g, *fwd, qs[l], qlens[l], ws[l])
        assert_graph_lane(fus_l[0], l, fus[0])
        for a, b in zip(fus_l[1:], fus[1:]):
            assert torch.equal(a[l], b)
        sp = tfl._splice_order(st.order, st.n2i, int(st.g.node_n),
                               fus[0].node_n, fus[1], fus[2], fus[3])
        assert torch.equal(sp_l[0][l], sp[0]) and torch.equal(sp_l[1][l], sp[1])
        assert bool(bad_l[l]) == bool(tfl._order_violated(fus[0], sp[1]))
        assert torch.equal(rem_l[l], tfl._remain_doubling(fus[0]))
        seed = tfl._seed_state(tfl.init_fused_state(N, E, A, "cpu"), qs[l],
                               qlens[l], ws[l])
        assert_graph_lane(seed_l[0], l, seed.g)
        for a, b in zip(seed_l[1:], (seed.order, seed.n2i, seed.remain)):
            assert torch.equal(a[l], b)

    # the kernels' lane wrappers on a lane list: S1, K1 and F1 (X1 and B1
    # above, on every lane)
    g2 = fus_l[0]
    part = [0, 2]
    s1 = {k: v.clone() for k, v in g2.tensors().items()}
    finish_fusion_lanes_(s1["in_ids"], s1["in_w"], s1["out_ids"], s1["out_w"],
                         s1["in_cnt"], s1["out_cnt"], s1["node_n"],
                         s1["n_span"], lanes=part)
    k1 = topo_sort_lanes(g2.in_ids, g2.in_w, g2.out_ids, g2.out_w, g2.in_cnt,
                         g2.out_cnt, g2.aligned, g2.aligned_cnt, g2.node_n,
                         lanes=part)
    Pcap = Qp + 2
    f1, path, plen = fuse_alignment_lanes(g, *fwd_l, query, weight, ql, Pcap,
                                          lanes=part)
    for l in range(L):
        one = {k: v[l].clone() for k, v in g2.tensors().items()}
        if l in part:
            finish_fusion_(one["in_ids"], one["in_w"], one["out_ids"],
                           one["out_w"], one["in_cnt"], one["out_cnt"],
                           one["node_n"].reshape(1), one["n_span"])
        for k in ("in_ids", "in_w", "out_ids", "out_w", "n_span"):
            assert torch.equal(s1[k][l], one[k]), (l, k)
        gl = lane_graph(g, l)
        if l in part:
            g2l = lane_graph(g2, l)
            want = topo_sort(g2l.in_ids, g2l.in_w, g2l.out_ids, g2l.out_w,
                             g2l.in_cnt, g2l.out_cnt, g2l.aligned,
                             g2l.aligned_cnt, g2l.node_n.reshape(1))
            for a, b in zip(k1[:7], want[:7]):
                assert torch.equal(a[l], b)
            assert int(k1[7][l]) == int(want[7][0])
            seq, p = fuse_alignment(gl, fwd_l[0][l], fwd_l[1][l],
                                    min(int(fwd_l[2][l]), max_ops), qs[l],
                                    qlens[l], ws[l])
            assert_graph_lane(f1, l, seq)
            assert path[l, :len(p)].tolist() == p and int(plen[l]) == len(p)
        else:
            assert_graph_lane(f1, l, gl)  # a lane off the list: untouched
            assert int(plen[l]) == 0


def assert_graph_lane(stacked, l, g):
    for k, v in g.tensors().items():
        assert torch.equal(getattr(stacked, k)[l], v), k


# ---- the CLI ---------------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("flags", [[], ["-r", "1", "-s"]], ids=["cons", "r1-s"])
def test_cli_device_lockstep_equals_set_by_set_and_jax(tmp_path, monkeypatch,
                                                       flags):
    from abpoa_tpu.cli import main as jax_main
    lst = tmp_path / "list.txt"
    lst.write_text("".join(os.path.join(DATA_DIR, f) + "\n" for f in
                           ("seq.fa", "test.fa", "seq4.fa", "rcmix.fa")))
    argv = [str(lst), "-l", *flags, "--device", "cpu"]
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "device")
    tfl.reset_stats()
    on = _run(cli.main, argv + ["--lockstep", "on"])
    assert tfl.stats["rounds"] > 0
    off = _run(cli.main, argv + ["--lockstep", "off"])
    want = _run(jax_main, [str(lst), "-l", *flags, "--device", "numpy"])
    assert on == off == want and on[0] == 0 and on[1]
