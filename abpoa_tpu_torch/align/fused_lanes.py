"""The device lockstep: K read sets through the fused loop at once, every
set's graph on the device.

Counterpart of `abpoa_tpu/align/fused_loop.py` `progressive_poa_fused_batch`
(:1961), a `jax.vmap` over K sets of `run_fused_chunk` (:1189). Here the
set axis is a leading lane axis written out: the K graphs are stacked
(`DeviceGraph` arrays of shape (L, N, ...), node_n and ok (L,)), and each
round every live lane advances one read. A round is the single-set loop's
read step (`fused_loop._read_step`) over the lanes:

  tables -> kernel B1/B3 (`fused_dp_lanes`, one block a lane) -> best cell
  -> kernel X1 (`backtrack_lanes`, one warp a lane) -> forward op stream ->
  fusion -> kernel S1 (`finish_fusion_lanes_`) -> splice and its check

with each torch step one set of launches for all lanes (the `*_l`
functions below, each the single-set step of `fused_loop` with the lane
axis: a gather or scatter at lane l reads and writes lane l's rows only).
The host reads the lanes' flags in one sync a round; the `-s` reverse
strand adds one (the lanes under the threshold align it, in one more B1 and
X1 launch over those lanes), and so does a Kahn repair: the colliding
lanes' sequential fusion (kernel F1, `fuse_alignment_lanes`) and its S1,
then kernel K1 (`topo_sort_lanes`) over the lanes whose splice is not a
valid order or that collided, all on the stream before that sync.
B1 and X1 launch once a round over the lanes where the lanes' planes fit
on the card (five planes of N x W a lane), and else once for each group of
lanes that fits (`plane_groups`: local mode at 10 kb, where one lane's
planes reach ~10 GB), with the allocator's cache emptied before and after
those groups (two device syncs); the count of extra passes is
`stats["plane_splits"]`.

A lane that reports an error commits nothing; the capacities are shared,
so an error grows them for every lane by padding, as JAX's collective
growth does (:2112-2123), and the lane runs its read again next round.
Errors known on the host before any work (int16 promotion, node capacity)
grow the capacities before the round's launches. A lane leaves the stack
when its set is done; its graph is downloaded once after the loop. So each
set's graph, strand flags and read paths equal `progressive_poa_fused`'s on
that set alone, byte for byte. There is no fallback: a diverged backtrack,
an unknown error or growth that does not converge raises, as in the
single-set loop.

Unlike JAX, the lanes are not padded to a power-of-two K rung and the reads
to a reads rung: a kernel launches one block a live lane (ROADMAP.md §C).

With a mesh (`parallel/shard.py`; JAX's `mesh=`, :1986-2036) the sets split
into one contiguous group a slot (`shard.split_lanes`), each with its own
lane stack, capacities and growth on its device (`_group_loop`). One host
thread drives the groups round-robin (`_drive_groups`): `_read_round`
yields just before each host sync, so a round of every group is queued
before any group's sync, and the counters stay exact. The kernels launch
once a group a round; the graphs are downloaded after every group is done.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from .. import resilience as rz
from ..params import Params
from ..resilience import memory
from . import fused_loop as fl
from .backtrack_kernel import backtrack_lanes
from .buckets import chunk_node_cap, plan_chunk_buckets
from .device_graph import DeviceGraph
from .edge_sort_kernel import finish_fusion_lanes_
from .fuse_kernel import fuse_alignment_lanes, lane_graph
from .fused_dp_kernel import fused_dp_lanes
from .oracle import INT16_MIN, INT32_MIN, dp_inf_min, int16_score_limit, \
    max_score_bound
from .topo_kernel import topo_sort_lanes

_i32 = fl._i32
_step = fl._step


# --------------------------------------------------------------------------- #
# per-lane gathers and scatters                                               #
# --------------------------------------------------------------------------- #

def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[l, idx[l, ...]] for every lane l in one gather: arr (L, S, ...),
    idx (L, ...) -> (L, *idx.shape[1:], *arr.shape[2:])."""
    L, S = arr.shape[:2]
    idx = idx.to(torch.int64)
    if arr.dim() == 2:
        return arr.gather(1, idx.reshape(L, -1)).view(idx.shape)
    off = torch.arange(L, device=arr.device).view(
        (L,) + (1,) * (idx.dim() - 1)) * S
    return arr.reshape((L * S,) + tuple(arr.shape[2:]))[idx + off]


def _scatter(arr: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
             vals: torch.Tensor, op: str = "set") -> torch.Tensor:
    """`fused_loop.spill_scatter` at each lane: a copy of arr (L, S, ...)
    with vals written ("set") or added ("add") at arr[l, idx[l, k]] where
    valid[l, k] and the index is in range; idx and valid (L, n), vals
    broadcast to (L, n, ...). One scatter for all lanes."""
    L, S = arr.shape[:2]
    n = idx.shape[1]
    rest = tuple(arr.shape[2:])
    idx = idx.to(torch.int64)
    ok = valid & (idx >= 0) & (idx < S)
    off = torch.arange(L, device=arr.device)[:, None] * S
    vals = vals.to(arr.device, arr.dtype).expand((L, n) + rest)
    flat = fl.spill_scatter(arr.reshape((L * S,) + rest),
                            (idx + off).reshape(-1), ok.reshape(-1),
                            vals.reshape((L * n,) + rest), op)
    return flat.view(arr.shape)


def _add_at(arr: torch.Tensor, rows, cols, valid, vals) -> torch.Tensor:
    """`fused_loop._add_at` at each lane: arr (L, S, K), rows/cols/valid
    (L, n)."""
    L, S, K = arr.shape
    rows = rows.to(torch.int64)
    lin = rows * K + cols.to(torch.int64)
    ok = valid & (rows >= 0) & (rows < S)
    return _scatter(arr.reshape(L, S * K), lin, ok, vals, "add").view(L, S, K)


def _excl_cumsum(m: torch.Tensor) -> torch.Tensor:
    m = m.to(torch.int32)
    return _i32(torch.cumsum(m, 1)) - m


def stack_graphs(gs: List[DeviceGraph]) -> DeviceGraph:
    """Single-set graphs of one (N, E, A) stacked into lanes."""
    return DeviceGraph(**{k: torch.stack([getattr(g, k) for g in gs])
                          for k in gs[0].tensors()})


def _where_lanes(mask: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """a at the lanes of mask (L,), b elsewhere."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


# --------------------------------------------------------------------------- #
# the read step's torch steps over a lane axis                                #
# --------------------------------------------------------------------------- #

def _build_tables_l(g: DeviceGraph, order, n2i, remain):
    """`fused_loop._build_tables` of each lane."""
    L, N, E = g.in_ids.shape
    dev = order.device
    n = g.node_n[:, None]
    rows = torch.arange(N, dtype=torch.int32, device=dev)[None]
    nid = order.to(torch.int64)
    base_r = g.base.gather(1, nid)
    pre_idx = _take(n2i, _take(g.in_ids, nid))
    pre_cnt = torch.where((rows > 0) & (rows < n), g.in_cnt.gather(1, nid),
                          torch.zeros_like(base_r))
    out_idx = _take(n2i, _take(g.out_ids, nid))
    out_cnt = torch.where((rows > 0) & (rows < n - 1),
                          g.out_cnt.gather(1, nid), torch.zeros_like(base_r))
    remain_rows = remain.gather(1, nid)
    slots = torch.arange(E, device=dev)[None]
    src_cnt = g.out_cnt.gather(1, nid[:, :1])
    src_out = _scatter(torch.zeros((L, N), dtype=torch.int32, device=dev),
                       out_idx[:, 0], slots < src_cnt,
                       torch.ones((L, E), dtype=torch.int32, device=dev))
    src_out = src_out * (rows > 0)
    base_packed = base_r | (src_out << 8)
    return base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain_rows


def _seed_state_l(g: DeviceGraph, query, ql, weight):
    """`fused_loop._seed_state` of each lane: every lane's first read (qlen
    ql (L,) on the device) becomes a chain. Returns (g, order, n2i,
    remain)."""
    L, N, E = g.in_ids.shape
    A = g.aligned.shape[2]
    dev = query.device
    Q = query.shape[1]
    nodes = torch.arange(N, dtype=torch.int32, device=dev)[None].expand(L, N)
    q1 = ql[:, None]
    is_seq = (nodes >= 2) & (nodes < q1 + 2)
    qi = torch.clamp(nodes - 2, 0, Q - 1).to(torch.int64)
    zero = torch.zeros_like(nodes)
    base = torch.where(is_seq, _i32(query.gather(1, qi)), zero)
    wv = _i32(weight.gather(1, qi))
    wlast = _i32(weight.gather(1, torch.clamp(q1 - 1, min=0).to(torch.int64)))
    last = q1 + 1
    in_ids = torch.zeros((L, N, E), dtype=torch.int32, device=dev)
    in_w, out_ids, out_w = (torch.zeros_like(in_ids) for _ in range(3))
    in_ids[:, :, 0] = torch.where(is_seq, torch.where(
        nodes == 2, torch.full_like(nodes, C.SRC_NODE_ID), nodes - 1), zero)
    in_w[:, :, 0] = torch.where(is_seq, wv, zero)
    out_ids[:, :, 0] = torch.where(is_seq, torch.where(
        nodes == last, torch.full_like(nodes, C.SINK_NODE_ID), nodes + 1),
        zero)
    wnext = _i32(weight.gather(1, torch.clamp(qi + 1, 0, Q - 1)))
    out_w[:, :, 0] = torch.where(is_seq, torch.where(
        nodes == last, wlast.expand(L, N), wnext), zero)
    in_ids[:, C.SINK_NODE_ID, 0] = last[:, 0]
    in_w[:, C.SINK_NODE_ID, 0] = wlast[:, 0]
    out_ids[:, C.SRC_NODE_ID, 0] = 2
    out_w[:, C.SRC_NODE_ID, 0] = _i32(weight[:, 0])
    in_cnt = _i32(is_seq | (nodes == C.SINK_NODE_ID))
    out_cnt = _i32(is_seq | (nodes == C.SRC_NODE_ID))
    n_span = _i32(is_seq | (nodes < 2))
    node_n = _i32(ql + 2)
    g2 = DeviceGraph(
        base=base, in_ids=in_ids, in_w=in_w, in_cnt=in_cnt, out_ids=out_ids,
        out_w=out_w, out_cnt=out_cnt,
        aligned=torch.zeros((L, N, A), dtype=torch.int32, device=dev),
        aligned_cnt=torch.zeros_like(base), n_read=out_cnt.clone(),
        n_span=n_span, node_n=node_n, ok=g.ok & (node_n <= N))
    n1 = node_n[:, None]
    order = torch.where(nodes == 0, torch.full_like(nodes, C.SRC_NODE_ID),
                        torch.where(nodes < n1 - 1, nodes + 1,
                                    torch.where(nodes == n1 - 1,
                                                torch.full_like(nodes, C.SINK_NODE_ID),
                                                zero)))
    active = nodes < n1
    n2i = _scatter(zero, order, active, torch.where(active, nodes, zero))
    remain = torch.where(active, n1 - 2 - n2i, zero)
    return g2, order, n2i, remain


def _fuse_vectorized_l(g: DeviceGraph, fwd_op, fwd_arg, n_fwd, query, ql,
                       weight):
    """`fused_loop._fuse_vectorized` of each lane (ql (L,) the read lengths
    on the device). Returns (g', path_nodes, path_len, path_new, collision,
    edge_cap, grp_full), the last three (L,) bool."""
    L, N, E = g.in_ids.shape
    A = g.aligned.shape[2]
    dev = fwd_op.device
    T = fwd_op.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=dev)[None]
    valid = t < n_fwd[:, None]
    is_match = valid & (fwd_op == 0)
    is_ins = valid & (fwd_op == 2)
    consumes = is_match | is_ins
    Q = query.shape[1]

    qpos = torch.clamp(_excl_cumsum(consumes), 0, Q - 1).to(torch.int64)
    b = _i32(query.gather(1, qpos))
    wt = _i32(weight.gather(1, qpos))

    node = torch.clamp(fwd_arg, 0, N - 1).to(torch.int64)
    same = is_match & (g.base.gather(1, node) == b)
    grp_ids = _take(g.aligned, node).to(torch.int64)            # (L, T, A)
    acnt_node = g.aligned_cnt.gather(1, node)                   # (L, T)
    kA = torch.arange(A, device=dev)
    grp_ok = kA < acnt_node[..., None]
    grp_hit = grp_ok & (_take(g.base, grp_ids) == b[..., None])
    has_aln = grp_hit.any(2)
    aln_id = torch.gather(grp_ids, 2, fl._first_true(grp_hit, 2)[..., None])[..., 0]
    mm = is_match & ~same
    reuse = mm & has_aln
    mm_new = mm & ~has_aln

    # collision: two mismatch ops of a lane's read touching one aligned group
    grp_min = torch.where(grp_ok, grp_ids,
                          torch.full_like(grp_ids, N)).min(2).values
    grp_root = torch.where(acnt_node > 0, torch.minimum(node, grp_min), node)
    ones_t = torch.ones_like(fwd_op)
    hits = _scatter(torch.zeros((L, N), dtype=torch.int32, device=dev),
                    grp_root, mm, ones_t, op="add")
    collision = (hits > 1).any(1)

    is_new = is_ins | mm_new
    new_id = g.node_n[:, None] + _excl_cumsum(is_new)
    n_new = is_new.sum(1, dtype=torch.int32)

    zero_t = torch.zeros_like(fwd_op)
    path_node = torch.where(same, _i32(node), torch.where(
        reuse, _i32(aln_id), torch.where(is_new, new_id, zero_t)))
    rank = _excl_cumsum(consumes)
    Lp = consumes.sum(1, dtype=torch.int32)
    path_plane = _scatter(
        torch.zeros((L, T + 1, 3), dtype=torch.int32, device=dev), rank,
        consumes, torch.stack([path_node, wt, _i32(is_new)], 2))
    path_nodes, path_w, path_new = path_plane.unbind(2)

    # new nodes' n_span: the value of the nearest old path node before them
    r_ = torch.arange(T + 1, dtype=torch.int32, device=dev)[None]
    L1 = Lp[:, None]
    is_old_path = (r_ < L1) & (path_new == 0)
    last_old = torch.cummax(torch.where(is_old_path, r_,
                                        torch.full_like(path_new, -1)), 1).values
    span_src = torch.where(last_old >= 0,
                           path_nodes.gather(1, torch.clamp(last_old, 0, T).to(torch.int64)),
                           torch.full_like(path_new, C.SRC_NODE_ID))
    n_span_val = g.n_span.gather(1, span_src.to(torch.int64))
    n_span_t = n_span_val.gather(1, torch.clamp(rank, 0, T).to(torch.int64))

    # edges SRC -> p0 -> ... -> p(L-1) -> SINK
    e_valid = r_ <= L1
    prev = torch.clamp(r_ - 1, 0, T).to(torch.int64).expand(L, T + 1)
    fr = torch.where(r_ == 0, torch.full_like(path_new, C.SRC_NODE_ID),
                     path_nodes.gather(1, prev))
    to = torch.where(r_ == L1, torch.full_like(path_new, C.SINK_NODE_ID),
                     path_nodes)
    wlast = _i32(weight.gather(1, torch.clamp(ql[:, None] - 1, min=0).to(torch.int64)))
    ew = torch.where(r_ == L1, wlast, path_w)
    prev_new = torch.where(r_ == 0, torch.zeros_like(path_new),
                           path_new.gather(1, prev))
    check = prev_new == 0
    kE = torch.arange(E, device=dev)

    def adj_update(ids, w, cnt, row, other):
        rc = torch.clamp(row, 0, N - 1).to(torch.int64)
        cnt_r = cnt.gather(1, rc)
        m = (kE < cnt_r[..., None]) & (_take(ids, rc) == other[..., None])
        exists = check & m.any(2) & e_valid
        slot = torch.where(exists, _i32(fl._first_true(m, 2)), cnt_r)
        cap = (e_valid & (slot >= E)).any(1)
        slot_c = torch.clamp(slot, 0, E - 1)
        new_e = ~exists & e_valid
        ids2 = _add_at(ids, rc, slot_c, e_valid,
                       torch.where(new_e, other, torch.zeros_like(other)))
        w2 = _add_at(w, rc, slot_c, e_valid, ew)
        cnt2 = _scatter(cnt, rc, e_valid, _i32(new_e), op="add")
        return ids2, w2, cnt2, cap

    oids, ow, ocnt, o_cap = adj_update(g.out_ids, g.out_w, g.out_cnt, fr, to)
    iids, iw, icnt, i_cap = adj_update(g.in_ids, g.in_w, g.in_cnt, to, fr)
    n_read = _scatter(g.n_read, torch.clamp(fr, 0, N - 1), e_valid,
                      torch.ones_like(path_new), op="add")
    edge_cap = o_cap | i_cap

    # aligned-group registration of mismatch-new nodes, new nodes' base and
    # n_span: appends into zero slots plus count bumps
    memb_ok = grp_ok & mm_new[..., None]
    memb = torch.where(memb_ok, grp_ids, torch.full_like(grp_ids, N))
    acnt_memb = _take(g.aligned_cnt, torch.clamp(memb, 0, N - 1))
    grp_full = (mm_new & (acnt_node + 1 > A)).any(1) | \
        (memb_ok & (acnt_memb + 1 > A)).flatten(1).any(1)
    new64 = torch.clamp(new_id, 0, N - 1).to(torch.int64)
    ones = torch.ones_like(fwd_op)
    flatTA = lambda x: x.reshape(L, T * A)  # noqa: E731
    # (a) every member of the group gains the new node
    aln = _add_at(g.aligned, flatTA(memb),
                  flatTA(torch.clamp(acnt_memb, 0, A - 1)), flatTA(memb_ok),
                  flatTA(new_id[..., None].expand(L, T, A)))
    acnt = _scatter(g.aligned_cnt, flatTA(memb), flatTA(memb_ok),
                    torch.ones((L, T * A), dtype=torch.int32, device=dev),
                    op="add")
    # (b) the node the mismatch was aligned to gains it too
    aln = _add_at(aln, node, torch.clamp(acnt_node, 0, A - 1), mm_new, new_id)
    acnt = _scatter(acnt, node, mm_new, ones, op="add")
    # (c) the new node's row: the members, then the node
    zTA = torch.zeros((L, T, A), dtype=torch.int32, device=dev)
    c_vals = torch.where(kA < acnt_node[..., None],
                         torch.where(memb_ok, _i32(grp_ids), zTA),
                         torch.where(kA == acnt_node[..., None],
                                     _i32(node)[..., None], zTA))
    aln = _add_at(aln, flatTA(new64[..., None].expand(L, T, A)),
                  flatTA(kA.expand(L, T, A)),
                  flatTA(mm_new[..., None].expand(L, T, A)), flatTA(c_vals))
    acnt = _scatter(acnt, new64, mm_new, acnt_node + 1, op="add")
    # (d) every new node's base and n_span
    base2 = _scatter(g.base, new64, is_new, b, op="add")
    span2 = _scatter(g.n_span, new64, is_new, _i32(n_span_t), op="add")

    node_n = _i32(g.node_n + n_new)
    g2 = g._replace(base=base2, n_span=span2, n_read=n_read,
                    in_ids=iids, in_w=iw, in_cnt=icnt,
                    out_ids=oids, out_w=ow, out_cnt=ocnt,
                    aligned=aln, aligned_cnt=acnt,
                    node_n=node_n, ok=g.ok & (node_n <= N))
    return g2, path_nodes, Lp, path_new, collision, edge_cap, grp_full


def _splice_order_l(order, n2i, old_n, new_n, path_nodes, path_len,
                    path_new):
    """`fused_loop._splice_order` of each lane (old_n, new_n, path_len
    (L,))."""
    L, N = order.shape
    dev = order.device
    T1 = path_nodes.shape[1]
    r = torch.arange(T1, dtype=torch.int32, device=dev)[None]
    on_path = r < path_len[:, None]
    is_new = on_path & (path_new == 1)
    is_old = on_path & (path_new == 0)
    neg = torch.full_like(path_new, -1)
    last_old_rank = torch.cummax(torch.where(is_old, r, neg), 1).values
    anchor_node = torch.where(
        last_old_rank >= 0,
        path_nodes.gather(1, torch.clamp(last_old_rank, 0, T1 - 1).to(torch.int64)),
        torch.full_like(path_new, C.SRC_NODE_ID))
    anchor_pos = n2i.gather(1, anchor_node.to(torch.int64))
    zN = torch.zeros((L, N), dtype=torch.int32, device=dev)
    counts = _scatter(zN, anchor_pos, is_new, torch.ones_like(path_new),
                      op="add")
    shift = _i32(torch.cumsum(counts, 1))
    shift_excl = shift - counts
    pos = torch.arange(N, dtype=torch.int32, device=dev)[None].expand(L, N)
    old_active = pos < old_n[:, None]
    order2 = _scatter(zN, pos + shift_excl, old_active,
                      torch.where(old_active, order, zN))
    cum_new = _i32(torch.cumsum(is_new.to(torch.int32), 1))
    within = cum_new - 1 - torch.cummax(
        torch.where(is_old, cum_new, torch.zeros_like(cum_new)), 1).values
    shift_before = torch.where(
        anchor_pos > 0,
        shift.gather(1, torch.clamp(anchor_pos - 1, 0, N - 1).to(torch.int64)),
        torch.zeros_like(anchor_pos))
    npos = anchor_pos + shift_before + 1 + within
    order2 = _scatter(order2, npos, is_new,
                      torch.where(is_new, path_nodes, torch.zeros_like(path_new)))
    active2 = pos < new_n[:, None]
    n2i2 = _scatter(zN, order2, active2, torch.where(active2, pos, zN))
    return order2, n2i2


def _order_violated_l(g: DeviceGraph, n2i) -> torch.Tensor:
    """`fused_loop._order_violated` of each lane: (L,) bool."""
    L, N, E = g.out_ids.shape
    dev = n2i.device
    dst = torch.clamp(g.out_ids, 0, N - 1)
    em = (torch.arange(E, device=dev) < g.out_cnt[..., None]) & \
        (torch.arange(N, device=dev)[None, :, None] < g.node_n[:, None, None])
    return (em & (_take(n2i, dst) <= n2i[..., None])).flatten(1).any(1)


def _remain_doubling_l(g: DeviceGraph) -> torch.Tensor:
    """`fused_loop._remain_doubling` of each lane."""
    L, N = g.base.shape
    nodes = torch.arange(N, dtype=torch.int32, device=g.base.device)[None]
    active = nodes < g.node_n[:, None]
    sink = C.SINK_NODE_ID
    ptr = torch.where(active & (nodes != sink), g.out_ids[:, :, 0],
                      torch.full_like(g.base, sink)).to(torch.int64)
    ptr[:, sink] = sink
    steps = (nodes != sink).to(torch.int32).expand(L, N)
    for _ in range(max(1, int(N - 1).bit_length())):
        steps = steps + _take(steps, ptr)
        ptr = _take(ptr, ptr)
    return torch.where(active, steps - 1, torch.zeros_like(steps))


def _row0_l(W: int, dp_end0, abpt: Params, inf: int, local: bool):
    """`fused_dp_kernel.row0_planes` of each lane: (L, 5, W)."""
    L = dp_end0.shape[0]
    dev = dp_end0.device
    kw = torch.arange(W, dtype=torch.int32, device=dev)[None]
    colv = kw <= dp_end0[:, None]
    infr = torch.full((L, W), inf, dtype=torch.int32, device=dev)
    if local:
        z = torch.where(colv, torch.zeros_like(infr), infr)
        return torch.stack([z] * 5, 1)
    o1, e1, oe1 = abpt.gap_open1, abpt.gap_ext1, abpt.gap_oe1
    o2, e2, oe2 = abpt.gap_open2, abpt.gap_ext2, abpt.gap_oe2
    live = colv & (kw >= 1)
    if abpt.gap_mode == C.LINEAR_GAP:
        return torch.stack([torch.where(colv, -e1 * kw, infr)] + [infr] * 4, 1)
    f1 = torch.where(live, -o1 - e1 * kw, infr)
    E1 = infr.clone()
    E1[:, 0] = -oe1
    if abpt.gap_mode == C.CONVEX_GAP:
        f2 = torch.where(live, -o2 - e2 * kw, infr)
        H = torch.maximum(f1, f2)
        E2 = infr.clone()
        E2[:, 0] = -oe2
    else:
        f2 = infr
        H = f1.clone()
        E2 = infr
    H[:, 0] = 0
    return torch.stack([H, E1, E2, f1, f2], 1)


def dp_inputs_l(abpt: Params, g: DeviceGraph, remain, tables, qp, qlens,
                W: int, inf: int, local: bool) -> tuple:
    """`fused_loop.dp_inputs` of each lane (qlens host ints, qp (L, m,
    Qp)): B1's inputs with the lane axis, and the lanes' qlen (L,) on the
    device."""
    dev = qp.device
    base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain_rows = tables
    remain_end = remain[:, C.SINK_NODE_ID]
    head = fl._host_ints(
        [[q, fl._band_w(abpt, q), 0, inf, abpt.gap_ext1, abpt.gap_oe1,
          abpt.gap_ext2, abpt.gap_oe2, 0, 0, max(abpt.zdrop, 0)] + [0] * 5
         for q in qlens], dev)
    ql = head[:, 0].contiguous()
    if local:
        dp_end0 = ql
    else:
        r0 = ql - (remain_rows[:, 0] - remain_end - 1)
        dp_end0 = torch.minimum(torch.clamp(r0, min=0) + head[:, 1], ql)
    scalars = torch.cat([head[:, :2], remain_end[:, None], head[:, 3:8],
                         g.node_n[:, None], dp_end0[:, None], head[:, 10:]], 1)
    row0 = _row0_l(W, dp_end0, abpt, inf, local)
    qp_pad = torch.cat([qp, qp.new_zeros(qp.shape[:2] + (W,))], 2)
    return (scalars, base_packed, pre_idx, pre_cnt, out_idx, out_cnt,
            remain_rows, row0, qp_pad), ql


def best_cell_l(H, beg, end, pre_idx, pre_cnt, n, ext, ql, inf: int,
                tracked: bool):
    """`fused_loop.best_cell` of each lane: (best_i, best_j, best_score),
    each (L,) int32."""
    if tracked:
        return ext[:, 1], ext[:, 2], ext[:, 0]
    L, N, W = H.shape
    lanes = torch.arange(L, device=H.device)
    sink = (n - 1).to(torch.int64)
    sink_rows = pre_idx[lanes, sink].to(torch.int64)             # (L, P)
    slots = torch.arange(pre_idx.shape[2], device=H.device)
    sink_msk = slots < pre_cnt[lanes, sink][:, None]
    ends = torch.minimum(end.gather(1, sink_rows), ql[:, None])
    k = ends - beg.gather(1, sink_rows)
    cell = (lanes[:, None] * N + sink_rows) * W + torch.clamp(k, 0, W - 1)
    vals = torch.where(sink_msk & (k >= 0) & (k < W),
                       _i32(H.reshape(-1)[cell]), torch.full_like(ends, inf))
    kk = torch.argmax(vals, 1)[:, None]  # first slot on ties
    return (_i32(sink_rows.gather(1, kk))[:, 0], ends.gather(1, kk)[:, 0],
            vals.gather(1, kk)[:, 0])


def forward_ops_l(ops, res, order, best_j, ql, max_ops: int):
    """`fused_loop.forward_ops` of each lane."""
    N = order.shape[1]
    n_ops, fin_j = res[:, 0:1], res[:, 2:3]
    tt = torch.arange(max_ops, dtype=torch.int32, device=order.device)[None]
    mid = fin_j + n_ops
    n_fwd = (mid + (ql - _i32(best_j))[:, None])[:, 0]
    src = torch.clamp(n_ops - 1 - (tt - fin_j), 0, max_ops - 1).to(torch.int64)
    in_mid = (tt >= fin_j) & (tt < mid)
    fwd_op = torch.where(in_mid, ops[..., 0].gather(1, src),
                         torch.full_like(src, 2, dtype=torch.int32))
    arg = torch.clamp(ops[..., 1].gather(1, src), 0, N - 1).to(torch.int64)
    fwd_arg = torch.where(in_mid, order.gather(1, arg),
                          torch.zeros_like(fwd_op))
    return fwd_op, fwd_arg, n_fwd


def _rc_read_l(query, weight, ql, mat):
    """`fused_loop._rc_read` of each lane."""
    L, Qp = query.shape
    cols = torch.arange(Qp, device=query.device)[None]
    q1 = ql[:, None]
    ridx = torch.clamp(q1 - 1 - cols, 0, Qp - 1).to(torch.int64)
    okq = cols < q1
    rb = query.gather(1, ridx)
    rc_query = torch.where(okq, torch.where(rb < 4, 3 - rb, torch.full_like(rb, 4)),
                           torch.zeros_like(rb))
    rc_weight = torch.where(okq, weight.gather(1, ridx), torch.ones_like(rb))
    qsrc = torch.clamp(cols - 1, 0, Qp - 1).expand(L, Qp)
    idx = rc_query.gather(1, qsrc).to(torch.int64)
    rc_qp = torch.where(((cols >= 1) & (cols <= q1))[:, None, :],
                        mat[:, idx].permute(1, 0, 2),
                        torch.zeros((L, mat.shape[0], Qp), dtype=torch.int32,
                                    device=query.device))
    return rc_query, rc_weight, rc_qp


# --------------------------------------------------------------------------- #
# the lanes' state and one round                                              #
# --------------------------------------------------------------------------- #

@dataclass
class _Lanes:
    """The live lanes: the stacked graph, order, n2i, remain (L, N) and
    paths (L, reads, Pcap) with path_lens (L, reads), and for each lane its
    set, read cursor, node count (known on the host) and strand flags."""
    g: DeviceGraph
    order: torch.Tensor
    n2i: torch.Tensor
    remain: torch.Tensor
    paths: Optional[torch.Tensor]
    path_lens: Optional[torch.Tensor]
    sets: List[int]
    read_idx: List[int]
    node_n: List[int]
    rc_flags: List[List[int]] = field(default_factory=list)

    def select(self, keep: List[int]) -> "_Lanes":
        """The lanes `keep` (positions), as new tensors."""
        idx = torch.tensor(keep, dtype=torch.int64, device=self.order.device)
        pick = lambda t: None if t is None else t.index_select(0, idx)  # noqa: E731
        return _Lanes(
            g=DeviceGraph(**{k: pick(v) for k, v in self.g.tensors().items()}),
            order=pick(self.order), n2i=pick(self.n2i),
            remain=pick(self.remain), paths=pick(self.paths),
            path_lens=pick(self.path_lens),
            **{k: [getattr(self, k)[i] for i in keep]
               for k in ("sets", "read_idx", "node_n", "rc_flags")})


@dataclass
class _BatchRun:
    """What stays fixed over a pass of the batch loop (fused_loop._Run with
    a set axis): the padded reads (S, R, Qp), their weights, lengths and
    query profiles (S, R, m, Qp), and the capacities' statics."""
    abpt: Params
    seqs: torch.Tensor
    wgts: torch.Tensor
    lens: List[List[int]]
    qp: torch.Tensor
    mat: torch.Tensor
    W: int
    max_ops: int
    plane16: bool
    inf: int
    local: bool
    extend: bool
    zdrop_on: bool
    int16_limit: int
    share: int = 1      # the groups of a sharded run on this device

    @property
    def bt_consts(self) -> torch.Tensor:
        a = self.abpt
        return fl._host_ints([a.gap_ext1, a.gap_oe1, a.gap_ext2, a.gap_oe2,
                              self.inf, self.max_ops], self.seqs.device)


def _lane_reads(run: _BatchRun, ls: _Lanes):
    """The lanes' current reads: (query, weight (L, Qp), qp (L, m, Qp),
    qlens host ints)."""
    dev = run.seqs.device
    si = fl._host_ints(ls.sets, dev).to(torch.int64)
    ri = fl._host_ints(ls.read_idx, dev).to(torch.int64)
    qlens = [run.lens[s][k] for s, k in zip(ls.sets, ls.read_idx)]
    return run.seqs[si, ri], run.wgts[si, ri], run.qp[si, ri], qlens


def plane_groups(todo: List[int], lane_bytes: int,
                 budget: Optional[int]) -> List[List[int]]:
    """The lanes `todo` of one B1 + X1 pass, in groups whose planes
    (`lane_bytes` a lane) fit in `budget` bytes (None: all in one group),
    at least one lane a group. In local mode at 10 kb one lane's planes
    reach ~10 GB, and eight of them do not fit on the card."""
    if budget is None:
        return [todo]
    k = max(1, budget // max(1, lane_bytes))
    return [todo[i:i + k] for i in range(0, len(todo), k)]


def _dp_walk(run: _BatchRun, args, query, node_n, ql, lanes, planes=None):
    """B1 (B3), the best cell and X1 over `lanes` (None: all) of the lanes
    that `args` (B1's inputs) stack, B1's planes into `planes` (None:
    allocated by B1). Returns (ops, res, best_j, best_sc, overflow) with the
    lane axis."""
    abpt = run.abpt
    base_packed, pre_idx, pre_cnt = args[1:4]
    with _step("fused_dp"):
        H, E1, E2, F1, F2, beg, end, ok, ext = fused_dp_lanes(
            *args, gap_mode=abpt.gap_mode, plane16=run.plane16,
            extend=run.extend, zdrop_on=run.zdrop_on, local=run.local,
            lanes=lanes, planes=planes)
    with _step("best_cell"):
        best_i, best_j, best_sc = best_cell_l(
            H, beg, end, pre_idx, pre_cnt, node_n, ext, ql, run.inf,
            run.extend or run.local)
        L = best_i.shape[0]
        sc = torch.cat([_i32(best_i)[:, None], _i32(best_j)[:, None],
                        run.bt_consts.expand(L, 6)], 1)
    with _step("backtrack"):
        ops, res = backtrack_lanes(
            H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed,
            query, run.mat, sc, max_ops=run.max_ops, gap_mode=abpt.gap_mode,
            gap_on_right=bool(abpt.put_gap_on_right),
            put_gap_at_end=bool(abpt.put_gap_at_end), local=run.local,
            lanes=lanes)
    return ops, res, best_j, best_sc, ok == 0


def _align_strand_l(run: _BatchRun, ls: _Lanes, tables, query, qp, qlens,
                    lanes=None):
    """`fused_loop._align_strand` of each lane: B1, the best cell, X1 and
    the forward op streams, the kernels launched over `lanes` (None: all),
    in one pass where the lanes' planes fit on the card and else in groups
    of lanes that do (`plane_groups`), every group's planes in one buffer
    taken while the room is known and given back to the driver after the
    last group (a device sync, in such rounds only). Returns (fwd_op,
    fwd_arg, n_fwd, best_sc, overflow, bt_err, ops_cap, ql) with the lane
    axis."""
    abpt, W = run.abpt, run.W
    dev = query.device
    with _step("tables"):
        args, ql = dp_inputs_l(abpt, ls.g, ls.remain, tables, qp, qlens, W,
                               run.inf, run.local)
    L, R = args[1].shape
    todo = list(range(L)) if lanes is None else [int(x) for x in lanes]
    dt = torch.int16 if run.plane16 else torch.int32
    lane_bytes = memory.plane_bytes(R, W, run.plane16)
    groups = plane_groups(todo, lane_bytes,
                          memory.plane_budget(dev, len(todo) * lane_bytes,
                                              run.share))
    if len(groups) == 1:
        ops, res, best_j, best_sc, overflow = _dp_walk(
            run, args, query, ls.g.node_n, ql, lanes)
    else:  # each group's lanes as a stack of their own
        fl.stats.add("plane_splits", len(groups) - 1)
        buf = torch.empty(5 * len(groups[0]) * R * W, dtype=dt, device=dev)
        outs = None
        for grp in groups:
            idx = fl._host_ints(grp, dev).to(torch.int64)
            pick = lambda t: t.index_select(0, idx)  # noqa: E731
            planes = buf[:5 * len(grp) * R * W].view(5, len(grp), R, W)
            part = _dp_walk(run, [pick(t) for t in args], pick(query),
                            pick(ls.g.node_n), pick(ql), None, planes)
            if outs is None:
                outs = [t.new_zeros((L,) + t.shape[1:]) for t in part]
            for o, t in zip(outs, part):
                o.index_copy_(0, idx, t)
        ops, res, best_j, best_sc, overflow = outs
        del buf, planes
        if dev.type == "cuda":  # the room goes back before a tensor pins it
            torch.cuda.empty_cache()
    with _step("fwd_ops"):
        fwd_op, fwd_arg, n_fwd = forward_ops_l(ops, res, ls.order, best_j, ql,
                                               run.max_ops)
    return (fwd_op, fwd_arg, n_fwd, _i32(best_sc), overflow, res[:, 5] != 0,
            n_fwd > run.max_ops, ql)


def _seed_round(run: _BatchRun, ls: _Lanes) -> _Lanes:
    """Every lane's first read becomes its graph (all lanes seed in the
    first round)."""
    query, weight, _, qlens = _lane_reads(run, ls)
    ql = fl._host_ints(qlens, run.seqs.device)
    g, order, n2i, remain = _seed_state_l(ls.g, query, ql, weight)
    if ls.paths is not None:  # each seed read's path: the chain 2..qlen+1
        Pcap = ls.paths.shape[2]
        p = torch.arange(Pcap, dtype=torch.int32, device=ql.device)[None]
        ls.paths[:, 0] = torch.where(p < ql[:, None], p + 2,
                                     torch.zeros_like(p))
        ls.path_lens[:, 0] = ql
    return replace(ls, g=g, order=order, n2i=n2i, remain=remain,
                   read_idx=[k + 1 for k in ls.read_idx],
                   node_n=[q + 2 for q in qlens],
                   rc_flags=[f + [0] for f in ls.rc_flags])


def _read_round(run: _BatchRun, ls: _Lanes, N: int):
    """`fused_loop._read_step` for every lane at once, a generator that
    yields just before each of its host syncs (the `-s` scores, the flags,
    the Kahn repair's) with every launch before it queued, so that a
    driver can queue the other groups' work first (`_drive_groups`).
    Returns (the lanes' error codes, the new lanes); a lane with an error
    keeps its state."""
    abpt, dev = run.abpt, run.seqs.device
    L = len(ls.sets)
    g = ls.g
    query, weight, qp, qlens = _lane_reads(run, ls)
    with _step("tables"):
        tables = _build_tables_l(g, ls.order, ls.n2i, ls.remain)
    (fwd_op, fwd_arg, n_fwd, best_sc, overflow, bt_err, ops_cap,
     ql) = _align_strand_l(run, ls, tables, query, qp, qlens)
    use_rc = torch.zeros(L, dtype=torch.bool, device=dev)
    query_u, weight_u = query, weight
    if abpt.amb_strand:
        yield
        scores = fl._sync_read(best_sc)
        rc = [i for i in range(L)
              if fl._need_rc(scores[i], qlens[i], ls.node_n[i], abpt.max_mat)]
        if rc:
            rc_query, rc_weight, rc_qp = _rc_read_l(query, weight, ql, run.mat)
            r = _align_strand_l(run, ls, tables, rc_query, rc_qp, qlens,
                                lanes=None if len(rc) == L else rc)
            on = torch.zeros(L, dtype=torch.bool)
            on[rc] = True
            on = on.to(dev)
            overflow = overflow | (on & r[4])
            bt_err = bt_err | (on & r[5])
            ops_cap = ops_cap | (on & r[6])
            use_rc = on & (r[3] > best_sc)
            fwd_op = _where_lanes(use_rc, r[0], fwd_op)
            fwd_arg = _where_lanes(use_rc, r[1], fwd_arg)
            n_fwd = torch.where(use_rc, r[2], n_fwd)
            query_u = _where_lanes(use_rc, rc_query, query)
            weight_u = _where_lanes(use_rc, rc_weight, weight)
            fl.stats.add("rc_reads", len(rc))
            fl.stats.add("rc_rounds", 1)

    with _step("fuse"):
        g2, path_nodes, path_len, path_new, collision, edge_cap, grp_full = \
            _fuse_vectorized_l(g, fwd_op, fwd_arg, n_fwd, query_u, ql,
                               weight_u)
    with _step("edge_sort"):
        fl.check_fresh(g2, g)
        finish_fusion_lanes_(g2.in_ids, g2.in_w, g2.out_ids, g2.out_w,
                             g2.in_cnt, g2.out_cnt, g2.node_n, g2.n_span)
    g2s = g2
    with _step("splice"):
        old_n = fl._host_ints(ls.node_n, dev)
        order2, n2i2 = _splice_order_l(ls.order, ls.n2i, old_n, g2s.node_n,
                                       path_nodes, path_len, path_new)
        bad = _order_violated_l(g2s, n2i2)
        flags = torch.stack([
            _i32(collision), _i32(overflow), _i32(bt_err), _i32(ops_cap),
            _i32(edge_cap), _i32(grp_full), _i32(bad), _i32(g2s.ok),
            _i32(g2s.node_n), _i32(use_rc)], 1)
    yield
    flags = fl._sync_read(flags)

    def err_of(f, n2, g_ok):  # f: a lane's row of `flags`
        return fl.read_error(N, n2, f[1], f[4], f[5], f[2], f[3], g_ok)

    coll = [i for i in range(L) if flags[i][0]]
    errs = [fl.ERR_OK if flags[i][0] else err_of(flags[i], flags[i][8],
                                                 flags[i][7])
            for i in range(L)]
    kahn = [i for i in range(L)
            if flags[i][0] or (flags[i][6] and errs[i] == fl.ERR_OK)]
    Pcap = ls.paths.shape[2] if ls.paths is not None else 1
    seq_path = seq_len = k1 = None
    if coll:
        # kernel F1 for the colliding lanes on a fresh copy of the state's
        # graph, and its S1; those lanes then take the copy's rows
        part = None if len(coll) == L else coll
        with _step("fuse"):
            gc, seq_path, seq_len = fuse_alignment_lanes(
                g, fwd_op, fwd_arg, n_fwd, query_u, weight_u, ql, Pcap,
                lanes=part)
        with _step("edge_sort"):
            finish_fusion_lanes_(gc.in_ids, gc.in_w, gc.out_ids, gc.out_w,
                                 gc.in_cnt, gc.out_cnt, gc.node_n, gc.n_span,
                                 lanes=part)
            cm = torch.zeros(L, dtype=torch.bool)
            cm[coll] = True
            cm = cm.to(dev)
            g2s = DeviceGraph(**{k: _where_lanes(cm, v, getattr(g2s, k))
                                 for k, v in gc.tensors().items()})
    if kahn:
        with _step("topo_sort"):
            k1 = topo_sort_lanes(
                g2s.in_ids, g2s.in_w, g2s.out_ids, g2s.out_w, g2s.in_cnt,
                g2s.out_cnt, g2s.aligned, g2s.aligned_cnt, g2s.node_n,
                lanes=None if len(kahn) == L else kahn)
        yield
        rep = fl._sync_read(torch.stack([k1[7], g2s.node_n, _i32(g2s.ok)], 1))
        fl.stats.add("kahn_rounds", 1)
        for i in kahn:
            ok_k, n2, g_ok = rep[i]
            if flags[i][0]:
                errs[i] = err_of(flags[i], n2, g_ok)
                flags[i][8] = n2
            if errs[i] == fl.ERR_OK and not ok_k:
                errs[i] = fl.ERR_GRAPH_CAP

    commit = [i for i in range(L) if errs[i] == fl.ERR_OK]
    if not commit:
        return errs, ls
    cmask = torch.zeros(L, dtype=torch.bool)
    cmask[commit] = True
    cmask = cmask.to(dev)
    new_g = g2s
    order3, n2i3 = order2, n2i2
    if any(i not in kahn for i in commit):
        with _step("remain"):
            remain3 = _remain_doubling_l(g2s)
    else:
        remain3 = ls.remain
    if kahn:
        km = torch.zeros(L, dtype=torch.bool)
        km[kahn] = True
        km = km.to(dev)
        new_g = g2s._replace(**{k: _where_lanes(km, v, getattr(g2s, k))
                                for k, v in zip(("in_ids", "in_w", "out_ids",
                                                 "out_w"), k1[:4])})
        order3 = _where_lanes(km, k1[4], order2)
        n2i3 = _where_lanes(km, k1[5], n2i2)
        remain3 = _where_lanes(km, k1[6], remain3)
    g_out = DeviceGraph(**{k: _where_lanes(cmask, v, getattr(g, k))
                           for k, v in new_g.tensors().items()})
    if ls.paths is not None:  # the committed reads' paths
        pn = path_nodes[:, :Pcap]
        if coll:
            pn = _where_lanes(cm, seq_path, pn)
            path_len = torch.where(cm, seq_len, path_len)
        ci = torch.tensor(commit, dtype=torch.int64, device=dev)
        ri = fl._host_ints([ls.read_idx[i] for i in commit], dev).to(torch.int64)
        ls.paths[ci, ri] = pn.index_select(0, ci)
        ls.path_lens[ci, ri] = path_len.index_select(0, ci)
    for i in commit:
        fl.stats.add("kahn", int(i in kahn))
        fl.stats.add("collisions", int(bool(flags[i][0])))
    new = replace(
        ls, g=g_out, order=_where_lanes(cmask, order3, ls.order),
        n2i=_where_lanes(cmask, n2i3, ls.n2i),
        remain=_where_lanes(cmask, remain3, ls.remain),
        read_idx=[k + (errs[i] == fl.ERR_OK) for i, k in enumerate(ls.read_idx)],
        node_n=[flags[i][8] if errs[i] == fl.ERR_OK else n
                for i, n in enumerate(ls.node_n)],
        rc_flags=[f + [flags[i][9]] if errs[i] == fl.ERR_OK else f
                  for i, f in enumerate(ls.rc_flags)])
    return errs, new


# --------------------------------------------------------------------------- #
# the host loop: growth over the lanes, retirement, download                  #
# --------------------------------------------------------------------------- #

def _group_loop(abpt: Params, dev: torch.device, share: int, lo: int,
                hi: int, host: dict, caps: tuple):
    """The batch loop of sets lo..hi-1 on `dev`: their lane stack,
    capacities and growth, started from `caps` = (N, E, A, W, plane16).
    A generator that yields just before each host sync (`_read_round`);
    it returns ({set: its lane, as a one-lane `_Lanes`}, the final caps).
    `share` is the number of groups on `dev` (they divide its memory,
    `memory.plane_budget`)."""
    N, E, A, W, plane16 = caps
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    seqs_d, wgts_d = to(host["seqs"][lo:hi]), to(host["wgts"][lo:hi])
    qp_d, mat_d = to(host["qp"][lo:hi]), to(host["mat"])
    lens = host["lens"][lo:hi]
    n_reads = host["n_reads"][lo:hi]
    K, R, Qp = seqs_d.shape
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)  # noqa: E731
    ids = abpt.use_read_ids
    ls = _Lanes(
        g=DeviceGraph(base=z(K, N), in_ids=z(K, N, E), in_w=z(K, N, E),
                      in_cnt=z(K, N), out_ids=z(K, N, E), out_w=z(K, N, E),
                      out_cnt=z(K, N), aligned=z(K, N, A),
                      aligned_cnt=z(K, N), n_read=z(K, N), n_span=z(K, N),
                      node_n=torch.full((K,), 2, dtype=torch.int32,
                                        device=dev),
                      ok=torch.ones(K, dtype=torch.bool, device=dev)),
        order=z(K, N), n2i=z(K, N), remain=z(K, N),
        # a read's path holds at most qlen nodes (Pcap = Qp + 2, as the
        # single-set loop)
        paths=z(K, R, Qp + 2) if ids else None,
        path_lens=z(K, R) if ids else None,
        sets=list(range(K)), read_idx=[0] * K, node_n=[2] * K,
        rc_flags=[[] for _ in range(K)])
    from ..obs import count, observe, rounds
    from ..parallel import scheduler
    done: dict = {}
    growths = 0
    while ls.sets:
        run = _BatchRun(abpt=abpt, seqs=seqs_d, wgts=wgts_d, lens=lens,
                        qp=qp_d, mat=mat_d, W=W, max_ops=N + Qp + 8,
                        plane16=plane16,
                        inf=dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN),
                        local=host["local"], extend=host["extend"],
                        zdrop_on=host["extend"] and abpt.zdrop > 0,
                        int16_limit=host["int16_limit"], share=share)
        errs = [fl.host_error(run, run.lens[s][k], n, N)
                for s, k, n in zip(ls.sets, ls.read_idx, ls.node_n)]
        if any(errs):
            fl.stats.add("host_errs", sum(e != fl.ERR_OK for e in errs))
        elif ls.node_n[0] == 2:
            ls = _seed_round(run, ls)
        else:
            t_round = time.perf_counter()
            rounds.begin_round()
            fl.stats.add("rounds", 1)
            fl.stats.add("live_lanes", len(ls.sets))
            fl.stats.add("reads", len(ls.sets))
            count("lockstep.chunks")
            live = len(ls.sets)
            observe("lockstep.noop_set_fraction", 1.0 - live / K)
            # the server's K cap reads the idle-lane share (JAX
            # fused_loop.py:2075-2079)
            scheduler.observe_noop_fraction(
                1.0 - live / K,
                route="sharded" if host["mesh"] > 1 else "lockstep")
            if live < K:
                count("lockstep.drain_chunks")
            errs, ls = yield from _read_round(run, ls, N)
            # after the round's last host sync
            rounds.record_round("lockstep", live, K,
                                time.perf_counter() - t_round,
                                mesh=host["mesh"])
        bad = set(errs) - {fl.ERR_OK}
        if bad - set(fl._RECOVERABLE_ERRS):
            i = next(i for i, e in enumerate(errs) if e in bad)
            what = ("backtrack found no path" if errs[i] == fl.ERR_BACKTRACK
                    else f"unknown error {errs[i]}")
            raise RuntimeError(f"device lockstep: {what} at read "
                               f"{ls.read_idx[i]} of set {lo + ls.sets[i]}")
        if bad:
            growths += 1
            if growths >= fl._MAX_PASSES:
                raise RuntimeError("device lockstep: capacity growth did "
                                   "not converge")
            N, E, A, W, plane16, grew = fl._grown_caps(bad, N, E, A, W,
                                                       plane16)
            if grew:
                ls = fl._grow_state(ls, N, E, A)
        left = [i for i, s in enumerate(ls.sets)
                if ls.read_idx[i] < n_reads[s]]
        if len(left) < len(ls.sets):
            for i, s in enumerate(ls.sets):
                if ls.read_idx[i] >= n_reads[s]:
                    done[lo + s] = ls.select([i])
            ls = ls.select(left)
    return done, dict(N=N, E=E, A=A, W=W, plane16=plane16)


def _drive_groups(groups: list, devs: list) -> list:
    """Run the groups' loops (`_group_loop` generators) round-robin from
    this thread, each on its device: each runs to its next host sync, so
    that a round of every group is queued before any group's sync, and the
    process-wide counters (`fused_loop.stats`, the wrappers' `.launches`)
    stay exact. Returns each loop's return value."""
    outs = [None] * len(groups)
    live = list(range(len(groups)))
    while live:
        for i in list(live):
            with (torch.cuda.device(devs[i]) if devs[i].type == "cuda"
                  else nullcontext()):
                try:
                    next(groups[i])
                except StopIteration as stop:
                    outs[i] = stop.value
                    live.remove(i)
    return outs


def progressive_poa_fused_batch(seq_sets: List[List[np.ndarray]],
                                weight_sets: List[List[np.ndarray]],
                                abpt: Params,
                                init_caps: Optional[tuple] = None,
                                mesh=None) -> list:
    """Run the fused loop over K read sets in lockstep on abpt's torch
    device; see the module docstring. Returns one (host POAGraph, per-read
    is_rc flags) a set, each equal to `progressive_poa_fused` on that set,
    or None for a set whose downloaded graph fails the output guard (the
    caller reruns that set alone).
    `init_caps` = (N, E, A, W) overrides the starting capacities (tests use
    tiny ones to drive every growth path). `mesh` (a tuple of devices,
    `parallel/shard.py`; JAX's `mesh=`, fused_loop.py:1986-2036) splits
    the sets into one contiguous group a slot, each with its own lane
    stack, capacities and growth on its device; the groups advance
    round-robin from this thread (`_drive_groups`)."""
    from ..obs import device_capture, observe
    from ..parallel.shard import mesh_parts, mesh_size
    S = len(seq_sets)
    n_reads = [len(s) for s in seq_sets]
    if S == 0:
        return []
    if min(n_reads) < 1:
        raise ValueError("device lockstep: every set needs a read")
    qmax = max(len(s) for ss in seq_sets for s in ss)
    Qp, W, local_m = plan_chunk_buckets(abpt, qmax)
    N, E, A = chunk_node_cap(qmax), 8, 8
    if init_caps is not None:
        N, E, A, W = init_caps
    R = max(n_reads)
    mat = np.ascontiguousarray(abpt.mat.astype(np.int32))
    seqs_pad = np.zeros((S, R, Qp), dtype=np.int32)
    wgts_pad = np.ones((S, R, Qp), dtype=np.int32)
    qp_all = np.zeros((S, R, abpt.m, Qp), dtype=np.int32)
    lens = []
    for s, ss in enumerate(seq_sets):
        sp, wp, ln, qp = fl._pad_read_set(ss, weight_sets[s], Qp, mat, abpt.m)
        n = len(ss)
        seqs_pad[s, :n], wgts_pad[s, :n], qp_all[s, :n] = sp, wp, qp
        lens.append(ln.tolist())
    int16_limit = int16_score_limit(abpt)
    plane16 = max_score_bound(abpt, qmax, 2) <= int16_limit
    host = dict(seqs=seqs_pad, wgts=wgts_pad, qp=qp_all, mat=mat, lens=lens,
                n_reads=n_reads, local=local_m,
                extend=abpt.align_mode == C.EXTEND_MODE,
                int16_limit=int16_limit, mesh=mesh_size(mesh))
    observe("lockstep.k", S)
    t0 = time.perf_counter()
    parts = mesh_parts(S, mesh, abpt.torch_device)
    devs = [dev for dev, _ in parts]
    with device_capture("fused_lockstep_batch"):
        outs = _drive_groups(
            [_group_loop(abpt, dev, devs.count(dev), ids[0], ids[-1] + 1,
                         host, (N, E, A, W, plane16)) for dev, ids in parts],
            devs)
    done = {s: lane for d, _ in outs for s, lane in d.items()}
    final_w = {s: c["W"] for d, c in outs for s in d}
    t1 = time.perf_counter()
    out = []
    for s in range(S):
        lane = done[s]
        fl.record_fused_dp(abpt, n_reads[s], qmax, lane.node_n[0],
                           final_w[s], Qp)
        try:
            pg = fl.download_graph(lane_graph(lane.g, 0), abpt)
        except rz.GarbageOutput as e:
            # one set's garbage output: a fault record and a breaker
            # failure, and that set alone goes back to the caller's
            # set-by-set path (fused_loop.py:2135-2160)
            rz.note_absorbed("garbage_output", abpt.torch_device.type,
                             "sequential_rerun", str(e),
                             label="device lockstep", set_index=s)
            rz.breaker().record_failure(abpt.torch_device.type,
                                        "garbage_output")
            out.append(None)
            continue
        if lane.paths is not None:
            fl.replay_read_ids(pg, lane.paths[0, :n_reads[s]].cpu().numpy(),
                               lane.path_lens[0, :n_reads[s]].cpu().numpy())
        out.append((pg, [bool(x) for x in lane.rc_flags[0]]))
    fl.stats.add("download_s", time.perf_counter() - t1)
    fl._drain_events()
    fl.stats.add("wall_s", time.perf_counter() - t0)
    fl.stats["caps"] = {k: max(c[k] for _, c in outs) for k in outs[0][1]}
    return out
