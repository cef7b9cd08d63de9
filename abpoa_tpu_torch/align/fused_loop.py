"""The fused progressive loop: the whole per-read sequence on one device.

Counterpart of `abpoa_tpu/align/fused_loop.py` (`progressive_poa_fused`,
`run_fused_chunk` and the per-read steps). The graph stays on the state's
device as dense tensors (`device_graph.DeviceGraph`); every read runs

  tables (`_build_tables`) -> kernel B1/B3 (`fused_dp`, the banded forward
  DP) -> best cell -> kernel X1 (`backtrack`) -> forward op stream ->
  fusion (`_fuse_vectorized`, or the sequential `fuse_alignment` on a
  group-root collision) -> span update and edge sort (kernel S1,
  `edge_sort`, one launch) -> topological order by
  splicing (`_splice_order`), repaired by kernel K1 (`topo_sort`) when the
  splice is not a valid order -> max_remain (`_remain_doubling`)

and the graph is downloaded once at the end for the outputs. With read-id
outputs (`Params.use_read_ids`: MSA, GFA, `-a 1`, `-d > 1`) each committed
read's node path is also written into a (reads x Pcap) buffer on the device
(a copy and an index write, no host sync); the paths come down after the
loop and the per-edge read-id bitsets are rebuilt from them on the host
(`replay_read_ids`). JAX's
`lax.while_loop` over reads is a host loop here, on one stream. Each
`lax.cond` is either computed on both sides and selected on the device, or
decided by one flag read where one side is expensive: the `-s` reverse
strand (`need_rc`), the collision fusion and the Kahn repair. A read's
flags come back in one host sync; the reverse strand and a Kahn repair add
one each. On an error the read's new state is not committed: the host loop
grows the capacity the error names and runs the read again, as JAX resumes.
There is no fallback: a diverged backtrack, an unknown error or growth that
does not converge raises.

Every step is torch code on the state's device except the four kernels,
whose wrappers run their plain PyTorch version for CPU tensors. The step
functions take and return tensors laid out as the JAX functions' arrays, so
the tests hold each against its JAX twin on the same state.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from ..graph import Node, POAGraph
from ..params import Params
from .backtrack_kernel import backtrack
from .buckets import (bucket_pow2, chunk_node_cap, grow_node_cap,
                      plan_chunk_buckets)
from .device_graph import DeviceGraph, fuse_alignment, init_device_graph
from .edge_sort_kernel import edge_sort
from .fused_dp_kernel import fused_dp, row0_planes
from .oracle import (INT16_MIN, INT32_MIN, dp_inf_min, int16_score_limit,
                     max_score_bound)
from .topo_kernel import topo_sort

# error codes of a read (fused_loop.py:85-94)
ERR_OK = 0
ERR_NODE_CAP = 1     # node capacity N exhausted -> grow N
ERR_BAND_CAP = 2     # band wider than W -> grow W
ERR_EDGE_CAP = 3     # edge slots E exhausted -> grow E
ERR_BACKTRACK = 4    # backtrack found no predecessor (a bug) -> raise
ERR_OPS_CAP = 5      # op stream longer than max_ops -> grow N
ERR_ALIGN_CAP = 6    # aligned-group slots A exhausted -> grow A
ERR_GRAPH_CAP = 7    # capacity hit in the sequential fusion or Kahn repair
ERR_PROMOTE = 8      # int16 score bound passed -> int32 planes

_RECOVERABLE_ERRS = (ERR_PROMOTE, ERR_NODE_CAP, ERR_OPS_CAP, ERR_BAND_CAP,
                     ERR_EDGE_CAP, ERR_ALIGN_CAP, ERR_GRAPH_CAP)
# passes over a read set (the first, then one after each capacity growth)
# before the growth counts as not converging
_MAX_PASSES = 24

# counters of the last runs, summed until reset (chip_smoke.py prints them):
# read attempts (a read that reports an error is attempted again after the
# growth), host syncs, Kahn repairs, collisions, reverse-strand alignments,
# attempts refused on the host before any device work, growths by error
# code, promotions, the wall of the loop (with the upload of a restored
# graph and the download), and within it that upload, the graph's download
# and the paths' download plus the read-id replay.
# When `timing` is set, each step of a read also adds its time on the
# stream (`device_s`, by CUDA events read back at the end of the run, so no
# extra sync) and its host time (`host_s`); `host_s["sync"]` is the time
# the host waits in syncs.
STEPS = ("tables", "fused_dp", "best_cell", "backtrack", "fwd_ops", "fuse",
         "edge_sort", "splice", "remain", "topo_sort")
stats: dict = {}
timing = False


def reset_stats() -> None:
    stats.clear()
    stats.update(reads=0, syncs=0, kahn=0, collisions=0, rc_reads=0,
                 host_errs=0, grow={}, promotions=0, wall_s=0.0,
                 upload_s=0.0, download_s=0.0, replay_s=0.0,
                 device_s=dict.fromkeys(STEPS, 0.0),
                 host_s=dict.fromkeys(STEPS + ("sync",), 0.0))


reset_stats()
_pending_events: list = []
# the final FusedState of the last run (the tests compare it with the JAX
# state; chip_smoke.py times the kernels at the headline set's final graph)
last_state = None


@contextmanager
def _step(name: str):
    """Time one step of a read when `timing` is on: host time now, device
    time by a pair of CUDA events drained at the end of the run."""
    if not timing:
        yield
        return
    events = torch.cuda.is_available()
    if events:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    yield
    stats["host_s"][name] += time.perf_counter() - t0
    if events:
        e1.record()
        _pending_events.append((name, e0, e1))


def _drain_events() -> None:
    for name, e0, e1 in _pending_events:
        e1.synchronize()
        stats["device_s"][name] += e0.elapsed_time(e1) / 1e3
    _pending_events.clear()


def _sync_read(t: torch.Tensor) -> list:
    """One host sync: a small tensor's values as Python ints."""
    stats["syncs"] += 1
    t0 = time.perf_counter()
    out = t.tolist()
    stats["host_s"]["sync"] += time.perf_counter() - t0
    return out


def _host_ints(vals, dev) -> torch.Tensor:
    """An int32 tensor of Python ints on `dev`, copied from pinned memory
    so the copy does not wait for the stream."""
    t = torch.tensor(vals, dtype=torch.int32, device="cpu")
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@dataclass
class FusedState:
    """The loop's state (fused_loop.py FusedState): the graph, its topo
    order (index -> node id), node id -> index, max_remain per node id, and
    the host counters. rc_flags[k] is 1 where read k was fused reverse-
    complemented (`-s`). With read-id outputs, paths[k, :path_lens[k]] is
    the node path read k was fused along (`None` otherwise); a row is
    written once, when its read is committed."""
    g: DeviceGraph
    order: torch.Tensor
    n2i: torch.Tensor
    remain: torch.Tensor
    read_idx: int = 0
    err: int = ERR_OK
    kahn_runs: int = 0
    collisions: int = 0
    rc_flags: List[int] = field(default_factory=list)
    paths: Optional[torch.Tensor] = None       # (n_reads, Pcap) int32
    path_lens: Optional[torch.Tensor] = None   # (n_reads,) int32


def init_fused_state(N: int, E: int, A: int, device, n_reads: int = 0,
                     Pcap: int = 0) -> FusedState:
    """An empty state; path buffers for n_reads reads of up to Pcap nodes
    when n_reads > 0."""
    z = lambda: torch.zeros(N, dtype=torch.int32, device=device)  # noqa: E731
    st = FusedState(g=init_device_graph(N, E, A, device), order=z(),
                    n2i=z(), remain=z())
    if n_reads:
        st.paths = torch.zeros((n_reads, Pcap), dtype=torch.int32,
                               device=device)
        st.path_lens = torch.zeros(n_reads, dtype=torch.int32, device=device)
    return st


def state_from_host_graph(pg: POAGraph, N: int, E: int, A: int,
                          device) -> FusedState:
    """A restored host graph (`-i`) as the loop's starting state
    (fused_loop.py:1565 `_state_from_host_graph`). `pg` must be
    topologically sorted: its BFS order (`index_to_node_id`) is the loop's
    order, its edge slots keep the host's weight-sorted order, and its
    max_remain comes along. A graph sorted without the band metadata
    (local mode without Z-drop) gets max_remain computed here, as the loop
    computes it for every graph it builds."""
    n = pg.node_n
    if len(pg.node_id_to_max_remain) < n:
        pg._bfs_set_node_remain()
    a = {k: np.zeros(N, np.int32) for k in (
        "base", "in_cnt", "out_cnt", "aligned_cnt", "n_read", "n_span")}
    for k in ("in_ids", "in_w", "out_ids", "out_w"):
        a[k] = np.zeros((N, E), np.int32)
    a["aligned"] = np.zeros((N, A), np.int32)
    for i, nd in enumerate(pg.nodes):
        ic, oc, ac = len(nd.in_ids), len(nd.out_ids), len(nd.aligned_ids)
        a["base"][i] = nd.base
        a["in_ids"][i, :ic], a["in_w"][i, :ic], a["in_cnt"][i] = \
            nd.in_ids, nd.in_w, ic
        a["out_ids"][i, :oc], a["out_w"][i, :oc], a["out_cnt"][i] = \
            nd.out_ids, nd.out_w, oc
        a["aligned"][i, :ac], a["aligned_cnt"][i] = nd.aligned_ids, ac
        a["n_read"][i], a["n_span"][i] = nd.n_read, nd.n_span_read
    order = np.zeros(N, np.int32)
    order[:n] = pg.index_to_node_id[:n]
    n2i = np.zeros(N, np.int32)
    n2i[order[:n]] = np.arange(n, dtype=np.int32)
    remain = np.zeros(N, np.int32)
    remain[:n] = pg.node_id_to_max_remain[:n]
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    g = DeviceGraph(**{k: t(v) for k, v in a.items()},
                    node_n=torch.tensor(n, dtype=torch.int32, device=device),
                    ok=torch.tensor(True, device=device))
    return FusedState(g=g, order=t(order), n2i=t(n2i), remain=t(remain))


def restored_caps(pg: POAGraph, qmax: int) -> tuple:
    """(N, E, A) for a run from the restored graph `pg`
    (fused_loop.py:1794-1805): E and A the power-of-two buckets of the
    largest degree + 1 and aligned group + 1, at least 8."""
    n0 = pg.node_n
    maxdeg = max(max(len(nd.in_ids), len(nd.out_ids)) for nd in pg.nodes)
    maxaln = max(len(nd.aligned_ids) for nd in pg.nodes)
    return (chunk_node_cap(qmax, n0), max(8, bucket_pow2(maxdeg + 1)),
            max(8, bucket_pow2(maxaln + 1)))


# --------------------------------------------------------------------------- #
# the per-read steps                                                          #
# --------------------------------------------------------------------------- #

def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _excl_cumsum(m: torch.Tensor) -> torch.Tensor:
    m = m.to(torch.int32)
    return _i32(torch.cumsum(m, 0)) - m


def _first_true(m: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along dim (0 when none), as jnp.argmax."""
    return torch.argmax(m.to(torch.int32), dim=dim)


def spill_scatter(arr: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  vals: torch.Tensor, op: str = "set") -> torch.Tensor:
    """Scatter `vals` into a copy of `arr` along axis 0 at `idx` where
    `valid` (fused_loop.py:797): invalid or out-of-range entries each go to
    a spill row of their own past the end, which is cut off. op: "set"
    (the valid indices are distinct) or "add". One spill row per entry
    keeps thousands of dropped entries from piling onto one address, which
    a shared spill row makes a serial chain on the card."""
    S, n = arr.shape[0], idx.shape[0]
    idx = idx.to(torch.int64)
    spill = S + torch.arange(n, device=arr.device)
    tgt = torch.where(valid & (idx >= 0) & (idx < S), idx, spill)
    rest = tuple(arr.shape[1:])
    padded = torch.cat([arr, arr.new_zeros((n,) + rest)])
    vals = vals.to(arr.device, arr.dtype).expand((n,) + rest).contiguous()
    if op == "add":
        padded.index_add_(0, tgt, vals)
    else:
        padded.index_copy_(0, tgt, vals)
    return padded[:S]


def _add_at(arr: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of the 2-D `arr` with `vals` added at (rows, cols) where
    `valid` (cols within the row)."""
    S, K = arr.shape
    rows = rows.to(torch.int64)
    lin = rows * K + cols.to(torch.int64)
    ok = valid & (rows >= 0) & (rows < S)
    return spill_scatter(arr.reshape(-1), lin, ok, vals, op="add").view(S, K)


def _edge_sort(g: DeviceGraph) -> DeviceGraph:
    """fused_loop.py:145: every node's in and out slots sorted by weight,
    in one launch of kernel S1."""
    in_ids, in_w, out_ids, out_w = edge_sort(g.in_ids, g.in_w, g.out_ids,
                                             g.out_w, g.in_cnt, g.out_cnt)
    return g._replace(in_ids=in_ids, in_w=in_w, out_ids=out_ids, out_w=out_w)


def _remain_doubling(g: DeviceGraph) -> torch.Tensor:
    """fused_loop.py:170: max_remain by pointer jumping over the
    heaviest-out-edge forest (slot 0 after the weight sort)."""
    N = g.base.shape[0]
    nodes = torch.arange(N, dtype=torch.int32, device=g.base.device)
    active = nodes < g.node_n
    sink = C.SINK_NODE_ID
    ptr = torch.where(active & (nodes != sink), g.out_ids[:, 0],
                      torch.full_like(nodes, sink)).to(torch.int64)
    ptr[sink] = sink
    steps = (nodes != sink).to(torch.int32)
    for _ in range(max(1, int(N - 1).bit_length())):
        steps = steps + steps[ptr]
        ptr = ptr[ptr]
    return torch.where(active, steps - 1, torch.zeros_like(steps))


def _build_tables(g: DeviceGraph, order: torch.Tensor, n2i: torch.Tensor,
                  remain: torch.Tensor):
    """fused_loop.py:1086 in the kernel's packed form: per topo row the base
    with the source-successor flag in bit 8, predecessor and successor rows
    with their counts, and remain. Returns (base_packed, pre_idx, pre_cnt,
    out_idx, out_cnt, remain_rows)."""
    N, E = g.in_ids.shape
    n = g.node_n
    rows = torch.arange(N, dtype=torch.int32, device=order.device)
    nid = order.to(torch.int64)
    base_r = g.base[nid]
    pre_idx = n2i[g.in_ids[nid].to(torch.int64)]
    pre_cnt = torch.where((rows > 0) & (rows < n), g.in_cnt[nid],
                          torch.zeros_like(rows))
    out_idx = n2i[g.out_ids[nid].to(torch.int64)]
    out_cnt = torch.where((rows > 0) & (rows < n - 1), g.out_cnt[nid],
                          torch.zeros_like(rows))
    remain_rows = remain[nid]
    # rows of the source's successors seed their band at column 1
    slots = torch.arange(E, device=order.device)
    src_out = spill_scatter(torch.zeros(N, dtype=torch.int32,
                                        device=order.device),
                            out_idx[0], slots < g.out_cnt[nid[0]],
                            torch.ones(E, dtype=torch.int32, device=order.device))
    src_out = src_out * (rows > 0)
    base_packed = base_r | (src_out << 8)
    return base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain_rows


def _seed_state(state: FusedState, query: torch.Tensor, qlen: int,
                weight: torch.Tensor) -> FusedState:
    """fused_loop.py:1113: the first read becomes a chain of nodes."""
    g = state.g
    N, E, A = g.caps
    dev = query.device
    nodes = torch.arange(N, dtype=torch.int32, device=dev)
    Q = query.shape[0]
    is_seq = (nodes >= 2) & (nodes < qlen + 2)
    qi = torch.clamp(nodes - 2, 0, Q - 1).to(torch.int64)
    zero = torch.zeros_like(nodes)
    base = torch.where(is_seq, _i32(query[qi]), zero)
    wv = _i32(weight[qi])
    wlast = int(weight[max(qlen - 1, 0)])
    last = qlen + 1
    in_ids = torch.zeros((N, E), dtype=torch.int32, device=dev)
    in_w, out_ids, out_w = (torch.zeros_like(in_ids) for _ in range(3))
    in_ids[:, 0] = torch.where(is_seq, torch.where(nodes == 2,
                                                   torch.full_like(nodes, C.SRC_NODE_ID),
                                                   nodes - 1), zero)
    in_w[:, 0] = torch.where(is_seq, wv, zero)
    out_ids[:, 0] = torch.where(is_seq, torch.where(nodes == last,
                                                    torch.full_like(nodes, C.SINK_NODE_ID),
                                                    nodes + 1), zero)
    wnext = _i32(weight[torch.clamp(qi + 1, 0, Q - 1)])
    out_w[:, 0] = torch.where(is_seq, torch.where(nodes == last,
                                                  torch.full_like(nodes, wlast),
                                                  wnext), zero)
    in_ids[C.SINK_NODE_ID, 0] = last
    in_w[C.SINK_NODE_ID, 0] = wlast
    out_ids[C.SRC_NODE_ID, 0] = 2
    out_w[C.SRC_NODE_ID, 0] = int(weight[0])
    in_cnt = _i32(is_seq | (nodes == C.SINK_NODE_ID))
    out_cnt = _i32(is_seq | (nodes == C.SRC_NODE_ID))
    n_span = _i32(is_seq | (nodes < 2))
    node_n = qlen + 2
    g2 = DeviceGraph(
        base=base, in_ids=in_ids, in_w=in_w, in_cnt=in_cnt, out_ids=out_ids,
        out_w=out_w, out_cnt=out_cnt,
        aligned=torch.zeros((N, A), dtype=torch.int32, device=dev),
        aligned_cnt=torch.zeros_like(nodes), n_read=out_cnt.clone(),
        n_span=n_span, node_n=torch.full((), node_n, dtype=torch.int32, device=dev),
        ok=g.ok & (node_n <= N))
    order = torch.where(nodes == 0, torch.full_like(nodes, C.SRC_NODE_ID),
                        torch.where(nodes < node_n - 1, nodes + 1,
                                    torch.where(nodes == node_n - 1,
                                                torch.full_like(nodes, C.SINK_NODE_ID),
                                                zero)))
    active = nodes < node_n
    n2i = spill_scatter(zero, order, active, torch.where(active, nodes, zero))
    remain = torch.where(active, node_n - 2 - n2i, zero)
    if state.paths is not None:  # the seed read's path: the chain 2..qlen+1
        k = state.read_idx
        state.paths[k, :qlen] = nodes[2: qlen + 2]
        state.path_lens[k] = qlen
    return replace(state, g=g2, order=order, n2i=n2i, remain=remain,
                   read_idx=state.read_idx + 1)


def _fuse_vectorized(g: DeviceGraph, fwd_op, fwd_arg, n_fwd, query, qlen: int,
                     weight):
    """fused_loop.py:815: fuse one read's forward op stream (0 match,
    1 delete, 2 insert) in a fixed number of vector steps. An alignment is a
    simple path, so every edge and group update lands in its own slot; new
    node ids come from a prefix sum, in the reference's allocation order.
    Returns (g', path_nodes, path_len, path_new, collision, edge_cap,
    grp_full) with the flags as 0-d bool tensors and path_len a 0-d tensor.
    """
    N, E, A = g.caps
    dev = fwd_op.device
    T = fwd_op.shape[0]
    t = torch.arange(T, dtype=torch.int32, device=dev)
    valid = t < n_fwd
    is_match = valid & (fwd_op == 0)
    is_ins = valid & (fwd_op == 2)
    consumes = is_match | is_ins
    Q = query.shape[0]

    qpos = torch.clamp(_excl_cumsum(consumes), 0, Q - 1).to(torch.int64)
    b = _i32(query[qpos])
    wt = _i32(weight[qpos])

    node = torch.clamp(fwd_arg, 0, N - 1).to(torch.int64)
    same = is_match & (g.base[node] == b)
    grp_ids = g.aligned[node].to(torch.int64)                 # (T, A)
    acnt_node = g.aligned_cnt[node]                           # (T,)
    kA = torch.arange(A, device=dev)
    grp_ok = kA[None, :] < acnt_node[:, None]
    grp_hit = grp_ok & (g.base[grp_ids] == b[:, None])
    has_aln = grp_hit.any(1)
    aln_id = torch.gather(grp_ids, 1, _first_true(grp_hit, 1)[:, None])[:, 0]
    mm = is_match & ~same
    reuse = mm & has_aln
    mm_new = mm & ~has_aln

    # collision: two mismatch ops of this read touching one aligned group
    grp_min = torch.where(grp_ok, grp_ids, torch.full_like(grp_ids, N)).min(1).values
    grp_root = torch.where(acnt_node > 0, torch.minimum(node, grp_min), node)
    hits = spill_scatter(torch.zeros(N, dtype=torch.int32, device=dev),
                         grp_root, mm, torch.ones_like(t), op="add")
    collision = (hits > 1).any()

    is_new = is_ins | mm_new
    new_id = g.node_n + _excl_cumsum(is_new)
    n_new = is_new.sum(dtype=torch.int32)

    zero_t = torch.zeros_like(t)
    path_node = torch.where(same, _i32(node), torch.where(
        reuse, _i32(aln_id), torch.where(is_new, new_id, zero_t)))
    rank = _excl_cumsum(consumes)
    L = consumes.sum(dtype=torch.int32)
    path_plane = spill_scatter(
        torch.zeros((T + 1, 3), dtype=torch.int32, device=dev), rank,
        consumes, torch.stack([path_node, wt, _i32(is_new)], 1))
    path_nodes, path_w, path_new = path_plane.unbind(1)

    # new nodes' n_span: the value of the nearest old path node before them
    r_ = torch.arange(T + 1, dtype=torch.int32, device=dev)
    is_old_path = (r_ < L) & (path_new == 0)
    last_old = torch.cummax(torch.where(is_old_path, r_, torch.full_like(r_, -1)), 0).values
    span_src = torch.where(last_old >= 0,
                           path_nodes[torch.clamp(last_old, 0, T).to(torch.int64)],
                           torch.full_like(r_, C.SRC_NODE_ID))
    n_span_val = g.n_span[span_src.to(torch.int64)]
    n_span_t = n_span_val[torch.clamp(rank, 0, T).to(torch.int64)]

    # edges SRC -> p0 -> ... -> p(L-1) -> SINK
    e_valid = r_ <= L
    prev = torch.clamp(r_ - 1, 0, T).to(torch.int64)
    fr = torch.where(r_ == 0, torch.full_like(r_, C.SRC_NODE_ID), path_nodes[prev])
    to = torch.where(r_ == L, torch.full_like(r_, C.SINK_NODE_ID), path_nodes)
    wlast = weight[max(qlen - 1, 0)].to(torch.int32)
    ew = torch.where(r_ == L, wlast, path_w)
    prev_new = torch.where(r_ == 0, torch.zeros_like(r_), path_new[prev])
    check = prev_new == 0
    kE = torch.arange(E, device=dev)

    def adj_update(ids, w, cnt, row, other):
        rc = torch.clamp(row, 0, N - 1).to(torch.int64)
        cnt_r = cnt[rc]
        m = (kE[None, :] < cnt_r[:, None]) & (ids[rc] == other[:, None])
        exists = check & m.any(1) & e_valid
        slot = torch.where(exists, _i32(_first_true(m, 1)), cnt_r)
        cap = (e_valid & (slot >= E)).any()
        slot_c = torch.clamp(slot, 0, E - 1)
        new_e = ~exists & e_valid
        # rows are clipped as in fused_loop.py:965-968
        ids2 = _add_at(ids, rc, slot_c, e_valid,
                       torch.where(new_e, other, torch.zeros_like(other)))
        w2 = _add_at(w, rc, slot_c, e_valid, ew)
        cnt2 = spill_scatter(cnt, rc, e_valid, _i32(new_e), op="add")
        return ids2, w2, cnt2, cap

    oids, ow, ocnt, o_cap = adj_update(g.out_ids, g.out_w, g.out_cnt, fr, to)
    iids, iw, icnt, i_cap = adj_update(g.in_ids, g.in_w, g.in_cnt, to, fr)
    n_read = spill_scatter(g.n_read, torch.clamp(fr, 0, N - 1), e_valid,
                           torch.ones_like(r_), op="add")
    edge_cap = o_cap | i_cap

    # aligned-group registration of mismatch-new nodes, new nodes' base and
    # n_span: appends into zero slots plus count bumps
    memb_ok = grp_ok & mm_new[:, None]
    memb = torch.where(memb_ok, grp_ids, torch.full_like(grp_ids, N))
    acnt_memb = g.aligned_cnt[torch.clamp(memb, 0, N - 1)]
    grp_full = (mm_new & (acnt_node + 1 > A)).any() | \
        (memb_ok & (acnt_memb + 1 > A)).any()
    new64 = torch.clamp(new_id, 0, N - 1).to(torch.int64)
    ones = torch.ones_like(t)
    # (a) every member of the group gains the new node
    aln = _add_at(g.aligned, memb.reshape(-1),
                  torch.clamp(acnt_memb, 0, A - 1).reshape(-1),
                  memb_ok.reshape(-1), new_id[:, None].expand(T, A).reshape(-1))
    acnt = spill_scatter(g.aligned_cnt, memb.reshape(-1), memb_ok.reshape(-1),
                         torch.ones(T * A, dtype=torch.int32, device=dev),
                         op="add")
    # (b) the node the mismatch was aligned to gains it too
    aln = _add_at(aln, node, torch.clamp(acnt_node, 0, A - 1), mm_new, new_id)
    acnt = spill_scatter(acnt, node, mm_new, ones, op="add")
    # (c) the new node's row: the members, then the node
    zTA = torch.zeros((T, A), dtype=torch.int32, device=dev)
    c_vals = torch.where(kA[None, :] < acnt_node[:, None],
                         torch.where(memb_ok, _i32(grp_ids), zTA),
                         torch.where(kA[None, :] == acnt_node[:, None],
                                     _i32(node)[:, None], zTA))
    aln = _add_at(aln, new64[:, None].expand(T, A).reshape(-1),
                  kA[None, :].expand(T, A).reshape(-1),
                  mm_new[:, None].expand(T, A).reshape(-1), c_vals.reshape(-1))
    acnt = spill_scatter(acnt, new64, mm_new, acnt_node + 1, op="add")
    # (d) every new node's base and n_span
    base2 = spill_scatter(g.base, new64, is_new, b, op="add")
    span2 = spill_scatter(g.n_span, new64, is_new, _i32(n_span_t), op="add")

    node_n = g.node_n + n_new
    g2 = g._replace(base=base2, n_span=span2, n_read=n_read,
                    in_ids=iids, in_w=iw, in_cnt=icnt,
                    out_ids=oids, out_w=ow, out_cnt=ocnt,
                    aligned=aln, aligned_cnt=acnt,
                    node_n=_i32(node_n), ok=g.ok & (node_n <= N))
    return g2, path_nodes, L, path_new, collision, edge_cap, grp_full


def _splice_order(order, n2i, old_n, new_n, path_nodes, path_len, path_new):
    """fused_loop.py:1036: insert a read's new nodes into the topological
    order right after their nearest old path predecessor."""
    N = order.shape[0]
    dev = order.device
    T1 = path_nodes.shape[0]
    r = torch.arange(T1, dtype=torch.int32, device=dev)
    on_path = r < path_len
    is_new = on_path & (path_new == 1)
    is_old = on_path & (path_new == 0)
    last_old_rank = torch.cummax(torch.where(is_old, r, torch.full_like(r, -1)), 0).values
    anchor_node = torch.where(
        last_old_rank >= 0,
        path_nodes[torch.clamp(last_old_rank, 0, T1 - 1).to(torch.int64)],
        torch.full_like(r, C.SRC_NODE_ID))
    anchor_pos = n2i[anchor_node.to(torch.int64)]
    zN = torch.zeros(N, dtype=torch.int32, device=dev)
    counts = spill_scatter(zN, anchor_pos, is_new, torch.ones_like(r), op="add")
    shift = _i32(torch.cumsum(counts, 0))
    shift_excl = shift - counts
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    old_active = pos < old_n
    order2 = spill_scatter(zN, pos + shift_excl, old_active,
                           torch.where(old_active, order, zN))
    cum_new = _i32(torch.cumsum(is_new.to(torch.int32), 0))
    within = cum_new - 1 - torch.cummax(torch.where(is_old, cum_new, torch.zeros_like(r)), 0).values
    shift_before = torch.where(anchor_pos > 0,
                               shift[torch.clamp(anchor_pos - 1, 0, N - 1).to(torch.int64)],
                               torch.zeros_like(anchor_pos))
    npos = anchor_pos + shift_before + 1 + within
    order2 = spill_scatter(order2, npos, is_new,
                           torch.where(is_new, path_nodes, torch.zeros_like(r)))
    active2 = pos < new_n
    n2i2 = spill_scatter(zN, order2, active2, torch.where(active2, pos, zN))
    return order2, n2i2


def _order_violated(g: DeviceGraph, n2i: torch.Tensor) -> torch.Tensor:
    """fused_loop.py:1457-1462: some edge does not go forward in `n2i`."""
    N, E = g.out_ids.shape
    dev = n2i.device
    nodes = torch.arange(N, device=dev)
    dst = torch.clamp(g.out_ids, 0, N - 1).to(torch.int64)
    em = (torch.arange(E, device=dev)[None, :] < g.out_cnt[:, None]) & \
        (nodes[:, None] < g.node_n)
    return (em & (n2i[dst] <= n2i[:, None])).any()


# --------------------------------------------------------------------------- #
# one read                                                                    #
# --------------------------------------------------------------------------- #

@dataclass
class _Run:
    """What stays fixed over a run of the loop (the JAX statics and traced
    scalars of `run_fused_chunk`)."""
    abpt: Params
    seqs: torch.Tensor      # (n_reads, Qp) padded reads
    wgts: torch.Tensor      # (n_reads, Qp)
    lens: List[int]
    qp: torch.Tensor        # (n_reads, m, Qp) query profiles
    mat: torch.Tensor       # (m, m)
    W: int
    max_ops: int
    plane16: bool
    inf: int
    local: bool
    extend: bool
    zdrop_on: bool
    int16_limit: int

    @property
    def dev(self) -> torch.device:
        return self.seqs.device

    @property
    def bt_consts(self) -> torch.Tensor:
        """The backtrack's scalars after the best cell: [e1, oe1, e2, oe2,
        inf, max_ops], made once per run."""
        if not hasattr(self, "_bt_consts"):
            a = self.abpt
            self._bt_consts = _host_ints([a.gap_ext1, a.gap_oe1, a.gap_ext2,
                                          a.gap_oe2, self.inf, self.max_ops],
                                         self.dev)
        return self._bt_consts


def _band_w(abpt: Params, qlen: int) -> int:
    """wb + int(wf * qlen), with the product in float32 as the JAX loop
    computes it (fused_loop.py:1237)."""
    return abpt.wb + int(np.float32(abpt.wf) * np.float32(qlen))


def dp_inputs(abpt: Params, st: FusedState, tables, qp: torch.Tensor,
              qlen: int, W: int, inf: int, local: bool) -> tuple:
    """The B1/B3 kernel's inputs for one strand of a read against the
    state's graph (fused_loop.py:1236-1243, 1268-1284): (scalars,
    base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain, row0,
    qp_pad)."""
    dev = qp.device
    base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain_rows = tables
    remain_end = st.remain[C.SINK_NODE_ID]
    w = _band_w(abpt, qlen)
    if local:
        dp_end0 = torch.full((), qlen, dtype=torch.int32, device=dev)
    else:
        r0 = qlen - (remain_rows[0] - remain_end - 1)
        dp_end0 = torch.clamp(torch.clamp(r0, min=0) + w, max=qlen)
    head = _host_ints([qlen, w, 0, inf, abpt.gap_ext1, abpt.gap_oe1,
                       abpt.gap_ext2, abpt.gap_oe2, 0, 0, max(abpt.zdrop, 0)]
                      + [0] * 5, dev)
    scalars = torch.cat([head[:2], remain_end.reshape(1), head[3:8],
                         st.g.node_n.reshape(1), dp_end0.reshape(1),
                         head[10:]])
    row0 = row0_planes(W, dp_end0, abpt, inf, local, dev)
    qp_pad = torch.cat([qp, qp.new_zeros((qp.shape[0], W))], 1)
    return (scalars, base_packed, pre_idx, pre_cnt, out_idx, out_cnt,
            remain_rows, row0, qp_pad)


def best_cell(H, beg, end, pre_idx, pre_cnt, n, ext, qlen: int, inf: int,
              tracked: bool):
    """Where the backtrack starts (fused_loop.py:1328-1348): the kernel's
    tracked cell in extend and local mode, else the best of the sink's
    predecessor rows at their band ends (first slot on ties). Returns
    (best_i, best_j, best_score) as 0-d int32 tensors."""
    if tracked:
        return ext[1], ext[2], ext[0]
    W = H.shape[1]
    sink = (n - 1).to(torch.int64)
    sink_rows = pre_idx[sink][0].to(torch.int64)
    slots = torch.arange(pre_idx.shape[1], device=H.device)
    sink_msk = slots < pre_cnt[sink]
    ends = torch.clamp(end[sink_rows], max=qlen)
    k = ends - beg[sink_rows]
    vals = torch.where(
        sink_msk & (k >= 0) & (k < W),
        H[sink_rows, torch.clamp(k, 0, W - 1).to(torch.int64)].to(torch.int32),
        torch.full_like(ends, inf))
    kk = torch.argmax(vals).reshape(1)  # a 1-d index: no host sync
    return (_i32(sink_rows.index_select(0, kk))[0],
            ends.index_select(0, kk)[0], vals.index_select(0, kk)[0])


def _align_strand(run: _Run, st: FusedState, tables, query: torch.Tensor,
                  qp: torch.Tensor, qlen: int):
    """fused_loop.py:1246-1369 for one strand: B1, the best cell, X1 and the
    forward op stream. Returns (fwd_op, fwd_arg, n_fwd, best_sc, overflow,
    bt_err, ops_cap) as tensors on the device."""
    abpt, W = run.abpt, run.W
    with _step("tables"):
        args = dp_inputs(abpt, st, tables, qp, qlen, W, run.inf, run.local)
    base_packed, pre_idx, pre_cnt = args[1:4]
    n = st.g.node_n.reshape(1)
    with _step("fused_dp"):
        H, E1, E2, F1, F2, beg, end, ok, ext = fused_dp(
            *args, gap_mode=abpt.gap_mode, plane16=run.plane16,
            extend=run.extend, zdrop_on=run.zdrop_on, local=run.local)
    with _step("best_cell"):
        overflow = ok[0] == 0
        best_i, best_j, best_sc = best_cell(H, beg, end, pre_idx, pre_cnt, n,
                                            ext, qlen, run.inf,
                                            run.extend or run.local)
        sc = torch.cat([torch.stack([_i32(best_i), _i32(best_j)]),
                        run.bt_consts])
    with _step("backtrack"):
        ops, res = backtrack(
            H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed,
            query, run.mat, sc, max_ops=run.max_ops, gap_mode=abpt.gap_mode,
            gap_on_right=bool(abpt.put_gap_on_right),
            put_gap_at_end=bool(abpt.put_gap_at_end), local=run.local)
    with _step("fwd_ops"):
        fwd_op, fwd_arg, n_fwd = forward_ops(ops, res, st.order, best_j, qlen,
                                             run.max_ops)
    return (fwd_op, fwd_arg, n_fwd, _i32(best_sc), overflow, res[5] != 0,
            n_fwd > run.max_ops)


def forward_ops(ops, res, order, best_j, qlen: int, max_ops: int):
    """The backtrack's op stream reversed into forward order, with
    insertions for the unaligned ends and rows turned into node ids
    (fused_loop.py:1358-1369). Returns (fwd_op, fwd_arg, n_fwd)."""
    N = order.shape[0]
    n_ops, fin_j = res[0], res[2]
    tt = torch.arange(max_ops, dtype=torch.int32, device=order.device)
    mid = fin_j + n_ops
    n_fwd = mid + (qlen - _i32(best_j))
    src = torch.clamp(n_ops - 1 - (tt - fin_j), 0, max_ops - 1).to(torch.int64)
    in_mid = (tt >= fin_j) & (tt < mid)
    fwd_op = torch.where(in_mid, ops[src, 0], torch.full_like(tt, 2))
    fwd_arg = torch.where(
        in_mid, order[torch.clamp(ops[src, 1], 0, N - 1).to(torch.int64)],
        torch.zeros_like(tt))
    return fwd_op, fwd_arg, n_fwd


def _rc_read(query: torch.Tensor, weight: torch.Tensor, qlen: int,
             mat: torch.Tensor):
    """fused_loop.py:1396-1404: reverse complement, its weights and its
    query profile."""
    Qp = query.shape[0]
    cols = torch.arange(Qp, device=query.device)
    ridx = torch.clamp(qlen - 1 - cols, 0, Qp - 1)
    okq = cols < qlen
    rb = query[ridx]
    rc_query = torch.where(okq, torch.where(rb < 4, 3 - rb, torch.full_like(rb, 4)),
                           torch.zeros_like(rb))
    rc_weight = torch.where(okq, weight[ridx], torch.ones_like(rb))
    qsrc = torch.clamp(cols - 1, 0, Qp - 1)
    rc_qp = torch.where(((cols >= 1) & (cols <= qlen))[None, :],
                        mat[:, rc_query[qsrc].to(torch.int64)],
                        torch.zeros((mat.shape[0], Qp), dtype=torch.int32,
                                    device=query.device))
    return rc_query, rc_weight, rc_qp


def _need_rc(best_sc: int, qlen: int, n: int, max_mat: int) -> bool:
    """The `-s` threshold of src/abpoa_align.c:324-345 in exact integers:
    score < min(qlen, n - 2) * max_mat * 0.3333."""
    return best_sc < 0 or best_sc * 10000 < min(qlen, n - 2) * max_mat * 3333


def _read_step(run: _Run, st: FusedState, node_n: int):
    """Align and fuse read st.read_idx (fused_loop.py:1219-1521). Returns
    (err, new_state, new_node_n); on an error the state is the old one."""
    abpt, dev = run.abpt, run.dev
    k = st.read_idx
    qlen = run.lens[k]
    query, weight = run.seqs[k], run.wgts[k]
    g, N = st.g, st.g.caps[0]
    n = node_n
    # errors known on the host before any work (the first two of the
    # priority chain at fused_loop.py:1477)
    if run.plane16 and max(qlen * abpt.max_mat,
                           max(qlen, n) * abpt.gap_ext1 + abpt.gap_open1) \
            > run.int16_limit:
        stats["host_errs"] += 1
        return ERR_PROMOTE, st, node_n
    if n + qlen + 1 > N:
        stats["host_errs"] += 1
        return ERR_NODE_CAP, st, node_n

    with _step("tables"):
        tables = _build_tables(g, st.order, st.n2i, st.remain)
    fwd = _align_strand(run, st, tables, query, run.qp[k], qlen)
    fwd_op, fwd_arg, n_fwd, best_sc, overflow, bt_err, ops_cap = fwd
    use_rc = torch.zeros((), dtype=torch.bool, device=dev)
    query_u, weight_u = query, weight
    if abpt.amb_strand and _need_rc(_sync_read(best_sc), qlen, n,
                                    abpt.max_mat):
        rc_query, rc_weight, rc_qp = _rc_read(query, weight, qlen, run.mat)
        r_op, r_arg, r_nfwd, r_sc, r_ovf, r_bt, r_cap = _align_strand(
            run, st, tables, rc_query, rc_qp, qlen)
        overflow, bt_err, ops_cap = overflow | r_ovf, bt_err | r_bt, ops_cap | r_cap
        use = r_sc > best_sc
        fwd_op = torch.where(use, r_op, fwd_op)
        fwd_arg = torch.where(use, r_arg, fwd_arg)
        n_fwd = torch.where(use, r_nfwd, n_fwd)
        query_u = torch.where(use, rc_query, query)
        weight_u = torch.where(use, rc_weight, weight)
        use_rc = use
        stats["rc_reads"] += 1

    with _step("fuse"):
        g2, path_nodes, path_len, path_new, collision, edge_cap, grp_full = \
            _fuse_vectorized(g, fwd_op, fwd_arg, n_fwd, query_u, qlen,
                             weight_u)
    with _step("edge_sort"):
        g2s = _finish_fusion(g2)
    # the splice and its check, speculatively: they stand unless the read
    # collides (then the Kahn repair orders the sequentially fused graph)
    with _step("splice"):
        order2, n2i2 = _splice_order(st.order, st.n2i, n, g2s.node_n,
                                     path_nodes, path_len, path_new)
        bad = _order_violated(g2s, n2i2)
        flags = torch.stack([
            _i32(collision), _i32(overflow), _i32(bt_err), _i32(ops_cap),
            _i32(edge_cap), _i32(grp_full), _i32(bad), _i32(g2s.ok),
            _i32(g2s.node_n), _i32(use_rc)])
    flags = _sync_read(flags)
    (collision, overflow, bt_err, ops_cap, edge_cap, grp_full, bad, g2_ok,
     n2, use_rc) = flags
    if collision:
        g_seq, seq_path = fuse_alignment(
            g, fwd_op, fwd_arg, min(_sync_read(n_fwd), run.max_ops),
            query_u, qlen, weight_u)
        g2s = _finish_fusion(g_seq)
        n2 = int(g2s.node_n)
        g2_ok = int(g2s.ok)
    err = (ERR_NODE_CAP if n2 + 2 > N else ERR_BAND_CAP if overflow
           else ERR_EDGE_CAP if edge_cap else ERR_ALIGN_CAP if grp_full
           else ERR_BACKTRACK if bt_err else ERR_OPS_CAP if ops_cap
           else ERR_OK)
    if err == ERR_OK and not g2_ok:
        err = ERR_GRAPH_CAP
    if err != ERR_OK:
        return err, st, node_n

    need_kahn = bool(bad or collision)
    if need_kahn:
        gk = g2s
        with _step("topo_sort"):
            (in_ids, in_w, out_ids, out_w, order3, n2i3, remain3,
             ok_k) = topo_sort(gk.in_ids, gk.in_w, gk.out_ids, gk.out_w,
                               gk.in_cnt, gk.out_cnt, gk.aligned,
                               gk.aligned_cnt, gk.node_n.reshape(1))
        if not _sync_read(ok_k)[0]:
            return ERR_GRAPH_CAP, st, node_n
        g3 = gk._replace(in_ids=in_ids, in_w=in_w, out_ids=out_ids,
                         out_w=out_w)
    else:
        g3, order3, n2i3 = g2s, order2, n2i2
        with _step("remain"):
            remain3 = _remain_doubling(g2s)
    if st.paths is not None:  # the read is committed: record its path
        if collision:
            st.paths[k, :len(seq_path)] = torch.tensor(
                seq_path, dtype=torch.int32, device=dev)
            st.path_lens[k] = len(seq_path)
        else:
            st.paths[k] = path_nodes[:st.paths.shape[1]]
            st.path_lens[k] = path_len
    stats["kahn"] += int(need_kahn)
    stats["collisions"] += int(bool(collision))
    new = replace(st, g=g3, order=order3, n2i=n2i3, remain=remain3,
                  read_idx=k + 1, kahn_runs=st.kahn_runs + int(need_kahn),
                  collisions=st.collisions + int(bool(collision)),
                  rc_flags=st.rc_flags + [int(use_rc)])
    return ERR_OK, new, n2


def _finish_fusion(g2: DeviceGraph) -> DeviceGraph:
    """The whole-graph span update (abpoa_graph.c:559-571) and the edge
    sort that follow every fusion (fused_loop.py:1447-1452)."""
    N = g2.base.shape[0]
    nodes = torch.arange(N, dtype=torch.int32, device=g2.base.device)
    g2 = g2._replace(n_span=torch.where(nodes < g2.node_n, g2.n_span + 1,
                                        g2.n_span))
    return _edge_sort(g2)


def run_fused_chunk(run: _Run, st: FusedState, node_n: int):
    """The loop body of fused_loop.py:1189 over reads until the set is done
    or a read reports an error. Returns (err, state, node_n)."""
    n_reads = len(run.lens)
    while st.read_idx < n_reads:
        k = st.read_idx
        if node_n == 2:
            qlen = run.lens[k]
            if qlen + 2 > st.g.caps[0]:  # the seed chain does not fit
                stats["host_errs"] += 1
                return ERR_NODE_CAP, st, node_n
            st = _seed_state(st, run.seqs[k], qlen, run.wgts[k])
            st.rc_flags = st.rc_flags + [0]
            node_n = qlen + 2
            continue
        err, st, node_n = _read_step(run, st, node_n)
        stats["reads"] += 1
        if err != ERR_OK:
            return err, st, node_n
    return ERR_OK, st, node_n


# --------------------------------------------------------------------------- #
# the host loop: capacity growth, resume, download                            #
# --------------------------------------------------------------------------- #

def _grow_state(st: FusedState, N2: int, E2: int, A2: int) -> FusedState:
    """fused_loop.py:1532: the state copied into larger capacities."""
    g = st.g
    N, E, A = g.caps

    def pad(x, cols=None):
        if x.dim() == 0:
            return x
        p = [0, 0] if x.dim() == 2 else []
        if cols is not None:
            p = [0, cols - x.shape[1]]
        return torch.nn.functional.pad(x, p + [0, N2 - N])

    g2 = DeviceGraph(
        base=pad(g.base), in_ids=pad(g.in_ids, E2), in_w=pad(g.in_w, E2),
        in_cnt=pad(g.in_cnt), out_ids=pad(g.out_ids, E2),
        out_w=pad(g.out_w, E2), out_cnt=pad(g.out_cnt),
        aligned=pad(g.aligned, A2), aligned_cnt=pad(g.aligned_cnt),
        n_read=pad(g.n_read), n_span=pad(g.n_span), node_n=g.node_n, ok=g.ok)
    return replace(st, g=g2, order=pad(st.order), n2i=pad(st.n2i),
                   remain=pad(st.remain), err=ERR_OK)


def _grown_caps(err: int, N: int, E: int, A: int, W: int, plane16: bool):
    """fused_loop.py:1732: the capacities an error code asks for. Returns
    (N, E, A, W, plane16, grew) where `grew` means the state must be
    padded to the new N/E/A."""
    grew = False
    if err in (ERR_NODE_CAP, ERR_OPS_CAP, ERR_GRAPH_CAP):
        N, grew = grow_node_cap(N), True
    if err in (ERR_EDGE_CAP, ERR_GRAPH_CAP):
        E, grew = E * 2, True
    if err in (ERR_ALIGN_CAP, ERR_GRAPH_CAP):
        A, grew = A * 2, True
    if err == ERR_BAND_CAP:
        W *= 2
    if err == ERR_PROMOTE:
        plane16 = False
        stats["promotions"] += 1
    if err != ERR_OK:
        stats["grow"][err] = stats["grow"].get(err, 0) + 1
    return N, E, A, W, plane16, grew


def _pad_read_set(seqs, weights, Qp: int, mat: np.ndarray, m: int):
    """fused_loop.py:1669: (seqs_pad, wgts_pad, lens, qp) host arrays."""
    n = len(seqs)
    seqs_pad = np.zeros((n, Qp), dtype=np.int32)
    wgts_pad = np.ones((n, Qp), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    qp = np.zeros((n, m, Qp), dtype=np.int32)
    for i, s in enumerate(seqs):
        seqs_pad[i, : len(s)] = s
        wgts_pad[i, : len(s)] = weights[i]
        lens[i] = len(s)
        qp[i, :, 1: len(s) + 1] = mat[:, s]
    return seqs_pad, wgts_pad, lens, qp


def progressive_poa_fused(seqs: List[np.ndarray], weights: List[np.ndarray],
                          abpt: Params, init_caps: Optional[tuple] = None,
                          init_graph: Optional[POAGraph] = None):
    """Run the fused loop over a read set on abpt's torch device (reference
    abpoa_poa, src/abpoa_align.c:313-353). Returns (host POAGraph, kahn
    runs, per-read is_rc flags) and keeps the final FusedState in
    `last_state`. `init_graph` is a restored host graph (`-i`, more than
    the source and sink) the reads are aligned onto, sorted here if it is
    not; None starts from the empty graph. `init_caps` = (N, E, A, W)
    overrides the starting capacities (tests use tiny ones to drive every
    growth path)."""
    global last_state
    dev = abpt.torch_device
    n_reads = len(seqs)
    qmax = max(len(s) for s in seqs)
    Qp, W, local_m = plan_chunk_buckets(abpt, qmax)
    N, E, A = chunk_node_cap(qmax), 8, 8
    if init_graph is not None:
        if abpt.use_read_ids:  # the restored reads' bitsets have no paths
            raise RuntimeError("fused loop: a restored graph with read-id "
                               "outputs takes the per-read route")
        if not init_graph.is_topological_sorted:
            init_graph.topological_sort(abpt)
        N, E, A = restored_caps(init_graph, qmax)
    if init_caps is not None:
        N, E, A, W = init_caps
    mat = np.ascontiguousarray(abpt.mat.astype(np.int32))
    seqs_pad, wgts_pad, lens, qp_all = _pad_read_set(seqs, weights, Qp, mat,
                                                     abpt.m)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    int16_limit = int16_score_limit(abpt)
    plane16 = max_score_bound(abpt, qmax, 2) <= int16_limit
    extend = abpt.align_mode == C.EXTEND_MODE
    seqs_d, wgts_d, qp_d, mat_d = to(seqs_pad), to(wgts_pad), to(qp_all), to(mat)
    t0 = time.perf_counter()
    if init_graph is not None:
        st = state_from_host_graph(init_graph, N, E, A, dev)
        node_n = init_graph.node_n
        stats["upload_s"] += time.perf_counter() - t0
    else:
        # a read's path holds at most qlen nodes (Pcap = Qp + 2, as the JAX
        # loop)
        st = init_fused_state(N, E, A, dev,
                              n_reads=n_reads if abpt.use_read_ids else 0,
                              Pcap=Qp + 2)
        node_n = 2
    for _ in range(_MAX_PASSES):
        run = _Run(abpt=abpt, seqs=seqs_d, wgts=wgts_d, lens=lens.tolist(),
                   qp=qp_d, mat=mat_d, W=W, max_ops=N + Qp + 8,
                   plane16=plane16,
                   inf=dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN),
                   local=local_m, extend=extend,
                   zdrop_on=extend and abpt.zdrop > 0,
                   int16_limit=int16_limit)
        err, st, node_n = run_fused_chunk(run, st, node_n)
        if err == ERR_OK and st.read_idx >= n_reads:
            break
        if err == ERR_BACKTRACK:
            raise RuntimeError(
                f"fused loop: backtrack found no path at read {st.read_idx}")
        if err not in _RECOVERABLE_ERRS:
            raise RuntimeError(
                f"fused loop: unknown error {err} at read {st.read_idx}")
        N, E, A, W, plane16, grew = _grown_caps(err, N, E, A, W, plane16)
        if grew:
            st = _grow_state(st, N, E, A)
    else:
        raise RuntimeError("fused loop: capacity growth did not converge")
    t1 = time.perf_counter()
    pg = download_graph(st.g, abpt)
    t2 = time.perf_counter()
    if st.paths is not None:
        replay_read_ids(pg, st.paths.cpu().numpy(), st.path_lens.cpu().numpy())
    stats["download_s"] += t2 - t1
    stats["replay_s"] += time.perf_counter() - t2
    _drain_events()
    stats["wall_s"] += time.perf_counter() - t0
    stats["caps"] = dict(N=N, E=E, A=A, W=W, plane16=plane16)
    last_state = st
    return pg, st.kahn_runs, [bool(x) for x in st.rc_flags]


def download_graph(g: DeviceGraph, abpt: Params) -> POAGraph:
    """fused_loop.py:2292: one device-to-host copy of the graph, rebuilt as
    a host POAGraph in the reference's BFS order for the output walks."""
    n = int(g.node_n)
    host = {k: v[:n].cpu().tolist() for k, v in g.tensors().items()
            if v.dim() > 0}
    pg = POAGraph()
    pg.nodes = []
    for i in range(n):
        nd = Node(i, host["base"][i])
        ic, oc, ac = host["in_cnt"][i], host["out_cnt"][i], host["aligned_cnt"][i]
        nd.in_ids = host["in_ids"][i][:ic]
        nd.in_w = host["in_w"][i][:ic]
        nd.out_ids = host["out_ids"][i][:oc]
        nd.out_w = host["out_w"][i][:oc]
        nd.read_ids = [0] * oc
        nd.aligned_ids = host["aligned"][i][:ac]
        nd.n_read = host["n_read"][i]
        nd.n_span_read = host["n_span"][i]
        pg.nodes.append(nd)
    pg.topological_sort(abpt)
    return pg


def replay_read_ids(pg: POAGraph, paths: np.ndarray, lens: np.ndarray) -> None:
    """Set the per-edge read-id bitsets of `pg` from the reads' fusion paths
    (fused_loop.py:1926 `_replay_read_ids`; the reference sets them during
    fusion, abpoa_graph.c:465-469). Read r's edges are the consecutive pairs
    SRC -> p0 -> ... -> p(L-1) -> SINK of paths[r, :lens[r]]. The (edge,
    read) pairs accumulate into a uint64 word matrix, then one Python pass
    turns each edge's words into the graph's int bitset. `pg` must be in
    its final edge order, with all bitsets still zero."""
    n_reads = len(lens)
    n_nodes = pg.node_n
    frs, tos, rids = [], [], []
    for r in range(n_reads):
        L = int(lens[r])
        p = paths[r, :L].astype(np.int64)
        frs.append(np.concatenate(([C.SRC_NODE_ID], p)))
        tos.append(np.concatenate((p, [C.SINK_NODE_ID])))
        rids.append(np.full(L + 1, r, np.int64))
    fr = np.concatenate(frs)
    to = np.concatenate(tos)
    rid = np.concatenate(rids)
    uniq, inverse = np.unique(fr * n_nodes + to, return_inverse=True)
    words = np.zeros((len(uniq), (n_reads + 63) >> 6), np.uint64)
    np.bitwise_or.at(words, (inverse, rid >> 6),
                     np.uint64(1) << (rid & 63).astype(np.uint64))
    for e, key in enumerate(uniq.tolist()):
        nd = pg.nodes[key // n_nodes]
        slot = nd.out_ids.index(key % n_nodes)
        nd.read_ids[slot] = int.from_bytes(words[e].tobytes(), "little")
