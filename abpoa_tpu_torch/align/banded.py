"""Alignment of one read's windows: tables -> DP kernel B2 -> backtrack
kernel X1w, on the device.

Counterpart of `abpoa_tpu/align/jax_backend.py` `align_windows_jax` (the
windows of one seeded read, `_build_snapshot` :275, `_dp_full_batch` :512,
`_result_from_packed` :443), of `align_sequence_to_subgraph_jax` (one
window: the whole graph) and of `abpoa_tpu/align/pallas_backend.py`
`align_sequence_to_subgraph_pallas`, in every mode `_dp_full` runs: global,
extend (with Z-drop) and local, with linear, affine or convex gaps, the
adaptive band or none (`-b < 0`, local mode), with or without `-G`'s path
scores.

Every window's tables are built first, in window order (building them seeds
the graph's mpl/mpr of each window's first row and its successors, as the
JAX package does), from the native graph's C++ tables or a Python graph's
nodes, and packed ragged: the windows' rows one after another
(`pack_windows`). One B2 launch covers them all, one block a window, at the
band width W of the widest window's first launch (unbanded: the longest
query + 1, rounded to 128, where no band overflows). A window whose band
outgrows W (`ok == 0`) is launched again, with the other such windows, at W
doubled (rounded to 128, capped at the longest of their queries + 1, where
the band cannot overflow); `retries` counts those relaunches. Then X1w runs
once a launch, over that launch's ok windows, on that launch's planes: the
best cell of the window's mode and its walk, packed with its final mpl/mpr
into one small buffer. Those buffers come to the host, one copy a launch
into a page-locked buffer before one wait; the planes never leave the
device. Then, window by window, a banded alignment's band is written back
into the graph (`write_band`) and the cigar is rebuilt from the op stream.

The windows may come from different graphs, one each: the K lanes of
`dp_chunk.run_dp_chunk` (the lockstep and map routes), each a whole graph
and one read, go through the same launches. A map graph's tables are built
once (`dp_chunk.StaticGraphTables`) and their graph half stays on the
device: each launch then uploads only the query half (`pack_queries`).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .backtrack_kernel import HEADER, backtrack_windows
from .banded_kernel import banded_dp, check_ok
from .buckets import bucket
from .result import AlignResult
from .tables import build_row_tables, initial_band_width, query_tables

# relaunches after a band overflow, over the life of the process
retries = 0


def _zero_stats() -> dict:
    return {"reads": 0, "windows": 0, "launches": 0, "rows": 0,
            "tables_s": 0.0, "kernel_s": 0.0, "backtrack_s": 0.0,
            "d2h_s": 0.0, "d2h_bytes": 0, "planes_bytes": 0, "cigar_s": 0.0}


# over the life of the process: calls (reads), windows, B2 launches, DP rows
# launched, and seconds in the tables (build, pack, upload), in B2 and in
# X1w (CUDA events, cuda only), in copying X1w's results to the host (and
# their bytes, beside the bytes of the walked launches' planes, which stay
# on the device) and in the band write-back and cigar rebuild
stats = _zero_stats()


def reset_stats() -> None:
    stats.update(_zero_stats())


# page-locked host buffer X1w's results are copied into, grown as graphs
# grow and reused by every read; the arrays handed back are views of it,
# valid until the next read's copy
_pinned = [torch.empty(0, dtype=torch.int32)]


def _staging(n: int) -> torch.Tensor:
    if _pinned[0].numel() < n:
        _pinned[0] = torch.empty(0, dtype=torch.int32)
        _pinned[0] = torch.empty(n + n // 4, dtype=torch.int32, pin_memory=True)
    return _pinned[0][:n]


def next_band_width(W: int, qlen: int) -> int:
    return min(qlen + 1, ((2 * W + 127) // 128) * 128)


def pack_graph(tabs: list) -> list:
    """The graph half of banded_dp's batch-form inputs (numpy int32) for
    windows with row tables `tabs`: each window's gn rows, one after
    another: base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0,
    roff, and with `-G` the path scores (banded_dp's `pre_score`)."""
    gns = [t.gn for t in tabs]
    roff = np.zeros(len(tabs) + 1, dtype=np.int32)
    roff[1:] = np.cumsum(gns)
    Rtot = int(roff[-1])
    P = max(t.pre_idx.shape[1] for t in tabs)
    O = max(t.out_idx.shape[1] for t in tabs)
    pre_idx = np.zeros((Rtot, P), dtype=np.int32)
    out_idx = np.zeros((Rtot, O), dtype=np.int32)
    path_score = tabs[0].pre_score is not None
    pre_score = np.zeros((Rtot, P), dtype=np.int32) if path_score else None
    for t, r0, gn in zip(tabs, roff.tolist(), gns):
        pre_idx[r0: r0 + gn, : t.pre_idx.shape[1]] = t.pre_idx[:gn]
        out_idx[r0: r0 + gn, : t.out_idx.shape[1]] = t.out_idx[:gn]
        if path_score:
            pre_score[r0: r0 + gn, : t.pre_idx.shape[1]] = t.pre_score[:gn]
    cat = lambda name: np.concatenate(  # noqa: E731
        [getattr(t, name)[:t.gn] for t in tabs]).astype(np.int32)
    packed = [cat("base"), pre_idx, cat("pre_cnt"), out_idx, cat("out_cnt"),
              cat("remain"), cat("mpl0"), cat("mpr0"), roff]
    return packed + [pre_score] if path_score else packed


def pack_queries(abpt: Params, tabs: list, queries: list, W: int) -> list:
    """The query half of banded_dp's batch-form inputs (numpy int32) at band
    width W: scalars (B, 16), qp_pad (B, m, Qp + W) and row0 (B, 5, W)."""
    qs = [query_tables(abpt, t, q, W) for t, q in zip(tabs, queries)]
    QW = max(q["qp_pad"].shape[1] for q in qs)
    qp = np.zeros((len(qs), abpt.m, QW), dtype=np.int32)
    for b, q in enumerate(qs):
        qp[b, :, : q["qp_pad"].shape[1]] = q["qp_pad"]
    return [np.stack([q["scalars"] for q in qs]), qp,
            np.stack([q["row0"] for q in qs])]


def _args(query_half: list, graph_half: list) -> list:
    """banded_dp's positional inputs from the two halves."""
    (scalars, qp, row0), rows = query_half, graph_half
    return [scalars, *rows[:8], qp, row0, *rows[8:]]


def pack_windows(abpt: Params, tabs: list, queries: list, W: int) -> list:
    """banded_dp's batch-form inputs (numpy int32) for windows with row
    tables `tabs` and queries `queries` at band width W (`pack_queries`
    and `pack_graph` in banded_dp's order)."""
    return _args(pack_queries(abpt, tabs, queries, W), pack_graph(tabs))


def _timed(dev: torch.device, key: str, fn):
    """fn(), with its CUDA-event time on `dev` added to stats[key]."""
    if dev.type != "cuda":
        return fn()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = fn()
    ev1.record()
    ev1.synchronize()
    stats[key] += ev0.elapsed_time(ev1) / 1e3
    return out


def run_windows(abpt: Params, tabs: list, queries: list, W: int,
                graph_half: Optional[list] = None):
    """One launch over the windows at band width W: (the kernel's inputs,
    its outputs), on the device: kernel B2, or B2u where the windows are
    whole rows (`abpt.wb < 0`, local mode included). `graph_half` (tensors
    on the device, as `pack_graph` lays them out) stands in for the
    windows' graph half: only the query half is uploaded."""
    dev = abpt.torch_device
    t0 = time.perf_counter()
    up = lambda arrays: [torch.from_numpy(a).to(dev) for a in arrays]  # noqa: E731
    if graph_half is None:
        args = up(pack_windows(abpt, tabs, queries, W))
    else:
        args = _args(up(pack_queries(abpt, tabs, queries, W)), graph_half)
    stats["tables_s"] += time.perf_counter() - t0
    return args, _timed(dev, "kernel_s",
                        lambda: banded_dp(*args, gap_mode=abpt.gap_mode,
                                          unbanded=abpt.wb < 0))


def walk_inputs(abpt: Params, args: list, out, tabs: list, queries: list,
                slots: list) -> tuple:
    """X1w's inputs for the windows `slots` of one launch (inputs `args`,
    outputs `out`; `tabs`/`queries` are the launch's): (the positional
    tensors, the keywords, and per walked window its (header, band, op)
    offsets in the packed output and max_ops). B2's scalars carry each
    window's mode, its `ext` output the extend and local best cells."""
    dev = abpt.torch_device
    R, W = out[0].shape
    planes = out[0].as_strided((5, R, W), (R * W, W, 1))
    if planes[4].data_ptr() != out[4].data_ptr():
        raise RuntimeError("banded_dp's planes are not one tensor")
    n = len(slots)
    plan = np.zeros((n, 6), dtype=np.int32)
    layout = []
    q_at, b_at = 0, HEADER * n
    o_at = b_at + 2 * sum(tabs[k].gn for k in slots)
    for w, k in enumerate(slots):
        qlen = len(queries[k])
        max_ops = tabs[k].R + bucket(qlen + 1, 128) + 8
        plan[w] = (k, q_at, HEADER * w, b_at, o_at, max_ops)
        layout.append((HEADER * w, b_at, o_at, max_ops))
        q_at += qlen
        b_at += 2 * tabs[k].gn
        o_at += 2 * max_ops
    up = np.concatenate([plan.ravel()] + [queries[k] for k in slots]
                        ).astype(np.int32)
    up = torch.from_numpy(up).to(dev)
    mat = torch.from_numpy(abpt.mat.astype(np.int32)).to(dev)
    inputs = (planes, out[5], out[6], out[8], args[2], args[3], args[1],
              args[0], args[11], mat, up[6 * n:], up[: 6 * n].view(n, 6))
    kw = dict(size=o_at, gap_mode=abpt.gap_mode,
              gap_on_right=bool(abpt.put_gap_on_right),
              put_gap_at_end=bool(abpt.put_gap_at_end),
              pre_score=args[12] if len(args) > 12 else None)
    return inputs, kw, layout


def walk_windows(abpt: Params, args: list, out, tabs: list, queries: list,
                 slots: list) -> tuple:
    """X1w over the windows `slots` of one launch (see `walk_inputs`): the
    packed output on the device and its layout."""
    inputs, kw, layout = walk_inputs(abpt, args, out, tabs, queries, slots)
    stats["planes_bytes"] += out[0].numel() * 5 * 4
    return _timed(abpt.torch_device, "backtrack_s",
                  lambda: backtrack_windows(*inputs, **kw)), layout


def _to_host(bufs: list) -> list:
    """The launches' packed X1w outputs as numpy, one copy each into the
    page-locked buffer before one wait."""
    if not bufs[0].is_cuda:
        return [b.numpy() for b in bufs]
    host = _staging(sum(b.numel() for b in bufs))
    views, at = [], 0
    for b in bufs:
        dst = host[at: at + b.numel()]
        dst.copy_(b, non_blocking=True)
        views.append(dst)
        at += b.numel()
    torch.cuda.current_stream(bufs[0].device).synchronize()
    stats["d2h_bytes"] += 4 * at
    return [v.numpy() for v in views]


def align_windows_banded(g, abpt: Params, windows,
                         band_width: Optional[int] = None,
                         static=None) -> list:
    """Align independent windows [(beg_id, end_id, query), ...] of the
    sorted graph `g`, or, with `g` a list of sorted graphs, window i on
    graph g[i] (the K-lane chunk of the lockstep and map routes, one whole
    graph a lane): one AlignResult a window, in window order. `band_width`
    overrides the first launch's W (the relaunch path is taken for the
    windows it is too narrow for). `static` (`dp_chunk.StaticGraphTables`
    of the one graph `g`) gives every window that graph's tables, built
    once, and their graph half on the device, and leaves the graph's band
    as it is (no write-back)."""
    global retries
    graphs = g if isinstance(g, list) else [g] * len(windows)
    t0 = time.perf_counter()
    if static is None:
        tabs = [build_row_tables(gi, b, e, abpt)
                for gi, (b, e, _) in zip(graphs, windows)]
    else:
        tabs = [static.tables] * len(windows)
    queries = [q for _, _, q in windows]
    stats["tables_s"] += time.perf_counter() - t0

    W = band_width or max(initial_band_width(abpt, len(q)) for q in queries)
    todo = list(range(len(windows)))
    walks = []   # per launch: (its window ids, X1w's packed output, layout)
    n_launch = 0
    while True:
        n_launch += 1
        args, out = run_windows(abpt, [tabs[i] for i in todo],
                                [queries[i] for i in todo], W,
                                None if static is None
                                else static.lanes(len(todo)))
        ok = check_ok(out[7])
        slots = [k for k in range(len(todo)) if ok[k]]
        if slots:
            packed, layout = walk_windows(abpt, args, out,
                                          [tabs[i] for i in todo],
                                          [queries[i] for i in todo], slots)
            walks.append(([todo[k] for k in slots], packed, layout))
        failed = [i for k, i in enumerate(todo) if not ok[k]]
        if not failed:
            break
        qmax = max(len(queries[i]) for i in failed)
        if W >= qmax + 1:
            raise RuntimeError(f"banded DP overflowed at full width W={W}")
        W = next_band_width(W, qmax)
        retries += 1
        todo = failed
    stats["reads"] += 1
    stats["windows"] += len(windows)
    stats["launches"] += n_launch
    stats["rows"] += sum(t.gn for t in tabs)

    t0 = time.perf_counter()
    host = _to_host([packed for _, packed, _ in walks])
    stats["d2h_s"] += time.perf_counter() - t0

    # every window's result is read out of the staging buffer here, before
    # the next call's copy reuses it
    t0 = time.perf_counter()
    where = {i: (buf, *at) for (ids, _, layout), buf in zip(walks, host)
             for i, at in zip(ids, layout)}
    results = []
    i2n = {}
    write_back = abpt.wb >= 0 and static is None
    for i, (gi, t, query) in enumerate(zip(graphs, tabs, queries)):
        buf, h_at, b_at, o_at, max_ops = where[i]  # window order
        if write_back:
            gi.write_band(t.beg_index, t.gn, buf[b_at: b_at + t.gn],
                          buf[b_at + t.gn: b_at + 2 * t.gn])
        if id(gi) not in i2n:
            i2n[id(gi)] = gi.index_to_node_id
        results.append(_result(abpt, buf[h_at: h_at + HEADER],
                               buf[o_at: o_at + 2 * max_ops], t.beg_index,
                               len(query), i2n[id(gi)]))
    stats["cigar_s"] += time.perf_counter() - t0
    return results


def _result(abpt: Params, head: np.ndarray, ops: np.ndarray, beg_index: int,
            qlen: int, i2n: np.ndarray) -> AlignResult:
    """One window's AlignResult from X1w's header and op stream: the cigar
    rebuilt as `jax_backend.py:443` `_result_from_packed` rebuilds it (one
    push_cigar a op, in walk order, then reversed), in numpy."""
    (n_ops, _, fin_j, n_aln, n_match, si, sj, err, best_score, best_i,
     best_j) = head.tolist()
    if err:
        raise RuntimeError(f"backtrack failed at {n_ops} ops (gap_mode="
                           f"{abpt.gap_mode})")
    res = AlignResult(best_score=best_score, n_aln_bases=n_aln,
                      n_matched_bases=n_match)
    ops = ops[: 2 * n_ops].reshape(n_ops, 2)
    # the walk's entries: the unaligned query end, the ops, the unaligned
    # query start; each op at the column it leaves (j - 1 before the op)
    op = np.concatenate([[2], ops[:, 0], [2]]).astype(np.int64)
    nid = np.concatenate([[0], i2n[beg_index + ops[:, 1]], [0]]).astype(np.uint64)
    step = (op != 1).astype(np.int64)
    step[0] = step[-1] = 0
    qid = best_j - 1 - (np.cumsum(step) - step)
    length = np.ones(n_ops + 2, dtype=np.int64)
    length[0], length[-1] = qlen - best_j, fin_j
    qid[0], qid[-1] = qlen - 1, fin_j - 1
    keep = length > 0
    op, nid, qid, length = op[keep], nid[keep], qid[keep], length[keep]
    # consecutive insertions merge into the first one's entry
    ins = op == 2
    first = ~(ins & np.concatenate([[False], ins[:-1]]))
    run = np.cumsum(first) - 1
    length = np.bincount(run, weights=length).astype(np.uint64)
    op, nid, qid = op[first], nid[first], qid[first].astype(np.uint64)
    m30 = np.uint64(0x3FFFFFFF)
    packed = np.where(
        op == 0, (nid & m30) << np.uint64(34) | (qid & m30) << np.uint64(4),
        np.where(op == 1,
                 (nid & m30) << np.uint64(34) | np.uint64(1 << 4) | np.uint64(C.CDEL),
                 (qid & m30) << np.uint64(34) | (length & m30) << np.uint64(4)
                 | np.uint64(C.CINS)))
    res.cigar = packed[::-1].tolist()
    res.node_e = int(i2n[best_i + beg_index])
    res.query_e = best_j - 1
    res.node_s = int(i2n[si + beg_index])
    res.query_s = sj - 1
    return res


def align_sequence_to_subgraph(g: POAGraph, abpt: Params, beg_node_id: int,
                               end_node_id: int, query: np.ndarray,
                               band_width: Optional[int] = None) -> AlignResult:
    """Align `query` to the subgraph [beg_node_id, end_node_id] (one
    window); `band_width` overrides the first launch's W."""
    return align_windows_banded(g, abpt, [(beg_node_id, end_node_id, query)],
                                band_width)[0]
