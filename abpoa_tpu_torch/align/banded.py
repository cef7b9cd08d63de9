"""Banded alignment of one read's windows: host tables -> DP kernel B2 ->
host backtrack.

Counterpart of `abpoa_tpu/align/jax_backend.py` `align_windows_jax` (the
windows of one seeded read, `_build_snapshot` :275, `_result_from_packed`
:443) and of `abpoa_tpu/align/pallas_backend.py`
`align_sequence_to_subgraph_pallas` (one window: the whole graph), in global
mode with linear, affine or convex gaps and the adaptive band.

Every window's tables are built first, in window order (building them seeds
the graph's mpl/mpr of each window's first row and its successors, as the
JAX package does), and packed ragged: the windows' rows one after another
(`pack_windows`). One B2 launch covers them all, one block a window, at the
band width W of the widest window's first launch. A window whose band
outgrows W (`ok == 0`) is launched again, with the other such windows, at W
doubled (rounded to 128, capped at the longest of their queries + 1, where
the band cannot overflow); `retries` counts those relaunches. The planes of
each launch come to the host in one copy into a page-locked buffer; then,
window by window, the final mpl/mpr are written back into the graph, the
best cell is picked over the end node's predecessors and the backtrack runs.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..graph import POAGraph
from ..params import Params, per_read_covers, per_read_refusal
from .banded_kernel import banded_dp
from .oracle import _backtrack, _DPState, dp_inf_min
from .result import AlignResult
from .tables import build_row_tables, initial_band_width, query_tables

# relaunches after a band overflow, over the life of the process
retries = 0


def _zero_stats() -> dict:
    return {"reads": 0, "windows": 0, "launches": 0, "rows": 0,
            "tables_s": 0.0, "kernel_s": 0.0, "d2h_s": 0.0,
            "backtrack_s": 0.0}


# over the life of the process: calls (reads), windows, B2 launches, DP rows
# launched, and seconds in the tables (build, pack, upload), in the kernel
# (CUDA events, cuda only), in copying its planes to the host and in the
# write-back, best cell and backtrack
stats = _zero_stats()


def reset_stats() -> None:
    stats.update(_zero_stats())


# page-locked host buffer the planes are copied into, grown as graphs grow
# and reused by every read (a pageable copy of the ~0.5 GB of planes of a
# 10 kb read runs several times slower). The planes handed to the backtrack
# are views of it, valid until the next read's copy.
_pinned = [torch.empty(0, dtype=torch.int32)]


def _staging(n: int) -> torch.Tensor:
    if _pinned[0].numel() < n:
        _pinned[0] = torch.empty(0, dtype=torch.int32)
        _pinned[0] = torch.empty(n + n // 4, dtype=torch.int32, pin_memory=True)
    return _pinned[0][:n]


def next_band_width(W: int, qlen: int) -> int:
    return min(qlen + 1, ((2 * W + 127) // 128) * 128)


def pack_windows(abpt: Params, tabs: list, queries: list, W: int) -> list:
    """banded_dp's batch-form inputs (numpy int32) for windows with row
    tables `tabs` and queries `queries` at band width W: each window's gn
    rows, one after another, and its row of the per-window inputs."""
    B = len(tabs)
    gns = [t.gn for t in tabs]
    roff = np.zeros(B + 1, dtype=np.int32)
    roff[1:] = np.cumsum(gns)
    Rtot = int(roff[-1])
    P = max(t.pre_idx.shape[1] for t in tabs)
    O = max(t.out_idx.shape[1] for t in tabs)
    pre_idx = np.zeros((Rtot, P), dtype=np.int32)
    out_idx = np.zeros((Rtot, O), dtype=np.int32)
    for t, r0, gn in zip(tabs, roff.tolist(), gns):
        pre_idx[r0: r0 + gn, : t.pre_idx.shape[1]] = t.pre_idx[:gn]
        out_idx[r0: r0 + gn, : t.out_idx.shape[1]] = t.out_idx[:gn]
    cat = lambda name: np.concatenate(  # noqa: E731
        [getattr(t, name)[:t.gn] for t in tabs]).astype(np.int32)
    qs = [query_tables(abpt, t, q, W) for t, q in zip(tabs, queries)]
    QW = max(q["qp_pad"].shape[1] for q in qs)
    qp = np.zeros((B, abpt.m, QW), dtype=np.int32)
    for b, q in enumerate(qs):
        qp[b, :, : q["qp_pad"].shape[1]] = q["qp_pad"]
    return [np.stack([q["scalars"] for q in qs]), cat("base"), pre_idx,
            cat("pre_cnt"), out_idx, cat("out_cnt"), cat("remain"),
            cat("mpl0"), cat("mpr0"), qp, np.stack([q["row0"] for q in qs]),
            roff]


def run_windows(abpt: Params, tabs: list, queries: list, W: int):
    """One launch over the windows at band width W: the kernel outputs, on
    the device."""
    dev = abpt.torch_device
    t0 = time.perf_counter()
    args = [torch.from_numpy(a).to(dev)
            for a in pack_windows(abpt, tabs, queries, W)]
    stats["tables_s"] += time.perf_counter() - t0
    if dev.type != "cuda":
        return banded_dp(*args, gap_mode=abpt.gap_mode)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = banded_dp(*args, gap_mode=abpt.gap_mode)
    ev1.record()
    ev1.synchronize()
    stats["kernel_s"] += ev0.elapsed_time(ev1) / 1e3
    return out


def _to_host(launches: list) -> list:
    """Per launch (window ids, outputs): (planes (5, Rtot, W) as
    numpy, begend, mplr), the planes of every launch copied with one copy
    each into the page-locked buffer before one wait."""
    outs = [out for _, out in launches]
    if not outs[0][0].is_cuda:
        return [(np.stack([p.numpy() for p in out[:5]]), out[5].numpy(),
                 out[6].numpy()) for out in outs]
    sizes = [5 * out[0].numel() for out in outs]
    host = _staging(sum(sizes))
    views, at = [], 0
    for out, n in zip(outs, sizes):
        R, W = out[0].shape
        dst = host[at: at + n].view(5, R, W)
        # the kernel's five planes are the rows of one (5, R, W) tensor
        src = out[0].as_strided((5, R, W), (R * W, W, 1))
        if src[4].data_ptr() != out[4].data_ptr():
            raise RuntimeError("banded_dp's planes are not one tensor")
        dst.copy_(src, non_blocking=True)
        views.append(dst)
        at += n
    small = [(out[5].cpu(), out[6].cpu()) for out in outs]
    torch.cuda.current_stream(outs[0][0].device).synchronize()
    return [(v.numpy(), be.numpy(), lr.numpy()) for v, (be, lr) in zip(views, small)]


def align_windows_banded(g: POAGraph, abpt: Params, windows,
                         band_width: Optional[int] = None) -> list:
    """Align independent windows [(beg_id, end_id, query), ...] of a sorted
    graph: one AlignResult a window, in window order. `band_width`
    overrides the first launch's W (the relaunch path is taken for the
    windows it is too narrow for)."""
    global retries
    if not per_read_covers(abpt):
        raise per_read_refusal("a per-read alignment")
    inf_min = dp_inf_min(abpt)
    t0 = time.perf_counter()
    tabs = [build_row_tables(g, b, e) for b, e, _ in windows]
    queries = [q for _, _, q in windows]
    stats["tables_s"] += time.perf_counter() - t0

    W = band_width or max(initial_band_width(abpt, len(q)) for q in queries)
    todo = list(range(len(windows)))
    launches = []      # (window ids, kernel outputs)
    where = {}         # window -> (launch, its slot in the launch)
    while True:
        out = run_windows(abpt, [tabs[i] for i in todo],
                          [queries[i] for i in todo], W)
        ok = out[7].tolist()
        launches.append((todo, out))
        for k, i in enumerate(todo):
            if ok[k]:
                where[i] = (len(launches) - 1, k)
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
    stats["launches"] += len(launches)
    stats["rows"] += sum(t.gn for t in tabs)

    t0 = time.perf_counter()
    host = _to_host(launches)
    stats["d2h_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    roffs = [np.cumsum([0] + [tabs[j].gn for j in ids]).tolist()
             for ids, _ in launches]
    results = []
    for i, (t, query) in enumerate(zip(tabs, queries)):
        li, k = where[i]
        planes, begend, mplr = host[li]
        r0, gn = roffs[li][k], t.gn
        # the kernel defines plane rows 0..gn-2, all the backtrack reads
        # (the end node's predecessors and back)
        win = [p[r0: r0 + gn - 1] for p in planes]
        be = begend[2 * r0: 2 * (r0 + gn)]
        lr = mplr[2 * r0: 2 * (r0 + gn)]
        g.node_id_to_max_pos_left[t.nids] = lr[:gn]
        g.node_id_to_max_pos_right[t.nids] = lr[gn:]
        results.append(_result(g, abpt, t, win, be[:gn].tolist(),
                               be[gn:].tolist(), query, inf_min))
    stats["backtrack_s"] += time.perf_counter() - t0
    return results


def _result(g: POAGraph, abpt: Params, t, planes, dp_beg: list, dp_end: list,
            query: np.ndarray, inf_min: int) -> AlignResult:
    """The best cell over the end node's predecessors, then the backtrack
    (jax_backend.py:443 `_result_from_packed`, oracle.py's host form)."""
    qlen, gn = len(query), t.gn
    st = _DPState(planes, dp_beg, dp_end, inf_min)
    pre_index = t.pre_index()
    res = AlignResult()
    best_score = inf_min
    best_i = best_j = 0
    for dp_i in pre_index[gn - 1]:
        end = min(qlen, dp_end[dp_i])
        v = st.H[dp_i, end]
        if v > best_score:
            best_score, best_i, best_j = v, dp_i, end
    res.best_score = best_score
    _backtrack(g, abpt, st, pre_index, t.beg_index, best_i, best_j,
               qlen, query, res, abpt.gap_mode)
    return res


def align_sequence_to_subgraph(g: POAGraph, abpt: Params, beg_node_id: int,
                               end_node_id: int, query: np.ndarray,
                               band_width: Optional[int] = None) -> AlignResult:
    """Align `query` to the subgraph [beg_node_id, end_node_id] (one
    window); `band_width` overrides the first launch's W."""
    return align_windows_banded(g, abpt, [(beg_node_id, end_node_id, query)],
                                band_width)[0]
