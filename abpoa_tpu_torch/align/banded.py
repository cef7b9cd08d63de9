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

With a mesh (`parallel/shard.py`) the windows split into one contiguous
slice a slot. Every slot's inputs go up through page-locked memory without
a wait and its B2 launch is queued before the first host sync; then, slot
by slot, its `ok` is read, X1w queued and its overflowed windows relaunched.
Every slot's X1w output is copied into its own part of one staging buffer
sized for the whole round, and the CUDA-event times are read after that
copy's wait (`_timed` with `events`).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..graph import POAGraph
from ..obs.tally import Tally
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
            "d2h_s": 0.0, "d2h_bytes": 0, "planes_bytes": 0, "cigar_s": 0.0,
            "staging_bytes": 0}


# over the life of the process: calls (reads), windows, B2 launches, DP rows
# launched, and seconds in the tables (build, pack, upload), in B2 and in
# X1w (CUDA events, cuda only), in copying X1w's results to the host (and
# their bytes, beside the bytes of the walked launches' planes, which stay
# on the device) and in the band write-back and cigar rebuild; the
# largest staging buffer's bytes
stats = Tally(_zero_stats)


def reset_stats() -> None:
    stats.reset()


# page-locked host buffers X1w's results are copied into: a call of
# `align_windows_banded` takes one for its copy and gives it back after
# the cigar rebuild, so two server requests aligning at once never share
# one, and a buffer is reused by the calls after it, whatever their
# thread (a server runs each guarded dispatch on a thread of its own).
# The free list holds at most as many buffers as calls ever ran at once;
# one too small is dropped and a larger one made.
_free_staging: list = []
_staging_lock = threading.Lock()


def _take_staging(n: int) -> torch.Tensor:
    with _staging_lock:
        sizes = [b.numel() for b in _free_staging]
        fits = [k for k, m in enumerate(sizes) if m >= n]
        if fits:
            return _free_staging.pop(min(fits, key=sizes.__getitem__))
        if _free_staging:
            _free_staging.pop(sizes.index(max(sizes)))
    buf = torch.empty(n + n // 4, dtype=torch.int32, pin_memory=True)
    stats.high("staging_bytes", 4 * buf.numel())
    return buf


def _give_staging(buf: Optional[torch.Tensor]) -> None:
    if buf is not None:
        with _staging_lock:
            _free_staging.append(buf)


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


def _timed(dev: torch.device, key: str, fn, events: Optional[list] = None):
    """fn(), with its CUDA-event time on `dev` added to stats[key]: read at
    once (a wait) when `events` is None, else recorded there and read after
    the round's copy to the host (`_read_events`), with no wait of its
    own."""
    if dev.type != "cuda":
        return fn()
    stream = torch.cuda.current_stream(dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record(stream)
    out = fn()
    ev1.record(stream)
    if events is None:
        _read_events([(key, ev0, ev1)])
    else:
        events.append((key, ev0, ev1))
    return out


def _read_events(events: list) -> None:
    for key, ev0, ev1 in events:
        ev1.synchronize()
        stats.add(key, ev0.elapsed_time(ev1) / 1e3)
    events.clear()


def _upload(arrays: list, dev: torch.device, staged: bool) -> list:
    """numpy arrays as tensors on `dev`; `staged` (a slot of a sharded
    round) copies them through page-locked memory without a wait, so that
    the uploads of one slot do not wait for the kernels queued on another
    slot of the same card."""
    if staged and dev.type == "cuda":
        return [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                for a in arrays]
    return [torch.from_numpy(a).to(dev) for a in arrays]


def run_windows(abpt: Params, tabs: list, queries: list, W: int,
                graph_half: Optional[list] = None, dev=None,
                events: Optional[list] = None):
    """One launch over the windows at band width W: (the kernel's inputs,
    its outputs), on the device: kernel B2, or B2u where the windows are
    whole rows (`abpt.wb < 0`, local mode included). `graph_half` (tensors
    on the device, as `pack_graph` lays them out) stands in for the
    windows' graph half: only the query half is uploaded. `dev` (a slot of
    a sharded round; default the run's device) takes the launch, its
    inputs uploaded without a wait; `events` as `_timed`'s."""
    staged = dev is not None
    dev = abpt.torch_device if dev is None else dev
    t0 = time.perf_counter()
    if graph_half is None:
        args = _upload(pack_windows(abpt, tabs, queries, W), dev, staged)
    else:
        args = _args(_upload(pack_queries(abpt, tabs, queries, W), dev,
                             staged), graph_half)
    stats.add("tables_s", time.perf_counter() - t0)
    return args, _timed(dev, "kernel_s",
                        lambda: banded_dp(*args, gap_mode=abpt.gap_mode,
                                          unbanded=abpt.wb < 0), events)


def walk_inputs(abpt: Params, args: list, out, tabs: list, queries: list,
                slots: list, staged: bool = False) -> tuple:
    """X1w's inputs for the windows `slots` of one launch (inputs `args`,
    outputs `out`; `tabs`/`queries` are the launch's): (the positional
    tensors, the keywords, and per walked window its (header, band, op)
    offsets in the packed output and max_ops). B2's scalars carry each
    window's mode, its `ext` output the extend and local best cells. The
    inputs go to the launch's device, through page-locked memory without a
    wait where `staged`."""
    dev = args[0].device
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
    up, mat = _upload([np.concatenate([plan.ravel()]
                                      + [queries[k] for k in slots]
                                      ).astype(np.int32),
                       abpt.mat.astype(np.int32)], dev, staged)
    inputs = (planes, out[5], out[6], out[8], args[2], args[3], args[1],
              args[0], args[11], mat, up[6 * n:], up[: 6 * n].view(n, 6))
    kw = dict(size=o_at, gap_mode=abpt.gap_mode,
              gap_on_right=bool(abpt.put_gap_on_right),
              put_gap_at_end=bool(abpt.put_gap_at_end),
              pre_score=args[12] if len(args) > 12 else None)
    return inputs, kw, layout


def walk_windows(abpt: Params, args: list, out, tabs: list, queries: list,
                 slots: list, staged: bool = False,
                 events: Optional[list] = None) -> tuple:
    """X1w over the windows `slots` of one launch (see `walk_inputs`), on
    the launch's device: the packed output there and its layout."""
    inputs, kw, layout = walk_inputs(abpt, args, out, tabs, queries, slots,
                                     staged)
    stats.add("planes_bytes", out[0].numel() * 5 * 4)
    return _timed(args[0].device, "backtrack_s",
                  lambda: backtrack_windows(*inputs, **kw), events), layout


def _to_host(bufs: list) -> tuple:
    """The launches' packed X1w outputs as numpy, one copy each into its
    own part of a page-locked buffer, sized for the whole round (every
    slot's launches of a sharded round), before one wait a device: (the
    arrays, the buffer they are views of, which the caller gives back
    with `_give_staging` once it has read them; None on the CPU)."""
    if not bufs[0].is_cuda:
        return [b.numpy() for b in bufs], None
    buf = _take_staging(sum(b.numel() for b in bufs))
    views, at = [], 0
    for b in bufs:
        dst = buf[at: at + b.numel()]
        dst.copy_(b, non_blocking=True)
        views.append(dst)
        at += b.numel()
    for dev in dict.fromkeys(b.device for b in bufs):
        torch.cuda.current_stream(dev).synchronize()
    stats.add("d2h_bytes", 4 * at)
    return [v.numpy() for v in views], buf


class _Slot:
    """One mesh slot's part of `align_windows_banded`'s windows: its
    device, the ids of the windows it still has to launch, its band width
    and its last launch (inputs, outputs)."""
    __slots__ = ("dev", "todo", "W", "args", "out")

    def __init__(self, dev, todo: list, W: int) -> None:
        self.dev, self.todo, self.W = dev, todo, W
        self.args = self.out = None


def align_windows_banded(g, abpt: Params, windows,
                         band_width: Optional[int] = None,
                         static=None, mesh=None) -> list:
    """Align independent windows [(beg_id, end_id, query), ...] of the
    sorted graph `g`, or, with `g` a list of sorted graphs, window i on
    graph g[i] (the K-lane chunk of the lockstep and map routes, one whole
    graph a lane): one AlignResult a window, in window order. `band_width`
    overrides the first launch's W (the relaunch path is taken for the
    windows it is too narrow for). `static` (`dp_chunk.StaticGraphTables`
    of the one graph `g`) gives every window that graph's tables, built
    once, and their graph half on the device, and leaves the graph's band
    as it is (no write-back).

    `mesh` (a tuple of devices, `parallel/shard.py`) splits the windows
    into contiguous slices, one a slot: every slot's inputs are uploaded
    and its B2 launch queued before the first host sync; then, slot by
    slot, its `ok` is read, X1w queued over its ok windows and its
    overflowed windows launched again at a doubled W, until every slot is
    done. Each window's result is the unsharded one."""
    from ..parallel.shard import mesh_parts, mesh_size
    global retries
    graphs = g if isinstance(g, list) else [g] * len(windows)
    t0 = time.perf_counter()
    if static is None:
        tabs = [build_row_tables(gi, b, e, abpt)
                for gi, (b, e, _) in zip(graphs, windows)]
    else:
        tabs = [static.tables] * len(windows)
    queries = [q for _, _, q in windows]
    stats.add("tables_s", time.perf_counter() - t0)

    W = band_width or max(initial_band_width(abpt, len(q)) for q in queries)
    slots_ = [_Slot(dev, ids, W) for dev, ids in
              mesh_parts(len(windows), mesh, abpt.torch_device)]
    walks = []   # per launch: (its window ids, X1w's packed output, layout)
    # a sharded round's CUDA-event times are read after its copy to the
    # host; without a mesh each launch reads its own, as it always has
    events: list = []
    sharded = {"staged": True, "events": events} if mesh_size(mesh) > 1 \
        else {}
    n_launch = 0

    def launch(sl: _Slot) -> None:
        nonlocal n_launch
        n_launch += 1
        sl.args, sl.out = run_windows(
            abpt, [tabs[i] for i in sl.todo], [queries[i] for i in sl.todo],
            sl.W, None if static is None else static.lanes(len(sl.todo),
                                                           sl.dev),
            **({"dev": sl.dev, "events": events} if sharded else {}))

    from ..obs import device_capture
    # the profiler's bracket of a window batch (--profile-dir; JAX's
    # "window_batch", abpoa_tpu/align/jax_backend.py:617)
    with device_capture("window_batch"):
        for sl in slots_:
            launch(sl)
        while slots_:
            for sl in slots_:
                ok = check_ok(sl.out[7])
                todo = sl.todo
                done = [k for k in range(len(todo)) if ok[k]]
                if done:
                    packed, layout = walk_windows(
                        abpt, sl.args, sl.out, [tabs[i] for i in todo],
                        [queries[i] for i in todo], done, **sharded)
                    walks.append(([todo[k] for k in done], packed, layout))
                sl.todo = [i for k, i in enumerate(todo) if not ok[k]]
                if sl.todo:
                    qmax = max(len(queries[i]) for i in sl.todo)
                    if sl.W >= qmax + 1:
                        raise RuntimeError(
                            f"banded DP overflowed at full width W={sl.W}")
                    sl.W = next_band_width(sl.W, qmax)
                    retries += 1
                    launch(sl)
            slots_ = [sl for sl in slots_ if sl.todo]
    stats.add("reads", 1)
    stats.add("windows", len(windows))
    stats.add("launches", n_launch)
    stats.add("rows", sum(t.gn for t in tabs))

    t0 = time.perf_counter()
    host, staging = _to_host([packed for _, packed, _ in walks])
    stats.add("d2h_s", time.perf_counter() - t0)
    try:
        _read_events(events)
        # every window's result is read out of the staging buffer here,
        # before it goes back to the free list
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
                                   buf[o_at: o_at + 2 * max_ops],
                                   t.beg_index, len(query), i2n[id(gi)]))
    finally:
        _give_staging(staging)
    stats.add("cigar_s", time.perf_counter() - t0)
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
