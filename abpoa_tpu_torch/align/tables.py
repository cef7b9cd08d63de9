"""Host tables for the banded DP kernel.

The snapshot `abpoa_tpu/align/pallas_backend.py` builds for its Pallas
kernel (:82-183) and `abpoa_tpu/align/jax_backend.py` `_build_snapshot`
(:275-420) for its XLA DP, vectorised with numpy, from a Python graph's
nodes or from the native graph's C++ tables (`native_row_tables`): per-row
base, predecessor and successor tables, remain, the seeded mpl/mpr and,
with `-G`, each predecessor slot's path score (`RowTables`, independent of
the band width), then the query profile, row 0 and the scalars for one
band width W (`query_tables`). Unbanded tables (`-b < 0`, local mode) seed
no band and carry remain only for Z-drop, as `_build_snapshot`'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import Optional

import numpy as np

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .buckets import bucket, bucket_pow2
from .oracle import _build_index_map, dp_inf_min


# B2's mode word (scalars[12]): global, extend, local, as B1 numbers them
KERNEL_MODE = {C.GLOBAL_MODE: 0, C.EXTEND_MODE: 1, C.LOCAL_MODE: 2}


def initial_band_width(abpt: Params, qlen: int) -> int:
    """Lanes of the first launch: the adaptive band spans ~2w+1 plus drift
    slack, rounded to 128 (pallas_backend.py:146); unbanded, the whole row
    (qlen + 1 columns rounded to 128), which never overflows."""
    if abpt.wb < 0:
        return ((qlen + 1 + 127) // 128) * 128
    w = abpt.wb + int(abpt.wf * qlen)
    return max(256, ((4 * w + 2 + 127) // 128) * 128)


def zdrop_on(abpt: Params) -> bool:
    return abpt.align_mode == C.EXTEND_MODE and abpt.zdrop > 0


@dataclass
class RowTables:
    gn: int
    R: int
    beg_index: int
    remain_end: int
    nids: np.ndarray      # (gn,) node id of each dp row
    base: np.ndarray      # (R,) int32
    pre_idx: np.ndarray   # (R, P) int32, dp-row index of each predecessor
    pre_cnt: np.ndarray   # (R,) int32
    out_idx: np.ndarray   # (R, O) int32
    out_cnt: np.ndarray   # (R,) int32
    remain: np.ndarray    # (R,) int32
    mpl0: np.ndarray      # (R,) int32
    mpr0: np.ndarray      # (R,) int32
    # (R, P) int32 path score of each predecessor slot (-G), else None
    pre_score: Optional[np.ndarray] = None


def _row_of(counts: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(counts)), counts)


def _pack(rows: np.ndarray, vals: np.ndarray, n_rows: int, R: int):
    """(R, width) table + (R,) counts from row-sorted (row, value) pairs."""
    cnt = np.bincount(rows, minlength=n_rows).astype(np.int32)
    width = bucket_pow2(max(1, int(cnt.max(initial=0))))
    table = np.zeros((R, width), dtype=np.int32)
    start = np.cumsum(cnt) - cnt
    table[rows, np.arange(len(rows)) - start[rows]] = vals
    counts = np.zeros(R, dtype=np.int32)
    counts[:n_rows] = cnt
    return table, counts


def _row_major(idx: np.ndarray, keep: np.ndarray, R: int):
    """(R, width) table + (R,) counts of the entries `keep` marks in each
    row of `idx`, in their order (rows whose kept entries are not a prefix
    are compacted)."""
    gn = idx.shape[0]
    cnt = keep.sum(axis=1).astype(np.int32)
    width = bucket_pow2(max(1, int(cnt.max(initial=0))))
    vals = np.where(keep, idx, 0)
    gaps = np.nonzero((keep != (np.arange(keep.shape[1]) < cnt[:, None])).any(axis=1))[0]
    if gaps.size:
        order = np.argsort(~keep[gaps], axis=1, kind="stable")
        vals[gaps] = np.take_along_axis(vals[gaps], order, 1)
    table = np.zeros((R, width), dtype=np.int32)
    w = min(width, vals.shape[1])
    table[:gn, :w] = vals[:, :w]
    counts = np.zeros(R, dtype=np.int32)
    counts[:gn] = cnt
    return table, counts


def native_row_tables(g, beg_node_id: int, end_node_id: int,
                      banded: bool = True) -> RowTables:
    """`build_row_tables` of a native graph, from the arrays C++ builds
    (apg_build_tables; numpy only): the masks become counts, and out edges
    that leave the window are dropped. A native graph never carries `-G`
    or Z-drop (`pipeline.want_native`)."""
    t = g.build_tables(beg_node_id, end_node_id, banded)
    gn, R = t["gn"], bucket(t["gn"], 64)
    pre_idx, pre_cnt = _row_major(t["pre_idx"], t["pre_msk"], R)
    out_idx, out_cnt = _row_major(t["out_idx"],
                                  t["out_msk"] & (t["out_idx"] < gn), R)

    def rows(a):
        out = np.zeros(R, dtype=np.int32)
        out[:gn] = a
        return out

    beg = t["beg_index"]
    return RowTables(
        gn=gn, R=R, beg_index=beg, remain_end=t["remain_end"],
        nids=g.index_to_node_id[beg: beg + gn].astype(np.int64),
        base=rows(t["base"]), pre_idx=pre_idx, pre_cnt=pre_cnt,
        out_idx=out_idx, out_cnt=out_cnt, remain=rows(t["remain"]),
        mpl0=rows(t["mpl0"]), mpr0=rows(t["mpr0"]))


def build_row_tables(g: POAGraph, beg_node_id: int, end_node_id: int,
                     abpt: Optional[Params] = None) -> RowTables:
    """Row tables of the subgraph [beg_node_id, end_node_id] for `abpt`'s
    band, path scores and Z-drop (banded, no `-G`, when None); a banded
    build also seeds the graph's mpl/mpr of the first row and its
    successors, as abPOA does."""
    banded = abpt is None or abpt.wb >= 0
    if getattr(g, "is_native", False):
        return native_row_tables(g, beg_node_id, end_node_id, banded)
    n2i = g.node_id_to_index
    beg_index = int(n2i[beg_node_id])
    end_index = int(n2i[end_node_id])
    gn = end_index - beg_index + 1
    R = bucket(gn, 64)
    nids = np.asarray(g.index_to_node_id[beg_index: end_index + 1], dtype=np.int64)
    nodes = [g.nodes[n] for n in nids.tolist()]
    in_cnt = np.fromiter((len(nd.in_ids) for nd in nodes), dtype=np.int64, count=gn)
    out_cnt = np.fromiter((len(nd.out_ids) for nd in nodes), dtype=np.int64, count=gn)
    in_idx = n2i[np.fromiter(chain.from_iterable(nd.in_ids for nd in nodes),
                             dtype=np.int64, count=int(in_cnt.sum()))].astype(np.int64)
    out_idx = n2i[np.fromiter(chain.from_iterable(nd.out_ids for nd in nodes),
                              dtype=np.int64, count=int(out_cnt.sum()))].astype(np.int64)

    if beg_index == 0 and bool((in_cnt[1:] > 0).all()):
        # from the source every node with an in-edge is reachable (each
        # in-edge comes from an earlier row): the BFS mask is all ones
        index_map = np.ones(g.node_n, dtype=np.uint8)
    else:
        index_map = _build_index_map(g, beg_index, end_index)
    row_reach = index_map[beg_index: end_index + 1].astype(bool)
    row_reach[0] = False  # the source row carries no tables

    in_row = _row_of(in_cnt)
    keep = row_reach[in_row] & index_map[in_idx].astype(bool)
    pre_idx, pre_cnt = _pack(in_row[keep], in_idx[keep] - beg_index, gn, R)
    pre_score = None
    if abpt is not None and abpt.inc_path_score:
        # _build_snapshot :350-360: the kept in-edges' slots, in order
        slot = np.arange(len(in_row)) - (np.cumsum(in_cnt) - in_cnt)[in_row]
        scores = [g.incre_path_score(int(nids[r]), int(k))
                  for r, k in zip(in_row[keep].tolist(), slot[keep].tolist())]
        pre_score, _ = _pack(in_row[keep], np.asarray(scores, dtype=np.int64),
                             gn, R)
    out_row = _row_of(out_cnt)
    # a window's rows may lead past its end node: those edges leave the table
    keep = row_reach[out_row] & (out_row < gn - 1) & (out_idx - beg_index < gn)
    out_tab, out_n = _pack(out_row[keep], out_idx[keep] - beg_index, gn, R)

    def rows(a):
        out = np.zeros(R, dtype=np.int32)
        out[:gn] = a
        return out

    mpl0 = mpr0 = remain = np.zeros(R, dtype=np.int32)
    remain_end = 0
    if banded:  # band seed (abpoa_align_simd.c first-row init)
        mpl_g, mpr_g = g.node_id_to_max_pos_left, g.node_id_to_max_pos_right
        mpl_g[beg_node_id] = mpr_g[beg_node_id] = 0
        src_outs = np.asarray(g.nodes[beg_node_id].out_ids, dtype=np.int64)
        src_outs = src_outs[index_map[n2i[src_outs]].astype(bool)]
        mpl_g[src_outs] = mpr_g[src_outs] = 1
        mpl0, mpr0 = rows(mpl_g[nids]), rows(mpr_g[nids])
    if banded or zdrop_on(abpt):  # Z-drop reads remain unbanded too (:370)
        g_remain = g.node_id_to_max_remain
        remain, remain_end = rows(g_remain[nids]), int(g_remain[end_node_id])
    return RowTables(
        gn=gn, R=R, beg_index=beg_index, remain_end=remain_end,
        nids=nids, base=rows([nd.base for nd in nodes]),
        pre_idx=pre_idx, pre_cnt=pre_cnt, out_idx=out_tab, out_cnt=out_n,
        remain=remain, mpl0=mpl0, mpr0=mpr0, pre_score=pre_score)


def query_tables(abpt: Params, t: RowTables, query: np.ndarray, W: int) -> dict:
    """scalars (16,), qp_pad (m, Qp + W) and row0 (5, W) for one band width
    (pallas_backend.py:156-183); row 0 takes the gap mode's form, with -inf
    in the planes the mode leaves unused, or zeros in local mode
    (jax_backend.py:79-101)."""
    qlen = len(query)
    banded = abpt.wb >= 0
    w = abpt.wb + int(abpt.wf * qlen) if banded else qlen
    inf_min = dp_inf_min(abpt)
    o1, e1, oe1 = abpt.gap_open1, abpt.gap_ext1, abpt.gap_oe1
    o2, e2, oe2 = abpt.gap_open2, abpt.gap_ext2, abpt.gap_oe2
    dp_end0 = qlen
    if banded:
        r0 = qlen - (int(t.remain[0]) - t.remain_end - 1)
        dp_end0 = min(qlen, max(int(t.mpr0[0]), r0) + w)

    cols = np.arange(W, dtype=np.int64)
    live = (cols >= 1) & (cols <= dp_end0)
    row0 = np.full((5, W), inf_min, dtype=np.int64)
    if abpt.align_mode == C.LOCAL_MODE:
        row0[:, cols <= dp_end0] = 0
    elif abpt.gap_mode == C.LINEAR_GAP:
        row0[0] = np.where(cols <= dp_end0, -e1 * cols, inf_min)
    else:
        f1 = np.where(live, -o1 - e1 * cols, inf_min)
        row0[0] = f1
        row0[1, 0] = -oe1
        row0[3, 1:] = f1[1:]
        if abpt.gap_mode == C.CONVEX_GAP:
            f2 = np.where(live, -o2 - e2 * cols, inf_min)
            row0[0] = np.maximum(f1, f2)
            row0[2, 0] = -oe2
            row0[4, 1:] = f2[1:]
        row0[0, 0] = 0

    Qp = bucket(qlen + 1, 128)
    qp_pad = np.zeros((abpt.m, Qp + W), dtype=np.int32)
    if qlen:
        qp_pad[:, 1: qlen + 1] = abpt.mat[:, query]

    scalars = np.zeros(16, dtype=np.int32)
    scalars[:15] = [qlen, w, t.remain_end, inf_min, o1, e1, oe1, o2, e2, oe2,
                    t.gn, dp_end0, KERNEL_MODE[abpt.align_mode], int(banded),
                    abpt.zdrop if zdrop_on(abpt) else 0]
    return {"scalars": scalars, "qp_pad": qp_pad,
            "row0": row0.astype(np.int32)}
