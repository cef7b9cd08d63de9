"""Host backtrack over banded DP planes.

What the per-read route needs from the JAX package's numpy oracle
(abpoa_tpu/align/oracle.py): the -inf clamp, the reachable-subgraph mask, the
DP state and the scalar backtrack, which replicates abPOA's op priority and
tie-breaks (src/abpoa_align_simd.c:116-458): M -> E(1,2) -> F(1,2) -> M, with
the put_gap_on_right / put_gap_at_end switches.

The backtrack reads the kernel's banded planes through `BandedPlane`, which
maps H[i, j] to Hb[i, j - dp_beg[i]] inside [dp_beg[i], dp_end[i]] and to
-inf outside, so no full-width (rows, qlen + 1) plane is ever built.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .. import constants as C
from ..cigar import push_cigar
from ..graph import POAGraph
from ..params import Params
from .result import AlignResult

INT16_MIN = -32768
INT16_MAX = 32767
INT32_MIN = -2147483648


def dp_inf_min(abpt: Params, dtype_min: int = INT32_MIN) -> int:
    """-inf clamp for DP cells: far enough below any reachable score that
    subtraction chains cannot wrap (the 512-step margin mirrors abPOA's
    underflow headroom, src/abpoa_align_simd.c:1293-1302)."""
    return (max(dtype_min + abpt.min_mis, dtype_min + abpt.gap_oe1,
                dtype_min + abpt.gap_oe2)
            + 512 * max(abpt.gap_ext1, abpt.gap_ext2))


def int16_score_limit(abpt: Params) -> int:
    """Largest worst-case score that still fits 16-bit planes
    (abpoa_align_simd.c:1284-1302)."""
    return INT16_MAX - abpt.min_mis - abpt.gap_oe1 - abpt.gap_oe2


def max_score_bound(abpt: Params, qlen: int, gn: int) -> int:
    """Worst-case alignment score of a qlen read against a gn-node graph,
    which selects the plane width (abpoa_align_simd.c:1293-1302). The fused
    loop checks it before every read and promotes int16 planes to int32
    once it passes `int16_score_limit`."""
    ln = max(qlen, gn)
    return max(qlen * abpt.max_mat, ln * abpt.gap_ext1 + abpt.gap_open1)


def _build_index_map(g: POAGraph, beg_index: int, end_index: int) -> np.ndarray:
    """BFS-reachable subgraph mask (src/abpoa_align_simd.c:1259-1269)."""
    index_map = np.zeros(g.node_n, dtype=np.uint8)
    index_map[beg_index] = index_map[end_index] = 1
    for i in range(beg_index, end_index - 1):
        if not index_map[i]:
            continue
        node = g.nodes[int(g.index_to_node_id[i])]
        for out_id in node.out_ids:
            index_map[int(g.node_id_to_index[out_id])] = 1
    return index_map


class BandedPlane:
    """Read-only full-width view of one banded (rows, W) plane."""
    __slots__ = ("band", "beg", "end", "inf")

    def __init__(self, band: np.ndarray, dp_beg: Sequence[int],
                 dp_end: Sequence[int], inf_min: int):
        self.band = band
        self.beg = dp_beg
        self.end = dp_end
        self.inf = inf_min

    def __getitem__(self, ij) -> int:
        i, j = ij
        b = self.beg[i]
        if b <= j <= self.end[i]:
            return int(self.band[i, j - b])
        return self.inf


class _DPState:
    """Per-call DP planes (banded views) + band bookkeeping."""

    def __init__(self, planes, dp_beg: List[int], dp_end: List[int],
                 inf_min: int):
        Hb, E1b, E2b, F1b, F2b = planes
        view = lambda p: BandedPlane(p, dp_beg, dp_end, inf_min)  # noqa: E731
        self.H, self.E1, self.E2 = view(Hb), view(E1b), view(E2b)
        self.F1, self.F2 = view(F1b), view(F2b)
        self.dp_beg, self.dp_end = dp_beg, dp_end


def _backtrack(g: POAGraph, abpt: Params, st: _DPState, pre_index,
               beg_index: int, best_i: int, best_j: int, qlen: int,
               query: np.ndarray, res: AlignResult, gap_mode: int) -> None:
    """Scalar backtrack, replicating abPOA's op priority + tie-breaks
    (src/abpoa_align_simd.c:116-458)."""
    H, E1, E2, F1, F2 = st.H, st.E1, st.E2, st.F1, st.F2
    dp_beg, dp_end = st.dp_beg, st.dp_end
    mat = abpt.mat
    e1, oe1 = abpt.gap_ext1, abpt.gap_oe1
    e2, oe2 = abpt.gap_ext2, abpt.gap_oe2

    cigar: List[int] = []
    dp_i, dp_j = best_i, best_j
    start_i, start_j = best_i, best_j
    node_id = int(g.index_to_node_id[dp_i + beg_index])
    if best_j < qlen:
        push_cigar(cigar, C.CINS, qlen - best_j, -1, qlen - 1)
    look_gap_at_end = 1 if abpt.put_gap_at_end else 0
    gap_on_right = 1 if abpt.put_gap_on_right else 0
    cur_op = C.ALL_OP
    linear = gap_mode == C.LINEAR_GAP
    convex = gap_mode == C.CONVEX_GAP

    while dp_i > 0 and dp_j > 0:
        start_i, start_j = dp_i, dp_j
        preds = pre_index[dp_i]
        s = int(mat[g.nodes[node_id].base, query[dp_j - 1]])
        is_match = g.nodes[node_id].base == int(query[dp_j - 1])
        hit = False

        def try_match() -> bool:
            nonlocal dp_i, dp_j, node_id, cur_op, look_gap_at_end
            for pre_i in preds:
                if dp_j - 1 < dp_beg[pre_i] or dp_j - 1 > dp_end[pre_i]:
                    continue
                if H[pre_i, dp_j - 1] + s == H[dp_i, dp_j]:
                    push_cigar(cigar, C.CMATCH, 1, node_id, dp_j - 1)
                    dp_i = pre_i
                    dp_j -= 1
                    node_id = int(g.index_to_node_id[dp_i + beg_index])
                    cur_op = C.ALL_OP
                    res.n_aln_bases += 1
                    res.n_matched_bases += 1 if is_match else 0
                    return True
            return False

        if gap_on_right == 0 and look_gap_at_end == 0 and (linear or cur_op & C.M_OP):
            hit = try_match()
            if hit and linear:
                continue

        if not hit:  # deletion
            if linear:
                for pre_i in preds:
                    if dp_j < dp_beg[pre_i] or dp_j > dp_end[pre_i]:
                        continue
                    if H[pre_i, dp_j] - e1 == H[dp_i, dp_j]:
                        push_cigar(cigar, C.CDEL, 1, node_id, dp_j - 1)
                        dp_i = pre_i
                        node_id = int(g.index_to_node_id[dp_i + beg_index])
                        hit = True
                        look_gap_at_end = 0
                        break
            elif cur_op & C.E_OP:
                for pre_i in preds:
                    if dp_j < dp_beg[pre_i] or dp_j > dp_end[pre_i]:
                        continue
                    done = False
                    if cur_op & C.E1_OP:
                        if cur_op & C.M_OP:
                            cond = H[dp_i, dp_j] == E1[pre_i, dp_j]
                        else:
                            cond = E1[dp_i, dp_j] == E1[pre_i, dp_j] - e1
                        if cond:
                            if H[pre_i, dp_j] - oe1 == E1[pre_i, dp_j]:
                                cur_op = C.M_OP | C.F_OP
                            else:
                                cur_op = C.E1_OP
                            push_cigar(cigar, C.CDEL, 1, node_id, dp_j - 1)
                            dp_i = pre_i
                            node_id = int(g.index_to_node_id[dp_i + beg_index])
                            hit = done = True
                            look_gap_at_end = 0
                    if not done and convex and cur_op & C.E2_OP:
                        if cur_op & C.M_OP:
                            cond = H[dp_i, dp_j] == E2[pre_i, dp_j]
                        else:
                            cond = E2[dp_i, dp_j] == E2[pre_i, dp_j] - e2
                        if cond:
                            if H[pre_i, dp_j] - oe2 == E2[pre_i, dp_j]:
                                cur_op = C.M_OP | C.F_OP
                            else:
                                cur_op = C.E2_OP
                            push_cigar(cigar, C.CDEL, 1, node_id, dp_j - 1)
                            dp_i = pre_i
                            node_id = int(g.index_to_node_id[dp_i + beg_index])
                            hit = done = True
                            look_gap_at_end = 0
                    if done:
                        break

        if not hit:  # insertion
            if linear:
                if H[dp_i, dp_j - 1] - e1 == H[dp_i, dp_j]:
                    push_cigar(cigar, C.CINS, 1, node_id, dp_j - 1)
                    dp_j -= 1
                    look_gap_at_end = 0
                    hit = True
                    res.n_aln_bases += 1
            elif cur_op & C.F_OP:
                got = False
                if cur_op & C.F1_OP:
                    if cur_op & C.M_OP:
                        if H[dp_i, dp_j] == F1[dp_i, dp_j]:
                            if H[dp_i, dp_j - 1] - oe1 == F1[dp_i, dp_j]:
                                cur_op = C.M_OP | C.E_OP
                                got = True
                            elif F1[dp_i, dp_j - 1] - e1 == F1[dp_i, dp_j]:
                                cur_op = C.F1_OP
                                got = True
                    else:
                        if H[dp_i, dp_j - 1] - oe1 == F1[dp_i, dp_j]:
                            cur_op = C.M_OP | C.E_OP
                            got = True
                        elif F1[dp_i, dp_j - 1] - e1 == F1[dp_i, dp_j]:
                            cur_op = C.F1_OP
                            got = True
                if not got and convex and cur_op & C.F2_OP:
                    if cur_op & C.M_OP:
                        if H[dp_i, dp_j] == F2[dp_i, dp_j]:
                            if H[dp_i, dp_j - 1] - oe2 == F2[dp_i, dp_j]:
                                cur_op = C.M_OP | C.E_OP
                                got = True
                            elif F2[dp_i, dp_j - 1] - e2 == F2[dp_i, dp_j]:
                                cur_op = C.F2_OP
                                got = True
                    else:
                        if H[dp_i, dp_j - 1] - oe2 == F2[dp_i, dp_j]:
                            cur_op = C.M_OP | C.E_OP
                            got = True
                        elif F2[dp_i, dp_j - 1] - e2 == F2[dp_i, dp_j]:
                            cur_op = C.F2_OP
                            got = True
                if got:
                    push_cigar(cigar, C.CINS, 1, node_id, dp_j - 1)
                    dp_j -= 1
                    look_gap_at_end = 0
                    hit = True
                    res.n_aln_bases += 1

        if not hit and (linear or cur_op & C.M_OP):
            hit = try_match()
            if hit:
                look_gap_at_end = 0

        if not hit:
            raise RuntimeError(
                f"Error in backtrack at dp_i={dp_i}, dp_j={dp_j} (gap_mode={gap_mode})")

    if dp_j > 0:
        push_cigar(cigar, C.CINS, dp_j, -1, dp_j - 1)
    cigar.reverse()
    res.cigar = cigar
    res.node_e = int(g.index_to_node_id[best_i + beg_index])
    res.query_e = best_j - 1
    res.node_s = int(g.index_to_node_id[start_i + beg_index])
    res.query_s = start_j - 1
