"""What the DP needs from the JAX package's numpy oracle
(abpoa_tpu/align/oracle.py): the -inf clamp, the score-width bounds and the
reachable-subgraph mask of a window (src/abpoa_align_simd.c:1259-1302). The
backtrack itself runs in the kernels X1 and X1w (align/backtrack_kernel.py).
"""
from __future__ import annotations

import numpy as np

from ..graph import POAGraph
from ..params import Params

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
