"""`--device native`: the C++ banded DP and backtrack of the native host core.

Counterpart of `abpoa_tpu/align/native_backend.py`: graph, fusion, sort and
the adaptive-banded DP with its backtrack all run in C++ (`apg_align`,
`native/host_core.cpp`), Python only orchestrates, `-G` path scores
included (abPOA src/abpoa_graph.c:429-437). It is the host rung the
circuit breaker demotes `--device cpu` to (`resilience/breaker.py`); a
card run never falls to it. A graph that is not native (the Python graph
of `-G` or Z-drop) goes to the plain rung instead: B2's and X1w's plain
versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..params import Params
from .result import AlignResult

_U8, _I32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
_U64, _I64 = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)


def native_params(abpt: Params) -> np.ndarray:
    """apg_align's int32 parameter block (host_core.cpp's `params layout`):
    the last two entries select the plane width, int16 where the score
    bound fits (abPOA abpoa_align_simd.c:1284-1302) unless
    ABPOA_TPU_NATIVE_I32 forces int32."""
    return np.array([
        abpt.align_mode, abpt.gap_mode, abpt.wb, int(abpt.wf * 1e6),
        abpt.zdrop, abpt.m, abpt.gap_open1, abpt.gap_ext1, abpt.gap_open2,
        abpt.gap_ext2, abpt.min_mis, 1 if abpt.put_gap_on_right else 0,
        1 if abpt.put_gap_at_end else 0, 1,  # the cigar is always returned
        1 if abpt.inc_path_score else 0, int(abpt.max_mat),
        1 if os.environ.get("ABPOA_TPU_NATIVE_I32") else 0,
    ], dtype=np.int32)


def align_native(g, abpt: Params, beg_node_id: int, end_node_id: int,
                 query: np.ndarray) -> AlignResult:
    """Align `query` to the subgraph [beg_node_id, end_node_id] of the
    sorted native graph `g` in C++; raises RuntimeError("native DP kernel
    failed ...") on a non-zero return (`resilience.classify`'s
    `native_crash`)."""
    qlen = len(query)
    q = np.ascontiguousarray(query, dtype=np.uint8)
    mat = np.ascontiguousarray(abpt.mat, dtype=np.int32)
    params = native_params(abpt)
    cap = 2 * qlen + g.node_n + 16
    cig = np.zeros(cap, dtype=np.uint64)
    meta = np.zeros(8, dtype=np.int64)
    rc = g._lib.apg_align(g._h, beg_node_id, end_node_id,
                          q.ctypes.data_as(_U8), qlen,
                          mat.ctypes.data_as(_I32),
                          params.ctypes.data_as(_I32),
                          cig.ctypes.data_as(_U64), cap,
                          meta.ctypes.data_as(_I64))
    if rc != 0:
        raise RuntimeError(f"native DP kernel failed (rc={rc})")
    res = AlignResult()
    res.best_score = int(meta[0])
    n_c = int(meta[7])
    res.cigar = [int(x) for x in cig[:n_c]]
    res.cigar_arr = cig[:n_c]  # the guards read the array
    res.node_s, res.node_e = int(meta[1]), int(meta[2])
    res.query_s, res.query_e = int(meta[3]), int(meta[4])
    res.n_aln_bases, res.n_matched_bases = int(meta[5]), int(meta[6])
    return res
