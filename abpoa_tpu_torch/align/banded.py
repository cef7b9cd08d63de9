"""Per-read banded alignment: host tables -> DP kernel -> host backtrack.

Counterpart of `abpoa_tpu/align/pallas_backend.py`
`align_sequence_to_subgraph_pallas` (convex gaps, global mode, adaptive
band). The tables go to the Params' torch device, `banded_dp` runs there
(the CUDA kernel on a card, its plain version on the CPU), the band state is
written back into the graph, and the banded planes come back to the host for
the backtrack.

When the band outgrows the kernel's W lanes (`ok == 0`), the same kernel is
launched again with W doubled (rounded to 128, capped at qlen + 1, where
the band cannot overflow); `retries` counts those relaunches.
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
# over the life of the process: reads aligned, DP rows (R) launched for
# them, seconds in the kernel (CUDA events, cuda only) and in copying its
# planes to the host
stats = {"reads": 0, "rows": 0, "kernel_s": 0.0, "d2h_s": 0.0}


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


def run_banded_dp(abpt: Params, t, query: np.ndarray, W: int):
    """One launch at band width W: the kernel outputs, on the device."""
    q = query_tables(abpt, t, query, W)
    dev = abpt.torch_device
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)  # noqa: E731
    args = [i32(q["scalars"]), i32(t.base), i32(t.pre_idx), i32(t.pre_cnt),
            i32(t.out_idx), i32(t.out_cnt), i32(t.remain), i32(t.mpl0),
            i32(t.mpr0), i32(q["qp_pad"]), i32(q["row0"])]
    if dev.type != "cuda":
        return banded_dp(*args)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = banded_dp(*args)
    ev1.record()
    ev1.synchronize()
    stats["kernel_s"] += ev0.elapsed_time(ev1) / 1e3
    return out


def align_sequence_to_subgraph(g: POAGraph, abpt: Params, beg_node_id: int,
                               end_node_id: int, query: np.ndarray,
                               band_width: Optional[int] = None) -> AlignResult:
    """Align `query` to the subgraph; `band_width` overrides the first
    launch's W (the relaunch path is taken when it is too narrow)."""
    global retries
    if not per_read_covers(abpt):
        raise per_read_refusal("a per-read alignment")
    qlen = len(query)
    inf_min = dp_inf_min(abpt)
    t = build_row_tables(g, beg_node_id, end_node_id)
    gn = t.gn

    W = band_width or initial_band_width(abpt, qlen)
    while True:
        out = run_banded_dp(abpt, t, query, W)
        if int(out[7].item()) == 1:
            break
        if W >= qlen + 1:
            raise RuntimeError(f"banded DP overflowed at full width W={W}")
        W = next_band_width(W, qlen)
        retries += 1

    stats["reads"] += 1
    stats["rows"] += t.R
    t0 = time.perf_counter()
    # the kernel defines plane rows 0..gn-2, all the backtrack reads (the
    # sink's predecessors and back)
    rows = gn - 1
    if out[0].is_cuda:
        host = _staging(5 * rows * W).view(5, rows, W)
        for k in range(5):
            host[k].copy_(out[k][:rows], non_blocking=True)
        torch.cuda.current_stream(out[0].device).synchronize()
        planes = list(host.numpy())
    else:
        planes = [p[:rows].numpy() for p in out[:5]]
    begend = out[5].cpu().numpy()
    mplr = out[6].cpu().numpy()
    stats["d2h_s"] += time.perf_counter() - t0
    R = t.R
    dp_beg = begend[:gn].tolist()
    dp_end = begend[R: R + gn].tolist()
    g.node_id_to_max_pos_left[t.nids] = mplr[:gn]
    g.node_id_to_max_pos_right[t.nids] = mplr[R: R + gn]

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
