"""Kernel S1, the tail of a fusion (span update and edge sort): wrappers and
plain versions.

Counterpart of the XLA steps that end each fusion of
`abpoa_tpu/align/fused_loop.py` (:1446-1452): the whole-graph span update
(`n_span + 1` below node_n) and `_edge_sort` (:145, reference
src/abpoa_graph.c:192-219), abPOA's weight-descending exchange sort of
every node's in and out slots with its unstable tie order (for each slot j,
each later slot k with a strictly larger weight is swapped into j). Only
the first `cnt` slots of a row take part.

`finish_fusion_(...)` does both in place, in one launch of the kernel in
`csrc/topo_sort.cu` for CUDA tensors (or raises), on the rows below node_n
only: rows past it are neither read nor written (the fused loop keeps their
counts at 0), and a row whose weights do not increase is not written (the
sort leaves it as it is). For CPU tensors it runs `finish_fusion_torch_`,
which is also the kernel's yardstick on the card. `edge_sort(...)` is the
out-of-place sort of every row: a copy, then `finish_fusion_` over all N
rows with no span; `edge_sort_torch` is its plain version. The same sort is
pass 2 of kernel K1 (`topo_kernel.topo_sort`), which runs this launch on
copies of its inputs.

Inputs (int32, contiguous, one device): in_ids, in_w, out_ids, out_w (N, E);
in_cnt, out_cnt (N,); node_n one element (None: all N rows); n_span (N,).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_NAMES = ("in_ids", "in_w", "out_ids", "out_w", "in_cnt", "out_cnt")


def check_slots(fn: str, args, names=_NAMES) -> tuple:
    """Checks the four (N, E) slot arrays and two (N,) counts that lead
    `args`: int32, contiguous, on one device. Returns (N, E)."""
    dev = args[0].device
    for name, t in zip(names, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{fn}: {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, "
                             f"{names[0]} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if args[0].dim() != 2:
        raise ValueError(f"{fn}: {names[0]} must have shape (N, E)")
    N, E = args[0].shape
    for name, t in zip(names[1:4], args[1:4]):
        if t.shape != (N, E):
            raise ValueError(f"{fn}: {name} must have shape ({N}, {E})")
    for name, t in zip(names[4:6], args[4:6]):
        if t.shape != (N,):
            raise ValueError(f"{fn}: {name} must have shape ({N},)")
    return N, E


def _check_extra(fn: str, N: int, dev, node_n, n_span) -> None:
    for name, t, shape in (("node_n", node_n, None), ("n_span", n_span, (N,))):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{fn}: {name} must be an int32 tensor")
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, in_ids on {dev}")
        if shape is None and t.numel() != 1:
            raise ValueError(f"{fn}: node_n must hold one element")
        if shape is not None and (t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{fn}: n_span must be contiguous, shape {shape}")


def finish_fusion_(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, node_n,
                   n_span=None) -> None:
    """The span update and edge sort in place; see the module docstring."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt)
    N, E = check_slots("finish_fusion_", args)
    dev = in_ids.device
    _check_extra("finish_fusion_", N, dev, node_n, n_span)
    if dev.type == "cpu":
        finish_fusion_torch_(*args, node_n, n_span)
        return
    if dev.type != "cuda":
        raise ValueError(f"finish_fusion_: unsupported device {dev}")
    lib = build.load()
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_finish_fusion(*(ptr(t) for t in args), ptr(node_n),
                                      ptr(n_span), ptr(None), N, E, 1,
                                      ctypes.c_void_p(stream))
    build.check(err, "finish_fusion_ launch")
    edge_sort.launches += 1


def finish_fusion_lanes_(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt,
                         node_n, n_span=None, lanes=None) -> None:
    """`finish_fusion_` of L lanes in one launch (a block row a lane): the
    slot arrays (L, N, E), the counts and n_span (L, N), node_n (L,). Each
    lane of `lanes` (host ints; None: all) is sorted in place below its
    node_n; the others are not touched. On the CPU the plain version runs
    lane by lane."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt)
    L = in_ids.shape[0]
    for t in (*args, node_n) + ((n_span,) if n_span is not None else ()):
        if not isinstance(t, torch.Tensor) or t.shape[0] != L:
            raise ValueError(f"finish_fusion_lanes_: every input must have "
                             f"{L} lanes")
    N, E = check_slots("finish_fusion_lanes_", tuple(t[0] for t in args))
    for name, t in zip(_NAMES, args):
        if not t.is_contiguous():
            raise ValueError(f"finish_fusion_lanes_: {name} must be contiguous")
    dev = in_ids.device
    _check_extra("finish_fusion_lanes_", N, dev, node_n[:1],
                 None if n_span is None else n_span[0])
    if not node_n.is_contiguous() or (n_span is not None
                                      and not n_span.is_contiguous()):
        raise ValueError("finish_fusion_lanes_: node_n and n_span must be "
                         "contiguous")
    todo = list(range(L)) if lanes is None else [int(x) for x in lanes]
    if dev.type == "cpu":
        for l in todo:
            finish_fusion_torch_(*(t[l] for t in args), node_n[l:l + 1],
                                 None if n_span is None else n_span[l])
        return
    if dev.type != "cuda":
        raise ValueError(f"finish_fusion_lanes_: unsupported device {dev}")
    if not todo:
        return
    lib = build.load()
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        lanes_t = build.lane_list(lanes, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_finish_fusion(*(ptr(t) for t in args), ptr(node_n),
                                      ptr(n_span), ptr(lanes_t), N, E,
                                      len(todo), ctypes.c_void_p(stream))
    build.check(err, "finish_fusion_lanes_ launch")
    finish_fusion_lanes_.launches += 1


finish_fusion_lanes_.launches = 0


def edge_sort(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt):
    """Sorted copies of in_ids, in_w, out_ids, out_w: every row by its
    count (one launch of S1 on the copies)."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt)
    check_slots("edge_sort", args)
    copies = [t.clone() for t in args[:4]]
    finish_fusion_(*copies, in_cnt, out_cnt, None)
    return tuple(copies)


# S1's launches, from `finish_fusion_` and so from `edge_sort` (K1's pass 2
# counts as K1's)
edge_sort.launches = 0


def moving_rows(w: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Which rows of w the exchange sort changes: those where a weight among
    the first cnt is larger than the one before it."""
    k = torch.arange(1, w.shape[1], device=w.device)
    return ((w[:, 1:] > w[:, :-1]) & (k[None, :] < cnt[:, None])).any(1)


def _rows(node_n, N: int) -> int:
    return N if node_n is None else min(max(int(node_n.reshape(-1)[0]), 0), N)


def sort_rows(ids: torch.Tensor, w: torch.Tensor, cnt: torch.Tensor):
    """The exchange sort of every row of (ids, w) over its first cnt slots,
    one column pair at a time across all rows. Returns sorted copies."""
    E = ids.shape[1]
    ids_t = ids.t().contiguous()
    w_t = w.t().contiguous()
    for j in range(E):
        for k in range(j + 1, E):
            swap = (cnt > k) & (w_t[j] < w_t[k])
            wj, wk, ij, ik = w_t[j], w_t[k], ids_t[j], ids_t[k]
            w_t[j], w_t[k] = torch.where(swap, wk, wj), torch.where(swap, wj, wk)
            ids_t[j], ids_t[k] = (torch.where(swap, ik, ij),
                                  torch.where(swap, ij, ik))
    return ids_t.t().contiguous(), w_t.t().contiguous()


def edge_sort_torch(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt):
    """The plain version of `edge_sort`."""
    return (*sort_rows(in_ids, in_w, in_cnt), *sort_rows(out_ids, out_w, out_cnt))


def finish_fusion_torch_(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt,
                         node_n=None, n_span=None) -> None:
    """The plain version of `finish_fusion_`: `sort_rows` written back on
    the rows below node_n that move, and n_span + 1 below node_n."""
    n = _rows(node_n, in_ids.shape[0])
    for ids, w, cnt in ((in_ids, in_w, in_cnt), (out_ids, out_w, out_cnt)):
        rows = torch.nonzero(moving_rows(w[:n], cnt[:n])).flatten()
        if rows.numel():
            ids[rows], w[rows] = sort_rows(ids[rows], w[rows], cnt[rows])
    if n_span is not None:
        n_span[:n] += 1
