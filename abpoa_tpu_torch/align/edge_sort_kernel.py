"""Kernel S1, the per-read edge sort: wrapper and plain version.

Counterpart of the XLA step `abpoa_tpu/align/fused_loop.py` `_edge_sort`
(reference src/abpoa_graph.c:192-219), which follows every fusion: abPOA's
weight-descending exchange sort of every node's in and out slots, with its
unstable tie order (for each slot j, each later slot k with a strictly
larger weight is swapped into j). Only the first `cnt` slots of a row take
part; rows with count 0 (all rows past node_n) are copied unchanged. The
same sort is pass 2 of kernel K1 (`topo_kernel.topo_sort`), which launches
this kernel for it.

`edge_sort(...)` checks its inputs and, for CUDA tensors, launches the kernel
in `csrc/topo_sort.cu` (or raises); for CPU tensors it runs `edge_sort_torch`,
which is also the kernel's yardstick on the card.

Inputs (int32, contiguous, one device): in_ids, in_w, out_ids, out_w (N, E);
in_cnt, out_cnt (N,). Returns sorted copies of in_ids, in_w, out_ids, out_w.
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


def edge_sort(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt):
    """The edge sort; see the module docstring."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt)
    N, E = check_slots("edge_sort", args)
    dev = in_ids.device
    if dev.type == "cpu":
        return edge_sort_torch(*args)
    if dev.type != "cuda":
        raise ValueError(f"edge_sort: unsupported device {dev}")
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty((4, N, E), dtype=torch.int32, device=dev)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_edge_sort(*(ptr(t) for t in args),
                                  *(ptr(t) for t in out.unbind(0)), N, E,
                                  ctypes.c_void_p(stream))
    build.check(err, "edge_sort launch")
    edge_sort.launches += 1
    return tuple(out.unbind(0))


edge_sort.launches = 0


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
