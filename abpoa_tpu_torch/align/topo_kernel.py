"""Kernel K1, the Kahn repair of the topological order: wrapper and plain
version.

Counterpart of the XLA function `abpoa_tpu/align/device_graph.py`
`topo_sort` (reference src/abpoa_graph.c:192-357), which the fused loop runs
when the spliced order is not a valid topological order:
  1. a Kahn BFS from the source over the edges in their current slot order,
     where a node is queued only when its whole aligned group has in-degree
     0, and then its group follows it (aligned-group atomicity);
  2. abPOA's weight-descending exchange sort of every node's edge slots, with
     its (unstable) tie order;
  3. a reverse BFS from the sink for max_remain: remain[v] is remain of v's
     heaviest out-edge target (slot 0 after the sort) plus one.
The BFS passes are sequential, so on the card they run on one thread of
`csrc/topo_sort.cu`; the sort runs a thread per node.

`topo_sort(...)` checks its inputs and, for CUDA tensors, launches the kernel
(or raises); for CPU tensors it runs `topo_sort_torch`, the same passes over
host lists, which is also the kernel's yardstick on the card.

Inputs (int32, one device): in_ids, in_w, out_ids, out_w (N, E); in_cnt,
out_cnt (N,); aligned (N, A), aligned_cnt (N,); node_n (1,).
Outputs: the sorted in_ids, in_w, out_ids, out_w (N, E); i2n, n2i, remain
(N,); ok (1,) = 1 when the BFS ordered all node_n nodes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..kernels import build

_NAMES = ("in_ids", "in_w", "out_ids", "out_w", "in_cnt", "out_cnt",
          "aligned", "aligned_cnt", "node_n")


def _check_inputs(args) -> tuple:
    dev = args[0].device
    for name, t in zip(_NAMES, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"topo_sort: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"topo_sort: {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"topo_sort: {name} is on {t.device}, "
                             f"in_ids on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"topo_sort: {name} must be contiguous")
    N, E = args[0].shape
    for name, t in zip(_NAMES[1:4], args[1:4]):
        if t.shape != (N, E):
            raise ValueError(f"topo_sort: {name} must have shape ({N}, {E})")
    for name, t in (("in_cnt", args[4]), ("out_cnt", args[5]),
                    ("aligned_cnt", args[7])):
        if t.shape != (N,):
            raise ValueError(f"topo_sort: {name} must have shape ({N},)")
    if args[6].dim() != 2 or args[6].shape[0] != N:
        raise ValueError("topo_sort: aligned must have shape (N, A)")
    if args[8].shape != (1,):
        raise ValueError("topo_sort: node_n must have shape (1,)")
    return N, E, args[6].shape[1]


def topo_sort(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
              aligned_cnt, node_n):
    """Kahn repair; see the module docstring. Returns (in_ids, in_w,
    out_ids, out_w, i2n, n2i, remain, ok)."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
            aligned_cnt, node_n)
    N, E, A = _check_inputs(args)
    dev = in_ids.device
    if dev.type == "cpu":
        return topo_sort_torch(*args)
    if dev.type != "cuda":
        raise ValueError(f"topo_sort: unsupported device {dev}")
    lib = build.load()
    with torch.cuda.device(dev):
        sorted_ = torch.empty((4, N, E), dtype=torch.int32, device=dev)
        vecs = torch.empty((3, N), dtype=torch.int32, device=dev)
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        scratch = torch.empty((2, N), dtype=torch.int32, device=dev)
        outs = (*sorted_.unbind(0), *vecs.unbind(0), ok, scratch)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_topo_sort(
            *(ptr(t) for t in args), *(ptr(t) for t in outs), N, E, A,
            ctypes.c_void_p(stream))
    build.check(err, "topo_sort launch")
    topo_sort.launches += 1
    return (*sorted_.unbind(0), *vecs.unbind(0), ok)


topo_sort.launches = 0


def _exchange_sort(ids: list, w: list, cnt: int) -> None:
    for j in range(cnt):
        for k in range(j + 1, cnt):
            if w[j] < w[k]:
                w[j], w[k] = w[k], w[j]
                ids[j], ids[k] = ids[k], ids[j]


def topo_sort_torch(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
                    aligned_cnt, node_n):
    """The plain version of `topo_sort`: device_graph.py:210-347 step by
    step over host lists; returns tensors on the inputs' device."""
    dev = in_ids.device
    N = in_ids.shape[0]
    n = int(node_n[0])
    iid, iw = in_ids.tolist(), in_w.tolist()
    oid, ow = out_ids.tolist(), out_w.tolist()
    icnt, ocnt = in_cnt.tolist(), out_cnt.tolist()
    aln, acnt = aligned.tolist(), aligned_cnt.tolist()

    # 1. Kahn BFS on the slot order as given, aligned groups atomic
    in_deg = list(icnt)
    queue = [C.SRC_NODE_ID]
    i2n, n2i = [0] * N, [0] * N
    head = 0
    while head < len(queue) and head < n:
        cur = queue[head]
        i2n[head], n2i[cur] = cur, head
        head += 1
        if cur == C.SINK_NODE_ID:
            continue
        for out_id in oid[cur][:ocnt[cur]]:
            in_deg[out_id] -= 1
            group = aln[out_id][:acnt[out_id]]
            if in_deg[out_id] == 0 and all(in_deg[a] == 0 for a in group):
                queue.append(out_id)
                queue.extend(group)
    ok = int(head == n)

    # 2. weight-descending exchange sort of every node's slots
    for r in range(N):
        _exchange_sort(iid[r], iw[r], icnt[r])
        _exchange_sort(oid[r], ow[r], ocnt[r])

    # 3. reverse BFS from the sink: remain of the heaviest out-edge + 1
    remain = [0] * N
    remain[C.SINK_NODE_ID] = -1
    out_deg = list(ocnt)
    rqueue = [C.SINK_NODE_ID]
    head = 0
    while head < len(rqueue):
        cur = rqueue[head]
        head += 1
        if cur != C.SINK_NODE_ID:
            remain[cur] = remain[oid[cur][0]] + 1
        if cur == C.SRC_NODE_ID:
            continue
        for in_id in iid[cur][:icnt[cur]]:
            out_deg[in_id] -= 1
            if out_deg[in_id] == 0:
                rqueue.append(in_id)

    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.tensor(iid, **i32), torch.tensor(iw, **i32),
            torch.tensor(oid, **i32), torch.tensor(ow, **i32),
            torch.tensor(i2n, **i32), torch.tensor(n2i, **i32),
            torch.tensor(remain, **i32), torch.tensor([ok], **i32))
