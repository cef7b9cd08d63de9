"""Kernel K1, the Kahn repair of the topological order: wrapper and plain
version.

Counterpart of the XLA function `abpoa_tpu/align/device_graph.py`
`topo_sort` (reference src/abpoa_graph.c:192-357), which the fused loop runs
when the spliced order is not a valid topological order:
  1. a Kahn BFS from the source over the edges in their current slot order,
     where a node is queued only when its whole aligned group has in-degree
     0, and then its group follows it (aligned-group atomicity);
  2. abPOA's weight-descending exchange sort of every node's edge slots, with
     its (unstable) tie order: kernel S1 (`edge_sort_kernel`), on copies;
  3. a reverse BFS from the sink for max_remain: remain[v] is remain of v's
     heaviest out-edge target (slot 0 after the sort) plus one.
On the card (`csrc/topo_sort.cu`) pass 2 copies the four slot arrays into
the sorted outputs on the stream and runs S1's in-place launch on the copies
over all N rows (`edge_sort_kernel.finish_fusion_`'s kernel, no span update),
a second launch writes each node's records (pass 1's: its out slots and
their targets' groups; pass 3's: its sorted in slots and out slot 0), and
the two BFS passes run in one block: one warp visits a node at a time with
the degrees in shared memory, and at the start of each visit copies its
neighbours' records into a shared cache, so they land while it works
(`launch_shape` picks the degrees' type and place and the cache's size).

`topo_sort(...)` checks its inputs and, for CUDA tensors, launches the kernel
(or raises); for CPU tensors it runs `topo_sort_torch`, the same passes over
host lists with `edge_sort_torch` as pass 2, which is also the kernel's
yardstick on the card.

Inputs (int32, one device): in_ids, in_w, out_ids, out_w (N, E); in_cnt,
out_cnt (N,); aligned (N, A), aligned_cnt (N,); node_n (1,).
Outputs: the sorted in_ids, in_w, out_ids, out_w (N, E); i2n, n2i, remain
(N,); ok (1,) = 1 when the BFS ordered all node_n nodes. When ok = 0 the
outputs are still defined: i2n and n2i hold the nodes the walk reached, and
remain is what the reverse BFS reached (0 elsewhere).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import constants as C
from ..kernels import build
from .edge_sort_kernel import check_slots, edge_sort_torch

_NAMES = ("in_ids", "in_w", "out_ids", "out_w", "in_cnt", "out_cnt",
          "aligned", "aligned_cnt", "node_n")

# csrc/topo_sort.cu's BFS block: its shared memory holds a cache of C node
# records (and a tag each) and, in the shared variant, the degrees
SMEM_MAX = 232448 - 16     # 227 KB a block, less the kernel's static ints
_CACHES = (64, 32, 16, 8, 4, 2)
# degree variants: bytes a node in shared memory (0: int32 in device memory)
VARIANTS = {"s8": 1, "g32": 0}


def record_ints(E: int, A: int) -> tuple:
    """The most ints of a node's two records, rounded up to 16 bytes: pass
    1's (a header, two words an out slot, the targets' group members) and
    pass 3's (a header, the sorted out slot 0, two words an in slot)."""
    return (1 + 2 * E + E * A + 3) // 4 * 4, (2 + 2 * E + 3) // 4 * 4


def bfs_smem(N: int, E: int, A: int, C: int, variant: str) -> int:
    ints = C * (record_ints(E, A)[0] + 1)
    return (ints * 4 + 15) // 16 * 16 + (N * VARIANTS[variant] + 15) // 16 * 16


def launch_shape(N: int, E: int, A: int,
                 variant: Optional[str] = None) -> dict:
    """The BFS block's degree variant and record cache: int8 degrees in
    shared memory while E <= 127 (a count never passes E, a decrement
    saturates) and they fit, else int32 in device memory; the largest cache
    of 64, 32, ... 2 records that fits. `variant` forces one (the tests run
    both); raises ValueError when it cannot hold these shapes."""
    if N > 1 << 25 or A > 127 or E * A > 8191:
        # the records pack a node id in 25 bits, a group size in 7 and a
        # member offset in 13
        raise ValueError(f"topo_sort: N={N}, E={E}, A={A} past the records' "
                         "fields (N <= 2**25, A <= 127, E * A <= 8191)")
    if variant is None:
        names = ("s8", "g32") if E <= 127 else ("g32",)
    elif variant not in VARIANTS:
        raise ValueError(f"topo_sort: unknown variant {variant!r}")
    elif variant == "s8" and E > 127:
        raise ValueError(f"topo_sort: variant s8 cannot count to E = {E}")
    else:
        names = (variant,)
    for v in names:
        for C in _CACHES:
            smem = bfs_smem(N, E, A, C, v)
            if smem <= SMEM_MAX:
                return dict(variant=v, cache=C, smem=smem)
    raise ValueError(f"topo_sort: no variant of {names} fits N={N}, E={E}, "
                     f"A={A} in {SMEM_MAX} bytes of shared memory")


def _check_inputs(args) -> tuple:
    N, E = check_slots("topo_sort", args, _NAMES)
    if args[7].shape != (N,):
        raise ValueError(f"topo_sort: aligned_cnt must have shape ({N},)")
    if args[6].dim() != 2 or args[6].shape[0] != N:
        raise ValueError("topo_sort: aligned must have shape (N, A)")
    if args[8].shape != (1,):
        raise ValueError("topo_sort: node_n must have shape (1,)")
    return N, E, args[6].shape[1]


def topo_sort(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
              aligned_cnt, node_n, walks: int = 3,
              variant: Optional[str] = None):
    """Kahn repair; see the module docstring. Returns (in_ids, in_w,
    out_ids, out_w, i2n, n2i, remain, ok). On the card, `variant` forces
    the degrees' variant (`launch_shape`), and `walks`, a mask of the BFS
    passes to run (1 = pass 1, 2 = pass 3), exists only to time one walk
    alone: any value but 3 leaves i2n, n2i, remain and ok incomplete."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
            aligned_cnt, node_n)
    N, E, A = _check_inputs(args)
    dev = in_ids.device
    if dev.type == "cpu":
        return topo_sort_torch(*args)
    if dev.type != "cuda":
        raise ValueError(f"topo_sort: unsupported device {dev}")
    out = _launch(tuple(t[None] for t in args[:8]) + (node_n,), 1, N, E, A,
                  None, walks, variant)
    topo_sort.launches += 1
    return (*(t[0] for t in out[:7]), out[7])


def _launch(args, L: int, N: int, E: int, A: int, lanes, walks: int,
            variant: Optional[str]):
    """One launch of K1 over the lanes of `lanes` (host ints; None: all L),
    the inputs stacked over L lanes of N rows. Returns the sorted slots
    (L, N, E) each, i2n, n2i, remain (L, N) and ok (L,)."""
    dev = args[0].device
    shape = launch_shape(N, E, A, variant)
    lib = build.load()
    nl = L if lanes is None else len(lanes)
    with torch.cuda.device(dev):
        sorted_ = torch.empty((4, L, N, E), dtype=torch.int32, device=dev)
        vecs = torch.empty((3, L, N), dtype=torch.int32, device=dev)
        ok = torch.empty(L, dtype=torch.int32, device=dev)
        scratch = torch.empty((nl, 2 * N + 1), dtype=torch.int32, device=dev)
        rec = torch.empty((nl, N * sum(record_ints(E, A))), dtype=torch.int32,
                          device=dev)
        lanes_t = build.lane_list(lanes, dev)
        outs = (*sorted_.unbind(0), *vecs.unbind(0), ok, scratch, rec)
        ptr = lambda t: ctypes.c_void_p(  # noqa: E731
            None if t is None else t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_topo_sort(
            *(ptr(t) for t in args), *(ptr(t) for t in outs), ptr(lanes_t),
            N, E, A, tuple(VARIANTS).index(shape["variant"]), shape["cache"],
            walks, L, nl, ctypes.c_void_p(stream))
    build.check(err, "topo_sort launch")
    return (*sorted_.unbind(0), *vecs.unbind(0), ok)


def topo_sort_lanes(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
                    aligned_cnt, node_n, lanes=None,
                    variant: Optional[str] = None):
    """The Kahn repair of L lanes in one launch of K1 (one BFS block a lane,
    each with its own shared memory): each input of `topo_sort` with a
    leading lane axis (slots (L, N, E), counts (L, N), aligned (L, N, A),
    node_n (L,)). `lanes` (host ints) lists the lanes to repair (None:
    all); the others' outputs are undefined on the card (zero in the plain
    version). Returns (in_ids, in_w, out_ids, out_w, i2n, n2i, remain, ok)
    with the lane axis. On the CPU the plain version runs lane by lane."""
    args = (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
            aligned_cnt, node_n)
    L = in_ids.shape[0]
    for name, t in zip(_NAMES, args):
        if not isinstance(t, torch.Tensor) or t.shape[0] != L:
            raise ValueError(f"topo_sort_lanes: {name} must have {L} lanes")
        if not t.is_contiguous():
            raise ValueError(f"topo_sort_lanes: {name} must be contiguous")
    N, E, A = _check_inputs(tuple(t[0] for t in args[:8])
                            + (node_n[:1],))
    todo = list(range(L)) if lanes is None else [int(x) for x in lanes]
    dev = in_ids.device
    if dev.type == "cpu":
        outs = [torch.zeros((L, N, E), dtype=torch.int32) for _ in range(4)]
        outs += [torch.zeros((L, N), dtype=torch.int32) for _ in range(3)]
        outs.append(torch.zeros(L, dtype=torch.int32))
        for l in todo:
            got = topo_sort_torch(*(t[l] for t in args[:8]),
                                  node_n[l:l + 1])
            for o, g in zip(outs[:7], got[:7]):
                o[l] = g
            outs[7][l] = got[7][0]
        return tuple(outs)
    if dev.type != "cuda":
        raise ValueError(f"topo_sort_lanes: unsupported device {dev}")
    if not todo:
        raise ValueError("topo_sort_lanes: no lane to launch")
    out = _launch(args, L, N, E, A, lanes, 3, variant)
    topo_sort_lanes.launches += 1
    return out


topo_sort_lanes.launches = 0


topo_sort.launches = 0


def kahn_walk(oid: list, ocnt: list, icnt: list, aln: list, acnt: list,
              n: int):
    """Pass 1 over host lists, the slots in the order given. Returns the
    queue (it may pass N) and the number of nodes visited."""
    in_deg = list(icnt)
    queue = [C.SRC_NODE_ID]
    head = 0
    while head < len(queue) and head < n:
        cur = queue[head]
        head += 1
        if cur == C.SINK_NODE_ID:
            continue
        for out_id in oid[cur][:max(ocnt[cur], 0)]:
            in_deg[out_id] -= 1
            group = aln[out_id][:max(acnt[out_id], 0)]
            if in_deg[out_id] == 0 and all(in_deg[a] == 0 for a in group):
                queue += [out_id, *group]
    return queue, head


def reverse_walk(iid: list, icnt: list, ocnt: list, soid: list, N: int):
    """Pass 3 over host lists with the sorted slots: remain and the reverse
    queue."""
    remain = [0] * N
    remain[C.SINK_NODE_ID] = -1
    out_deg = list(ocnt)
    rqueue = [C.SINK_NODE_ID]
    head = 0
    while head < len(rqueue):
        cur = rqueue[head]
        head += 1
        if cur != C.SINK_NODE_ID:
            remain[cur] = remain[soid[cur][0]] + 1
        if cur == C.SRC_NODE_ID:
            continue
        for in_id in iid[cur][:max(icnt[cur], 0)]:
            out_deg[in_id] -= 1
            if out_deg[in_id] == 0:
                rqueue.append(in_id)
    return remain, rqueue


def topo_sort_torch(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, aligned,
                    aligned_cnt, node_n):
    """The plain version of `topo_sort`: device_graph.py:210-347 step by
    step over host lists; returns tensors on the inputs' device."""
    dev = in_ids.device
    N = in_ids.shape[0]
    n = int(node_n[0])
    icnt, ocnt = in_cnt.tolist(), out_cnt.tolist()

    # 1. Kahn BFS on the slot order as given, aligned groups atomic
    queue, head = kahn_walk(out_ids.tolist(), ocnt, icnt, aligned.tolist(),
                               aligned_cnt.tolist(), n)
    i2n, n2i = [0] * N, [0] * N
    for idx, cur in enumerate(queue[:head]):
        i2n[idx], n2i[cur] = cur, idx
    ok = int(head == n)

    # 2. weight-descending exchange sort of every node's slots (kernel S1)
    sorted_ = edge_sort_torch(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt)

    # 3. reverse BFS from the sink: remain of the heaviest out-edge + 1
    remain, _ = reverse_walk(sorted_[0].tolist(), icnt, ocnt,
                                sorted_[2].tolist(), N)

    i32 = dict(dtype=torch.int32, device=dev)
    return (*sorted_, torch.tensor(i2n, **i32), torch.tensor(n2i, **i32),
            torch.tensor(remain, **i32), torch.tensor([ok], **i32))
