"""Kernel F1, the sequential fusion of a read that collides: wrapper and
plain version.

Counterpart of the XLA function `abpoa_tpu/align/device_graph.py`
`fuse_alignment` (reference src/abpoa_graph.c:689-774), which the fused loop
takes when two mismatch columns of a read touch one aligned-node group (a
"collision", `fused_loop._fuse_vectorized`'s flag): the read's forward op
stream is fused one op at a time. On the card one thread of one block a
lane walks the stream (`csrc/fuse_alignment.cu`), in place on a fresh copy
of the lane's graph, so the graph stays on the card and no value of the
read comes to the host.

`fuse_alignment_lanes(...)` takes the graph stacked over L lanes (a
`DeviceGraph` whose arrays have a leading lane axis: node_n and ok (L,)),
copies it (a read that reports an error runs again from the state's graph,
so the state's storage is never written) and fuses lane l's op stream into
the copy's lane l, for every lane or for the lanes of `lanes`; the other
lanes of the copy stay as they were. For CUDA tensors it launches the
kernel (or raises); for CPU tensors it runs `fuse_alignment_torch`, the
walk of `device_graph.fuse_alignment` lane by lane, which is also the
kernel's yardstick on the card. The single-set loop calls it with L = 1.

Inputs (int32, contiguous, one device): fwd_op, fwd_arg (L, T) the forward
op streams (0 match, 1 deletion, 2 insertion; the argument a node id);
n_fwd (L,) their lengths (capped at T); query, weight (L, Q) the reads as
fused (the reverse complement where `-s` chose it); qlen (L,).
Outputs: the fused copy, path (L, Pcap) the node each consumed op ended on
(zero past its length; the read's edges are SRC -> path[0] -> ... ->
SINK) and path_len (L,).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels import build
from .device_graph import DeviceGraph, fuse_alignment

_GRAPH = ("base", "in_ids", "in_w", "in_cnt", "out_ids", "out_w", "out_cnt",
          "aligned", "aligned_cnt", "n_read", "n_span", "node_n", "ok")


def lane_graph(g: DeviceGraph, l: int) -> DeviceGraph:
    """Lane l of a stacked graph, as views."""
    return DeviceGraph(**{k: v[l] for k, v in g.tensors().items()})


def _check(g: DeviceGraph, args) -> tuple:
    """(L, N, E, A, T, Q) after checking types, shapes and devices."""
    t = g.tensors()
    L, N, E = g.in_ids.shape
    A = g.aligned.shape[2]
    dev = g.base.device
    for k, v in list(t.items()) + list(zip(
            ("fwd_op", "fwd_arg", "n_fwd", "query", "weight", "qlen"), args)):
        want = torch.bool if k == "ok" else torch.int32
        if not isinstance(v, torch.Tensor) or v.dtype != want:
            raise TypeError(f"fuse_alignment_lanes: {k} must be a {want} tensor")
        if v.device != dev:
            raise ValueError(f"fuse_alignment_lanes: {k} is on {v.device}, "
                             f"base on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"fuse_alignment_lanes: {k} must be contiguous")
    shapes = {"base": (L, N), "in_cnt": (L, N), "out_cnt": (L, N),
              "aligned_cnt": (L, N), "n_read": (L, N), "n_span": (L, N),
              "in_w": (L, N, E), "out_ids": (L, N, E), "out_w": (L, N, E),
              "aligned": (L, N, A), "node_n": (L,), "ok": (L,)}
    for k, s in shapes.items():
        if tuple(t[k].shape) != s:
            raise ValueError(f"fuse_alignment_lanes: {k} must have shape {s}")
    fwd_op, fwd_arg, n_fwd, query, weight, qlen = args
    T, Q = fwd_op.shape[1], query.shape[1]
    for k, v, s in (("fwd_op", fwd_op, (L, T)), ("fwd_arg", fwd_arg, (L, T)),
                    ("n_fwd", n_fwd, (L,)), ("query", query, (L, Q)),
                    ("weight", weight, (L, Q)), ("qlen", qlen, (L,))):
        if tuple(v.shape) != s:
            raise ValueError(f"fuse_alignment_lanes: {k} must have shape {s}")
    return L, N, E, A, T, Q


def fuse_alignment_lanes(g: DeviceGraph, fwd_op, fwd_arg, n_fwd, query,
                         weight, qlen, Pcap: int,
                         lanes: Optional[list] = None):
    """The sequential fusion of each listed lane's op stream into a copy of
    the stacked graph `g`; see the module docstring. `lanes` (host ints)
    lists the lanes to fuse (None: all). Returns (the fused copy, path,
    path_len)."""
    args = (fwd_op, fwd_arg, n_fwd, query, weight, qlen)
    out = DeviceGraph(**{k: v.clone(memory_format=torch.contiguous_format)
                         for k, v in g.tensors().items()})
    L, N, E, A, T, Q = _check(out, args)
    dev = g.base.device
    path = torch.zeros((L, Pcap), dtype=torch.int32, device=dev)
    path_len = torch.zeros(L, dtype=torch.int32, device=dev)
    todo = list(range(L)) if lanes is None else [int(x) for x in lanes]
    if not todo:
        return out, path, path_len
    if dev.type == "cpu":
        fuse_alignment_torch(out, *args, path, path_len, todo)
        return out, path, path_len
    if dev.type != "cuda":
        raise ValueError(f"fuse_alignment_lanes: unsupported device {dev}")
    lib = build.load()
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        lanes_t = build.lane_list(lanes, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_fuse_alignment(
            *(ptr(getattr(out, k)) for k in _GRAPH), *(ptr(t) for t in args),
            ptr(path), ptr(path_len), ptr(lanes_t), len(todo), N, E, A, T, Q,
            Pcap, ctypes.c_void_p(stream))
    build.check(err, "fuse_alignment_lanes launch")
    fuse_alignment_lanes.launches += 1
    return out, path, path_len


fuse_alignment_lanes.launches = 0


def fuse_alignment_torch(out: DeviceGraph, fwd_op, fwd_arg, n_fwd, query,
                         weight, qlen, path, path_len, lanes: list) -> None:
    """The plain version of the launch, in place on the copy `out`: the
    walk of `device_graph.fuse_alignment` for each listed lane."""
    T = fwd_op.shape[1]
    Pcap = path.shape[1]
    for l in lanes:
        g_l, p = fuse_alignment(lane_graph(out, l), fwd_op[l], fwd_arg[l],
                                min(max(int(n_fwd[l]), 0), T), query[l],
                                int(qlen[l]), weight[l])
        for k, v in g_l.tensors().items():
            getattr(out, k)[l] = v
        p = p[:Pcap]
        if p:
            path[l, :len(p)] = torch.tensor(p, dtype=torch.int32)
        path_len[l] = len(p)
