"""Graph state carried across as plain numpy arrays.

abPOA has no weights; its state is the graph. `graph_to_numpy` exports a
graph (this package's `POAGraph` or native graph, or any object with the
same node and array attributes, such as `abpoa_tpu`'s `POAGraph` and what
its `NativePOAGraph.to_python` returns) to a dict of arrays, and
`graph_from_numpy` / `native_graph_from_numpy` build this package's
`POAGraph` / native graph from it, so a run can be continued here from a
graph built elsewhere.

Arrays (N nodes; edge lists in CSR form, in each node's edge order):
  base, n_read, n_span_read (N,) int64
  in_ptr (N+1,), in_ids, in_w (E_in,) int64
  out_ptr (N+1,), out_ids, out_w (E_out,) int64
  out_read_ids (E_out, words) uint64: read-id bitset of each out edge,
      64 read ids per word, least significant first
  aligned_ptr (N+1,), aligned_ids int64
  read_weight_ptr (N+1,), read_weight_ids, read_weight_w int64: each node's
      per-read qv weights (`-Q -d > 1`) in insertion order
  index_to_node_id, node_id_to_index, remain, mpl, mpr (N,) int32
  is_topological_sorted () bool

`fused_state_to_numpy` / `fused_state_from_numpy` carry the fused loop's
device state the same way: the dense `DeviceGraph` arrays (base, in_ids,
in_w, in_cnt, out_ids, out_w, out_cnt, aligned, aligned_cnt, n_read, n_span
as int32, node_n and ok as scalars), the topological order `order`, `n2i`,
`remain` and the counters `read_idx`, `err`, `kahn_runs`, `collisions`. The
JAX package's `FusedState` (any object with those attributes whose arrays
numpy can read) converts to the same dict, so a state can cross between the
two packages in either direction.
"""
from __future__ import annotations

from itertools import chain

import numpy as np

from .graph import Node, POAGraph

_GRAPH_FIELDS = ("base", "in_ids", "in_w", "in_cnt", "out_ids", "out_w",
                 "out_cnt", "aligned", "aligned_cnt", "n_read", "n_span")
_COUNTERS = ("read_idx", "err", "kahn_runs", "collisions")

_MASK64 = (1 << 64) - 1


def _csr(lists):
    counts = np.fromiter((len(x) for x in lists), dtype=np.int64, count=len(lists))
    ptr = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    flat = np.fromiter(chain.from_iterable(lists), dtype=np.int64, count=int(ptr[-1]))
    return ptr, flat


def graph_to_numpy(g) -> dict:
    if getattr(g, "is_native", False):
        g = g.to_python()
    nodes = g.nodes
    n = len(nodes)
    in_ptr, in_ids = _csr([nd.in_ids for nd in nodes])
    _, in_w = _csr([nd.in_w for nd in nodes])
    out_ptr, out_ids = _csr([nd.out_ids for nd in nodes])
    _, out_w = _csr([nd.out_w for nd in nodes])
    aligned_ptr, aligned_ids = _csr([nd.aligned_ids for nd in nodes])
    rw_ptr, rw_ids = _csr([list(nd.read_weight) for nd in nodes])
    _, rw_w = _csr([list(nd.read_weight.values()) for nd in nodes])
    bitsets = [b for nd in nodes for b in nd.read_ids]
    words = max(1, max((b.bit_length() for b in bitsets), default=0) + 63 >> 6)
    out_read_ids = np.zeros((len(bitsets), words), dtype=np.uint64)
    for e, b in enumerate(bitsets):
        for k in range(words):
            out_read_ids[e, k] = (b >> (64 * k)) & _MASK64
    arr = lambda a: np.asarray(a[:n], dtype=np.int32).copy()  # noqa: E731
    return {
        "base": np.fromiter((nd.base for nd in nodes), dtype=np.int64, count=n),
        "n_read": np.fromiter((nd.n_read for nd in nodes), dtype=np.int64, count=n),
        "n_span_read": np.fromiter((nd.n_span_read for nd in nodes), dtype=np.int64, count=n),
        "in_ptr": in_ptr, "in_ids": in_ids, "in_w": in_w,
        "out_ptr": out_ptr, "out_ids": out_ids, "out_w": out_w,
        "out_read_ids": out_read_ids,
        "aligned_ptr": aligned_ptr, "aligned_ids": aligned_ids,
        "read_weight_ptr": rw_ptr, "read_weight_ids": rw_ids,
        "read_weight_w": rw_w,
        "index_to_node_id": arr(g.index_to_node_id),
        "node_id_to_index": arr(g.node_id_to_index),
        "remain": arr(g.node_id_to_max_remain),
        "mpl": arr(g.node_id_to_max_pos_left),
        "mpr": arr(g.node_id_to_max_pos_right),
        "is_topological_sorted": np.asarray(bool(g.is_topological_sorted)),
    }


def graph_from_numpy(a: dict) -> POAGraph:
    n = len(a["base"])
    g = POAGraph()
    g.nodes = [Node(i, int(b)) for i, b in enumerate(a["base"].tolist())]

    def rows(ptr, flat):
        flat = flat.tolist()
        ptr = ptr.tolist()
        return [flat[ptr[i]: ptr[i + 1]] for i in range(n)]

    in_ids, in_w = rows(a["in_ptr"], a["in_ids"]), rows(a["in_ptr"], a["in_w"])
    out_ids, out_w = rows(a["out_ptr"], a["out_ids"]), rows(a["out_ptr"], a["out_w"])
    aligned = rows(a["aligned_ptr"], a["aligned_ids"])
    rw_ids = rows(a["read_weight_ptr"], a["read_weight_ids"])
    rw_w = rows(a["read_weight_ptr"], a["read_weight_w"])
    words = a["out_read_ids"].tolist()
    bitsets = [sum(int(v) << (64 * k) for k, v in enumerate(row)) for row in words]
    out_ptr = a["out_ptr"].tolist()
    n_read, n_span = a["n_read"].tolist(), a["n_span_read"].tolist()
    for i, nd in enumerate(g.nodes):
        nd.in_ids, nd.in_w = in_ids[i], in_w[i]
        nd.out_ids, nd.out_w = out_ids[i], out_w[i]
        nd.read_ids = bitsets[out_ptr[i]: out_ptr[i + 1]]
        nd.aligned_ids = aligned[i]
        nd.n_read, nd.n_span_read = n_read[i], n_span[i]
        nd.read_weight = dict(zip(rw_ids[i], rw_w[i]))
    i32 = lambda k: np.asarray(a[k], dtype=np.int32).copy()  # noqa: E731
    g.index_to_node_id = i32("index_to_node_id")
    g.node_id_to_index = i32("node_id_to_index")
    g.node_id_to_max_remain = i32("remain")
    g.node_id_to_max_pos_left = i32("mpl")
    g.node_id_to_max_pos_right = i32("mpr")
    g.is_topological_sorted = bool(a["is_topological_sorted"])
    return g


def native_graph_from_numpy(a: dict):
    """This package's native graph from `graph_to_numpy`'s dict."""
    from .native.graph import NativePOAGraph
    g = NativePOAGraph()
    g.load_arrays(a)
    return g


def _as_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fused_state_to_numpy(state) -> dict:
    """The fused loop's state (this package's or the JAX package's) as a
    dict of numpy arrays and ints."""
    g = state.g
    out = {k: _as_numpy(getattr(g, k)).astype(np.int32) for k in _GRAPH_FIELDS}
    out["node_n"] = int(_as_numpy(g.node_n))
    out["ok"] = bool(_as_numpy(g.ok))
    for k in ("order", "n2i", "remain"):
        out[k] = _as_numpy(getattr(state, k)).astype(np.int32)
    for k in _COUNTERS:
        out[k] = int(_as_numpy(getattr(state, k)))
    return out


def fused_state_from_numpy(a: dict, device="cpu"):
    """This package's `FusedState` on `device` from `fused_state_to_numpy`'s
    dict."""
    import torch

    from .align.device_graph import DeviceGraph
    from .align.fused_loop import FusedState
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)  # noqa: E731
    g = DeviceGraph(**{k: t(a[k]) for k in _GRAPH_FIELDS},
                    node_n=torch.tensor(a["node_n"], dtype=torch.int32,
                                        device=device),
                    ok=torch.tensor(bool(a["ok"]), device=device))
    return FusedState(g=g, order=t(a["order"]), n2i=t(a["n2i"]),
                      remain=t(a["remain"]),
                      **{k: int(a[k]) for k in _COUNTERS})
