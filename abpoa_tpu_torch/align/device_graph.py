"""The POA graph as dense tensors on one device, and sequential fusion.

Counterpart of `abpoa_tpu/align/device_graph.py`: `DeviceGraph`,
`init_device_graph` and `fuse_alignment` with its helpers `_add_edge`,
`_get_aligned_id` and `_add_aligned` (reference src/abpoa_graph.c:455-774).
The Kahn repair `topo_sort` is kernel K1, in `topo_kernel.py`.

Capacities (N nodes, E edge slots per node and direction, A aligned slots)
are fixed per tensor; a fusion that would pass one clears `ok` and the fused
loop grows the capacities and reruns the read. Slots past a node's count are
zero, an invariant the vectorised fusion relies on.

`fuse_alignment` is the sequential fusion the fused loop takes only when two
mismatch columns of one read touch the same aligned-node group (a
"collision"; none on the test fixtures and on the headline set), in the plain
version of kernel F1 (`fuse_kernel.py`): it walks the op stream in Python
over the graph's first node_n rows, copied to the host, and copies those rows
back: the same steps as the JAX function, one op at a time, past a capacity
too (a row past N reads as row N - 1 and takes no write, as JAX clamps its
gathers and drops its scatters). It also returns the node path the read
took, which the fused loop records for the read-id outputs (the JAX loop
hands such a run to its host loop instead).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from .. import constants as C


@dataclass
class DeviceGraph:
    base: torch.Tensor         # (N,) int32
    in_ids: torch.Tensor       # (N, E)
    in_w: torch.Tensor         # (N, E)
    in_cnt: torch.Tensor       # (N,)
    out_ids: torch.Tensor      # (N, E)
    out_w: torch.Tensor        # (N, E)
    out_cnt: torch.Tensor      # (N,)
    aligned: torch.Tensor      # (N, A)
    aligned_cnt: torch.Tensor  # (N,)
    n_read: torch.Tensor       # (N,)
    n_span: torch.Tensor       # (N,)
    node_n: torch.Tensor       # () int32
    ok: torch.Tensor           # () bool

    def _replace(self, **kw) -> "DeviceGraph":
        return replace(self, **kw)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @property
    def caps(self) -> tuple:
        """(N, E, A)."""
        return (self.in_ids.shape[0], self.in_ids.shape[1],
                self.aligned.shape[1])


def init_device_graph(N: int, E: int, A: int, device) -> DeviceGraph:
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    return DeviceGraph(
        base=z(N), in_ids=z(N, E), in_w=z(N, E), in_cnt=z(N),
        out_ids=z(N, E), out_w=z(N, E), out_cnt=z(N),
        aligned=z(N, A), aligned_cnt=z(N), n_read=z(N), n_span=z(N),
        node_n=torch.tensor(2, dtype=torch.int32, device=device),
        ok=torch.tensor(True, device=device))


class _HostGraph:
    """The graph's first node_n rows as nested Python lists for the
    sequential fusion; `new_node` appends a row."""

    def __init__(self, g: DeviceGraph):
        self.N, self.E, self.A = g.caps
        n = int(g.node_n)
        for k, v in g.tensors().items():
            setattr(self, k, v[:n].tolist() if v.dim() else v.item())

    def to_device(self, like: DeviceGraph) -> DeviceGraph:
        """`like` with its first rows replaced by this graph's rows."""
        dev = like.base.device
        m = len(self.base)
        kw = {}
        for f in fields(like):
            v, t = getattr(self, f.name), getattr(like, f.name)
            if t.dim() == 0:
                kw[f.name] = torch.tensor(v, dtype=t.dtype, device=dev)
            else:
                t = t.clone()
                t[:m] = torch.tensor(v, dtype=t.dtype, device=dev)
                kw[f.name] = t
        return DeviceGraph(**kw)

    # ---- device_graph.py:62-116, one scalar step at a time. A row past
    # the capacity N (a node id the walk made after it passed N) is read as
    # row N - 1 and written nowhere, as JAX clamps a gather and drops a
    # scatter out of range; the run is already marked failed.
    def _r(self, row: int) -> int:
        return min(row, self.N - 1)

    def add_edge(self, fr: int, to: int, check: bool, w: int) -> None:
        """Append-or-reweight fr->to (abpoa_graph.c:480-556)."""
        E, N = self.E, self.N
        fr_r, to_r = self._r(fr), self._r(to)
        o_ids, i_ids = self.out_ids[fr_r], self.in_ids[to_r]
        o_slot = self.out_cnt[fr_r]
        o_exists = False
        if check:
            for k in range(min(self.out_cnt[fr_r], E)):
                if o_ids[k] == to:
                    o_slot, o_exists = k, True
                    break
        i_slot = self.in_cnt[to_r]
        i_exists = False
        if check:
            for k in range(min(self.in_cnt[to_r], E)):
                if i_ids[k] == fr:
                    i_slot, i_exists = k, True
                    break
        self.ok = self.ok and o_slot < E and i_slot < E
        # an out-of-range slot writes nowhere (JAX drops it); the run is
        # already marked failed and its state is discarded
        if fr < N:
            if o_slot < E:
                o_ids[o_slot] = to
                self.out_w[fr][o_slot] = (self.out_w[fr][o_slot] + w
                                          if o_exists else w)
            if not o_exists:
                self.out_cnt[fr] += 1
            self.n_read[fr] += 1
        if to < N:
            if i_slot < E:
                i_ids[i_slot] = fr
                self.in_w[to][i_slot] = (self.in_w[to][i_slot] + w
                                         if i_exists else w)
            if not i_exists:
                self.in_cnt[to] += 1

    def get_aligned_id(self, node_id: int, b: int) -> int:
        ids = self.aligned[self._r(node_id)]
        for k in range(min(self.aligned_cnt[self._r(node_id)], self.A)):
            if self.base[self._r(ids[k])] == b:
                return ids[k]
        return -1

    def _append_aligned(self, row: int, v: int) -> None:
        if row >= self.N:
            return
        if self.aligned_cnt[row] < self.A:
            self.aligned[row][self.aligned_cnt[row]] = v
        self.aligned_cnt[row] += 1

    def add_aligned(self, node_id: int, new_id: int) -> None:
        """Mutual registration across the mismatch group
        (abpoa_graph.c:455-463)."""
        A, r = self.A, self._r
        for k in range(self.aligned_cnt[r(node_id)]):
            ex = self.aligned[r(node_id)][min(k, A - 1)]
            self.ok = (self.ok and self.aligned_cnt[r(ex)] < A
                       and self.aligned_cnt[r(new_id)] < A)
            self._append_aligned(ex, new_id)
            self._append_aligned(new_id, ex)
        self.ok = (self.ok and self.aligned_cnt[r(node_id)] < A
                   and self.aligned_cnt[r(new_id)] < A)
        self._append_aligned(node_id, new_id)
        self._append_aligned(new_id, node_id)

    def new_node(self, b: int) -> int:
        nid = self.node_n
        if nid < self.N:  # nid == len(self.base): append its row
            E, A = self.E, self.A
            self.base.append(b)
            for rows, width in ((self.in_ids, E), (self.in_w, E),
                                (self.out_ids, E), (self.out_w, E),
                                (self.aligned, A)):
                rows.append([0] * width)
            for col in (self.in_cnt, self.out_cnt, self.aligned_cnt,
                        self.n_read, self.n_span):
                col.append(0)
        self.ok = self.ok and nid < self.N
        self.node_n += 1
        return nid

    def set_span(self, nid: int, last: int) -> None:
        if nid < self.N:
            self.n_span[nid] = self.n_span[self._r(last)]


def fuse_alignment(g: DeviceGraph, fwd_op, fwd_arg, n_fwd: int, query,
                   qlen: int, weight) -> tuple:
    """Fuse one read's forward op stream into a non-empty graph
    (abpoa_graph.c:689-774, device_graph.py:120-206): op 0 matches the node
    in `fwd_arg` (reusing or creating an aligned node on a mismatch), op 2
    inserts a new node, op 1 deletes. `fwd_op`/`fwd_arg` are int tensors,
    `query`/`weight` the read's padded base and weight tensors. Returns
    (graph, path): the path is the node each consumed op ended on, so the
    read's edges are SRC -> path[0] -> ... -> path[-1] -> SINK."""
    h = _HostGraph(g)
    ops = fwd_op[:n_fwd].tolist()
    args = fwd_arg[:n_fwd].tolist()
    q = query.tolist()
    wt = weight.tolist()
    Q = len(q)
    last, last_new, qpos = C.SRC_NODE_ID, 0, 0
    path = []
    for op, arg in zip(ops, args):
        if op not in (0, 2):
            continue
        b, w = q[min(qpos, Q - 1)], wt[min(qpos, Q - 1)]
        if op == 0 and h.base[arg] == b:
            h.add_edge(last, arg, last_new == 0, w)
            last, last_new = arg, 0
        else:
            aln = h.get_aligned_id(arg, b) if op == 0 else -1
            if aln >= 0:
                h.add_edge(last, aln, last_new == 0, w)
                last, last_new = aln, 0
            else:
                nid = h.new_node(b)
                h.add_edge(last, nid, False, w)
                h.set_span(nid, last)
                if op == 0:
                    h.add_aligned(arg, nid)
                last, last_new = nid, 1
        qpos += 1
        path.append(last)
    h.add_edge(last, C.SINK_NODE_ID, last_new == 0, wt[max(qlen - 1, 0)])
    return h.to_device(g), path
