"""Host-side partial-order alignment DAG.

The mutable graph that the DP kernel reads a snapshot of: cigar fusion,
topological sort with aligned-group atomicity and adaptive-band metadata
(abPOA src/abpoa_graph.c), and the read-id bitset of each out edge, set
when `Params.use_read_ids` is (a Python int per edge, so any read count fits
without the reference's `tot_read_n` words), and with `-Q -d > 1` each
node's qv weight per read (`Node.read_weight`, which the clustered
consensus sums).
- topo sort keeps mismatch-aligned node groups adjacent (:221-266)
- in/out edges are sorted by weight descending with abPOA's exact
  (unstable) exchange sort (:192-219); edge order feeds the DP tie-breaks
- max_remain is the longest-heaviest-remaining-path metric driving the
  adaptive band (:268-309)
- cigar->graph fusion rules (:680-774)
- MSA column ranks by a LIFO walk (:359-419)
- `-G`'s path score of an in-edge (:429-437)
"""
from __future__ import annotations

import math
from collections import deque
from typing import List, Optional

import numpy as np

from . import constants as C
from .params import Params


def _add_read_weight(abpt: Params) -> bool:
    """Per-read qv weights are kept for the clustered consensus of `-Q`
    with `-d > 1` (abpoa_tpu/graph.py:380)."""
    return abpt.use_qv and abpt.max_n_cons > 1


class Node:
    __slots__ = ("node_id", "base", "in_ids", "in_w", "out_ids", "out_w",
                 "read_ids", "aligned_ids", "n_read", "n_span_read",
                 "read_weight")

    def __init__(self, node_id: int, base: int = 0):
        self.node_id = node_id
        self.base = base
        self.in_ids: List[int] = []
        self.in_w: List[int] = []
        self.out_ids: List[int] = []
        self.out_w: List[int] = []
        self.read_ids: List[int] = []  # python-int bitset per out edge
        self.aligned_ids: List[int] = []
        self.n_read = 0
        self.n_span_read = 0
        # read id -> the qv weight of that read's last edge out of this
        # node (per node, not per edge, as abpoa_tpu/graph.py keeps it)
        self.read_weight: dict = {}


class POAGraph:
    def __init__(self) -> None:
        self.nodes: List[Node] = [Node(C.SRC_NODE_ID), Node(C.SINK_NODE_ID)]
        self.is_topological_sorted = False
        self.is_called_cons = False
        self.is_set_msa_rank = False
        self.index_to_node_id: np.ndarray = np.zeros(0, dtype=np.int32)
        self.node_id_to_index: np.ndarray = np.zeros(0, dtype=np.int32)
        self.node_id_to_msa_rank: np.ndarray = np.zeros(0, dtype=np.int32)
        self.node_id_to_max_pos_left: np.ndarray = np.zeros(0, dtype=np.int32)
        self.node_id_to_max_pos_right: np.ndarray = np.zeros(0, dtype=np.int32)
        self.node_id_to_max_remain: np.ndarray = np.zeros(0, dtype=np.int32)

    @property
    def node_n(self) -> int:
        return len(self.nodes)

    def reset(self) -> None:
        self.nodes = [Node(C.SRC_NODE_ID), Node(C.SINK_NODE_ID)]
        self.is_topological_sorted = self.is_called_cons = False
        self.is_set_msa_rank = False

    def add_node(self, base: int) -> int:
        node_id = len(self.nodes)
        self.nodes.append(Node(node_id, base))
        return node_id

    def add_edge(self, from_id: int, to_id: int, check_edge: bool, w: int,
                 add_read_id: bool = False, read_id: int = 0,
                 add_read_weight: bool = False) -> None:
        """Add or reweight an edge (src/abpoa_graph.c:480-556), setting bit
        `read_id` of its read-id bitset when `add_read_id`, and the source
        node's weight of `read_id` to `w` when `add_read_weight`. `n_read`
        of the source node is incremented unconditionally, as in abPOA."""
        fr, to = self.nodes[from_id], self.nodes[to_id]
        out_edge_i = -1
        if check_edge:
            for i, t in enumerate(to.in_ids):
                if t == from_id:
                    to.in_w[i] += w
                    break
            for i, t in enumerate(fr.out_ids):
                if t == to_id:
                    fr.out_w[i] += w
                    out_edge_i = i
                    break
        if out_edge_i < 0:
            to.in_ids.append(from_id)
            to.in_w.append(w)
            fr.out_ids.append(to_id)
            fr.out_w.append(w)
            fr.read_ids.append(0)
            out_edge_i = len(fr.out_ids) - 1
        if add_read_id:
            fr.read_ids[out_edge_i] |= 1 << read_id
        fr.n_read += 1
        if add_read_weight:
            fr.read_weight[read_id] = w

    def write_band(self, beg_index: int, gn: int, mpl: np.ndarray,
                   mpr: np.ndarray) -> None:
        """Set the mpl/mpr of rows beg_index..beg_index + gn - 1."""
        nids = self.index_to_node_id[beg_index: beg_index + gn]
        self.node_id_to_max_pos_left[nids] = mpl
        self.node_id_to_max_pos_right[nids] = mpr

    def get_aligned_id(self, node_id: int, base: int) -> int:
        for aln_id in self.nodes[node_id].aligned_ids:
            if self.nodes[aln_id].base == base:
                return aln_id
        return -1

    def add_aligned_node(self, node_id: int, aligned_id: int) -> None:
        """Register mutual alignment between `aligned_id` and node_id's group
        (src/abpoa_graph.c:455-463)."""
        node = self.nodes[node_id]
        for ex in node.aligned_ids:
            self.nodes[ex].aligned_ids.append(aligned_id)
            self.nodes[aligned_id].aligned_ids.append(ex)
        node.aligned_ids.append(aligned_id)
        self.nodes[aligned_id].aligned_ids.append(node_id)

    def incre_path_score(self, node_id: int, in_idx: int) -> int:
        """`-G`'s log-scaled score of in-edge `in_idx` of `node_id`
        (src/abpoa_graph.c:429-437): log(edge weight / the predecessor's
        out weight), rounded half away from zero as C's round(), at least
        -20; 0 where either weight is 0."""
        pre_id = self.nodes[node_id].in_ids[in_idx]
        node_w = sum(self.nodes[pre_id].out_w)
        edge_w = self.nodes[node_id].in_w[in_idx]
        if node_w == 0 or edge_w == 0:
            return 0
        v = math.log(edge_w / node_w)
        score = math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)
        return max(score, -20)

    # ------------------------------------------------------- topological sort
    def _sort_in_out_ids(self) -> None:
        # exact replication of abPOA's exchange sort incl. tie behavior
        for node in self.nodes:
            in_ids, in_w = node.in_ids, node.in_w
            n = len(in_ids)
            for j in range(n - 1):
                for k in range(j + 1, n):
                    if in_w[j] < in_w[k]:
                        in_ids[j], in_ids[k] = in_ids[k], in_ids[j]
                        in_w[j], in_w[k] = in_w[k], in_w[j]
            out_ids, out_w, rids = node.out_ids, node.out_w, node.read_ids
            n = len(out_ids)
            for j in range(n - 1):
                for k in range(j + 1, n):
                    if out_w[j] < out_w[k]:
                        out_ids[j], out_ids[k] = out_ids[k], out_ids[j]
                        out_w[j], out_w[k] = out_w[k], out_w[j]
                        rids[j], rids[k] = rids[k], rids[j]

    def _bfs_set_node_index(self) -> None:
        n = self.node_n
        in_degree = [len(nd.in_ids) for nd in self.nodes]
        if len(self.index_to_node_id) < n:
            self.index_to_node_id = np.zeros(n, dtype=np.int32)
            self.node_id_to_index = np.zeros(n, dtype=np.int32)
        q: deque[int] = deque([C.SRC_NODE_ID])
        index = 0
        while q:
            cur = q.popleft()
            self.index_to_node_id[index] = cur
            self.node_id_to_index[cur] = index
            index += 1
            if cur == C.SINK_NODE_ID:
                return
            for out_id in self.nodes[cur].out_ids:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    # aligned-group atomicity: emit the whole mismatch group at once
                    if any(in_degree[a] != 0 for a in self.nodes[out_id].aligned_ids):
                        continue
                    q.append(out_id)
                    for a in self.nodes[out_id].aligned_ids:
                        q.append(a)
        raise RuntimeError("Failed to set node index (cycle in POA graph?)")

    def _bfs_set_node_remain(self) -> None:
        n = self.node_n
        if len(self.node_id_to_max_remain) < n:
            self.node_id_to_max_remain = np.zeros(n, dtype=np.int32)
        remain = self.node_id_to_max_remain
        remain[:n] = 0
        out_degree = [len(nd.out_ids) for nd in self.nodes]
        q: deque[int] = deque([C.SINK_NODE_ID])
        remain[C.SINK_NODE_ID] = -1
        while q:
            cur = q.popleft()
            node = self.nodes[cur]
            if cur != C.SINK_NODE_ID:
                max_w, max_id = -1, -1
                for i, out_id in enumerate(node.out_ids):
                    if node.out_w[i] > max_w:
                        max_w = node.out_w[i]
                        max_id = out_id
                remain[cur] = remain[max_id] + 1
            if cur == C.SRC_NODE_ID:
                return
            for in_id in node.in_ids:
                out_degree[in_id] -= 1
                if out_degree[in_id] == 0:
                    q.append(in_id)
        raise RuntimeError("Failed to set node remain")

    def topological_sort(self, abpt: Params) -> None:
        """(src/abpoa_graph.c:322-357): the band metadata is set for banded
        runs, max_remain also for extend mode's Z-drop."""
        n = self.node_n
        if n <= 0:
            return
        self._bfs_set_node_index()
        self._sort_in_out_ids()
        if abpt.wb >= 0:
            if len(self.node_id_to_max_pos_left) < n:
                self.node_id_to_max_pos_left = np.zeros(n, dtype=np.int32)
                self.node_id_to_max_pos_right = np.zeros(n, dtype=np.int32)
            self.node_id_to_max_pos_right[:n] = 0
            self.node_id_to_max_pos_left[:n] = n
            self._bfs_set_node_remain()
        elif abpt.zdrop > 0:
            self._bfs_set_node_remain()
        self.is_topological_sorted = True

    # -------------------------------------------------------------- msa rank
    def set_msa_rank(self) -> None:
        """DFS column-rank assignment for the row-column MSA
        (src/abpoa_graph.c:359-419): a LIFO stack seeded with the source;
        aligned nodes share the rank of the first group member reached."""
        if self.is_set_msa_rank:
            return
        n = self.node_n
        if len(self.node_id_to_msa_rank) < n:
            self.node_id_to_msa_rank = np.zeros(n, dtype=np.int32)
        rank_arr = self.node_id_to_msa_rank
        in_degree = [len(nd.in_ids) for nd in self.nodes]
        stack: List[int] = [C.SRC_NODE_ID]
        rank_arr[C.SRC_NODE_ID] = -1
        msa_rank = 0
        while stack:
            cur = stack.pop()
            if rank_arr[cur] < 0:
                rank_arr[cur] = msa_rank
                for a in self.nodes[cur].aligned_ids:
                    rank_arr[a] = msa_rank
                msa_rank += 1
            if cur == C.SINK_NODE_ID:
                self.is_set_msa_rank = True
                return
            for out_id in self.nodes[cur].out_ids:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    if any(in_degree[a] != 0 for a in self.nodes[out_id].aligned_ids):
                        continue
                    stack.append(out_id)
                    rank_arr[out_id] = -1
                    for a in self.nodes[out_id].aligned_ids:
                        stack.append(a)
                        rank_arr[a] = -1
        raise RuntimeError("Error in set_msa_rank")

    def msa_rank_of(self, node_id: int) -> int:
        """A node's MSA column: the largest rank over its aligned group
        (src/abpoa_output.c:136-142)."""
        rank = int(self.node_id_to_msa_rank[node_id])
        for a in self.nodes[node_id].aligned_ids:
            rank = max(rank, int(self.node_id_to_msa_rank[a]))
        return rank

    # ---------------------------------------------------------------- fusion
    def update_n_span_reads(self, beg_node_id: int, end_node_id: int,
                            inc_both_ends: bool) -> None:
        src_index = int(self.node_id_to_index[beg_node_id])
        sink_index = int(self.node_id_to_index[end_node_id])
        for i in range(src_index + 1, sink_index):
            self.nodes[int(self.index_to_node_id[i])].n_span_read += 1
        if inc_both_ends:
            self.nodes[beg_node_id].n_span_read += 1
            self.nodes[end_node_id].n_span_read += 1

    def add_sequence(self, abpt: Params, seq: np.ndarray, weight: np.ndarray,
                     read_id: int = 0,
                     qpos_to_node_id: Optional[np.ndarray] = None) -> None:
        """Seed an empty graph with a chain of nodes (src/abpoa_graph.c:573-593);
        `qpos_to_node_id`, when given, receives each base's node."""
        seq_l = len(seq)
        if seq_l <= 0:
            return
        rid, rw = abpt.use_read_ids, _add_read_weight(abpt)
        last_id = C.SRC_NODE_ID
        for i in range(seq_l):
            cur = self.add_node(int(seq[i]))
            if qpos_to_node_id is not None:
                qpos_to_node_id[i] = cur
            self.add_edge(last_id, cur, False, int(weight[i]), rid, read_id, rw)
            self.nodes[cur].n_span_read = self.nodes[last_id].n_span_read
            last_id = cur
        self.add_edge(last_id, C.SINK_NODE_ID, False, int(weight[seq_l - 1]),
                      rid, read_id, rw)
        self.is_called_cons = self.is_set_msa_rank = False
        self.is_topological_sorted = False
        self.topological_sort(abpt)
        self.update_n_span_reads(C.SRC_NODE_ID, C.SINK_NODE_ID, True)

    def add_subgraph_alignment(self, abpt: Params, beg_node_id: int, end_node_id: int,
                               seq: np.ndarray, weight: Optional[np.ndarray],
                               cigar: list, inc_both_ends: bool,
                               read_id: int = 0,
                               qpos_to_node_id: Optional[np.ndarray] = None
                               ) -> None:
        """Fuse read `read_id`'s alignment into the graph
        (src/abpoa_graph.c:689-774). cigar is a list of packed 64-bit ops
        (see cigar.py). `qpos_to_node_id`, when given, receives the node
        each aligned or inserted base lands on (the seeded route reads it)."""
        seq_l = len(seq)
        if weight is None:
            weight = np.ones(seq_l, dtype=np.int64)
        if self.node_n == 2:  # empty graph
            self.add_sequence(abpt, seq, weight, read_id, qpos_to_node_id)
            return
        rid, rw = abpt.use_read_ids, _add_read_weight(abpt)
        if not cigar:
            return
        query_id = -1
        last_new = False
        last_id = beg_node_id
        for op_pack in cigar:
            op = op_pack & 0xF
            if op == C.CMATCH:
                node_id = (op_pack >> 34) & 0x3FFFFFFF
                query_id += 1
                base = int(seq[query_id])
                add = bool(last_id != beg_node_id or inc_both_ends)
                if self.nodes[node_id].base != base:  # mismatch
                    aligned_id = self.get_aligned_id(node_id, base)
                    if aligned_id != -1:
                        self.add_edge(last_id, aligned_id, not last_new, int(weight[query_id]),
                                      rid and add, read_id, rw)
                        if not add:
                            self.nodes[last_id].n_read -= 1
                        last_id, last_new = aligned_id, False
                    else:
                        new_id = self.add_node(base)
                        self.add_edge(last_id, new_id, False, int(weight[query_id]),
                                      rid and add, read_id, rw)
                        self.nodes[new_id].n_span_read = self.nodes[last_id].n_span_read
                        if not add:
                            self.nodes[last_id].n_read -= 1
                        last_id, last_new = new_id, True
                        self.add_aligned_node(node_id, new_id)
                else:  # match
                    self.add_edge(last_id, node_id, not last_new, int(weight[query_id]),
                                  rid and add, read_id, rw)
                    if not add:
                        self.nodes[last_id].n_read -= 1
                    last_id, last_new = node_id, False
                if qpos_to_node_id is not None:
                    qpos_to_node_id[query_id] = last_id
            elif op in (C.CINS, C.CSOFT_CLIP, C.CHARD_CLIP):
                length = (op_pack >> 4) & 0x3FFFFFFF
                query_id += length
                for j in range(length - 1, -1, -1):
                    new_id = self.add_node(int(seq[query_id - j]))
                    add = bool(last_id != beg_node_id or inc_both_ends)
                    self.add_edge(last_id, new_id, False, int(weight[query_id - j]),
                                  rid and add, read_id, rw)
                    self.nodes[new_id].n_span_read = self.nodes[last_id].n_span_read
                    if not add:
                        self.nodes[last_id].n_read -= 1
                    last_id, last_new = new_id, True
                    if qpos_to_node_id is not None:
                        qpos_to_node_id[query_id - j] = last_id
            elif op == C.CDEL:
                continue
        self.add_edge(last_id, end_node_id, not last_new, int(weight[seq_l - 1]),
                      rid, read_id, rw)
        self.is_called_cons = self.is_set_msa_rank = False
        self.is_topological_sorted = False
        self.topological_sort(abpt)
        self.update_n_span_reads(beg_node_id, end_node_id, inc_both_ends)

    def add_alignment(self, abpt: Params, seq: np.ndarray, weight: Optional[np.ndarray],
                      cigar: list, inc_both_ends: bool, read_id: int = 0) -> None:
        self.add_subgraph_alignment(abpt, C.SRC_NODE_ID, C.SINK_NODE_ID, seq,
                                    weight, cigar, inc_both_ends, read_id)
