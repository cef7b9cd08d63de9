"""Consensus calling: heaviest bundling and majority vote, over one cluster
or the read clusters of `cluster.py` (abPOA src/abpoa_output.c: heaviest
bundling :478-548, max-path walk :376-392, majority vote :394-452,550-587,
phred :297-303, coverage :347-374, driver :1184-1215).

With clusters, an edge weighs the number of the cluster's reads on it, or,
with `-Q` and `-d > 1`, the sum of those reads' qv weights kept on its node
(`Node.read_weight`, as the JAX package keeps them).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import constants as C
from ..graph import Node, POAGraph
from ..params import Params

NAT_E = 2.718281828459045


@dataclass
class ConsensusResult:
    n_cons: int = 0
    n_seq: int = 0
    clu_n_seq: List[int] = field(default_factory=list)
    clu_read_ids: List[List[int]] = field(default_factory=list)
    cons_node_ids: List[List[int]] = field(default_factory=list)
    cons_base: List[List[int]] = field(default_factory=list)
    cons_cov: List[List[int]] = field(default_factory=list)
    cons_phred: List[List[int]] = field(default_factory=list)
    msa_len: int = 0
    msa_base: List[np.ndarray] = field(default_factory=list)  # n_seq + n_cons rows

    @property
    def cons_len(self) -> List[int]:
        return [len(x) for x in self.cons_base]


def phred_score(n_cov: int, n_seq: int) -> int:
    """Sigmoid-mapped phred+33 (src/abpoa_output.c:297-303)."""
    if n_cov > n_seq:
        raise ValueError(f"unexpected n_cov/n_seq ({n_cov}/{n_seq})")
    x = 13.8 * (1.25 * n_cov / n_seq - 0.25)
    p = 1 - 1.0 / (1.0 + math.pow(NAT_E, -x))
    return 33 + int(-10 * math.log10(p) + 0.499)


def _edge_inclu_read_count(node: Node, edge_i: int, clu_bits: int) -> int:
    return (node.read_ids[edge_i] & clu_bits).bit_count()


def _edge_weight(node: Node, edge_i: int, clu_bits: Optional[int],
                 use_qv: bool, n_clu: int) -> int:
    """An out edge's weight for one cluster: its weight with one cluster,
    else its cluster's read count, or with `-Q` the sum of the qv weights
    the node keeps for those reads (abpoa_tpu/cons/consensus.py:71-83)."""
    if n_clu == 1:
        return node.out_w[edge_i]
    if not use_qv:
        return _edge_inclu_read_count(node, edge_i, clu_bits)
    w = 0
    bits = node.read_ids[edge_i] & clu_bits
    for rid, rw in node.read_weight.items():
        if rw > 0 and (bits >> rid) & 1:
            w += rw
    return w


def _node_out_cov(node: Node, clu_bits: Optional[int], n_cons: int) -> int:
    if n_cons == 1:
        return node.n_read
    return sum(_edge_inclu_read_count(node, i, clu_bits)
               for i in range(len(node.out_ids)))


def _node_in_cov(g: POAGraph, node_id: int, clu_bits: int) -> int:
    cov = 0
    for in_id in g.nodes[node_id].in_ids:
        pre = g.nodes[in_id]
        for j, out_id in enumerate(pre.out_ids):
            if out_id == node_id:
                cov += _edge_inclu_read_count(pre, j, clu_bits)
                break
    return cov


def _node_cov(g: POAGraph, node_id: int, clu_bits: Optional[int], n_cons: int) -> int:
    if n_cons == 1:
        return g.nodes[node_id].n_read
    return max(_node_in_cov(g, node_id, clu_bits),
               _node_out_cov(g.nodes[node_id], clu_bits, n_cons))


def _set_clu_read_ids(abc: ConsensusResult, clu_bits_list: Optional[List[int]],
                      n_clu: int, n_seq: int) -> None:
    abc.clu_n_seq = []
    abc.clu_read_ids = []
    if n_clu == 1:
        abc.clu_n_seq.append(n_seq)
        abc.clu_read_ids.append(list(range(n_seq)))
        return
    for bits in clu_bits_list:
        ids = [i for i in range(n_seq) if (bits >> i) & 1]
        abc.clu_n_seq.append(len(ids))
        abc.clu_read_ids.append(ids)


def heaviest_bundling(g: POAGraph, abpt: Params, n_clu: int,
                      clu_bits_list: Optional[List[int]], abc: ConsensusResult) -> None:
    """Reverse-BFS argmax-out-edge consensus, one per cluster
    (src/abpoa_output.c:478-548)."""
    n = g.node_n
    src, sink = C.SRC_NODE_ID, C.SINK_NODE_ID
    _set_clu_read_ids(abc, clu_bits_list, n_clu, abc.n_seq)
    abc.n_cons = n_clu
    abc.cons_node_ids, abc.cons_base, abc.cons_cov, abc.cons_phred = [], [], [], []

    score = [0] * n
    for cons_i in range(n_clu):
        clu_bits = clu_bits_list[cons_i] if clu_bits_list else None
        max_out_id = [-1] * n
        out_degree = [len(nd.out_ids) for nd in g.nodes]
        q: deque[int] = deque([sink])
        while q:
            cur = q.popleft()
            node = g.nodes[cur]
            if cur == sink:
                max_out_id[cur] = -1
                score[cur] = 0
            elif cur == src:
                path_score, path_max_w, max_id = -1, -1, -1
                for i, out_id in enumerate(node.out_ids):
                    out_w = _edge_weight(node, i, clu_bits, abpt.use_qv, n_clu)
                    if out_w > path_max_w or (out_w == path_max_w and score[out_id] > path_score):
                        max_id = out_id
                        path_score = score[out_id]
                        path_max_w = out_w
                max_out_id[cur] = max_id
                break
            else:
                max_w, max_id = -(1 << 31), -1
                for i, out_id in enumerate(node.out_ids):
                    out_w = _edge_weight(node, i, clu_bits, abpt.use_qv, n_clu)
                    if max_w < out_w:
                        max_w, max_id = out_w, out_id
                    elif max_w == out_w and score[max_id] <= score[out_id]:
                        max_id = out_id
                score[cur] = max_w + score[max_id]
                max_out_id[cur] = max_id
            for in_id in node.in_ids:
                out_degree[in_id] -= 1
                if out_degree[in_id] == 0:
                    q.append(in_id)

        ids: List[int] = []
        bases: List[int] = []
        covs: List[int] = []
        phreds: List[int] = []
        cur = max_out_id[src]
        while cur != sink:
            ids.append(cur)
            bases.append(g.nodes[cur].base)
            cov = _node_cov(g, cur, clu_bits, n_clu)
            covs.append(cov)
            phreds.append(phred_score(cov, abc.clu_n_seq[cons_i]))
            cur = max_out_id[cur]
        abc.cons_node_ids.append(ids)
        abc.cons_base.append(bases)
        abc.cons_cov.append(covs)
        abc.cons_phred.append(phreds)


def most_frequent(g: POAGraph, abpt: Params, n_clu: int,
                  clu_bits_list: Optional[List[int]], abc: ConsensusResult) -> None:
    """Column majority-vote consensus (src/abpoa_output.c:394-452,550-587)."""
    g.set_msa_rank()
    m = abpt.m
    msa_l = int(g.node_id_to_msa_rank[C.SINK_NODE_ID]) - 1
    abc.n_cons = n_clu
    _set_clu_read_ids(abc, clu_bits_list, n_clu, abc.n_seq)
    # per-cluster column weights; the gap column (m-1) starts at the cluster size
    rc_weight = [np.zeros((msa_l, m), dtype=np.int64) for _ in range(n_clu)]
    for cons_i in range(n_clu):
        rc_weight[cons_i][:, m - 1] = abc.clu_n_seq[cons_i]
    msa_node_id = np.zeros((msa_l, m), dtype=np.int64)
    for i in range(2, g.node_n):
        rank = g.msa_rank_of(i)
        node = g.nodes[i]
        msa_node_id[rank - 1, node.base] = i
        for cons_i in range(n_clu):
            clu_bits = clu_bits_list[cons_i] if clu_bits_list else None
            node_w = _node_out_cov(node, clu_bits, n_clu)
            rc_weight[cons_i][rank - 1, node.base] = node_w
            rc_weight[cons_i][rank - 1, m - 1] -= node_w

    abc.cons_node_ids, abc.cons_base, abc.cons_cov, abc.cons_phred = [], [], [], []
    for cons_i in range(n_clu):
        ids, bases, covs, phreds = [], [], [], []
        for i in range(msa_l):
            max_c, total_c, max_base = 0, 0, m
            for j in range(m - 1):
                cnt = int(rc_weight[cons_i][i, j])
                if cnt > max_c:
                    max_c = cnt
                    max_base = j
                total_c += cnt
            if abpt.sub_aln:
                gap_c = g.nodes[int(msa_node_id[i, max_base])].n_span_read - total_c
            else:
                gap_c = abc.clu_n_seq[cons_i] - total_c
            if max_c >= gap_c:
                ids.append(int(msa_node_id[i, max_base]))
                bases.append(max_base)
                covs.append(max_c)
                phreds.append(phred_score(max_c, abc.clu_n_seq[cons_i]))
        abc.cons_node_ids.append(ids)
        abc.cons_base.append(bases)
        abc.cons_cov.append(covs)
        abc.cons_phred.append(phreds)


def native_hb_eligible(g, abpt: Params) -> bool:
    """True when the native graph's C++ heaviest bundling covers the
    configuration (abpoa_tpu/cons/consensus.py:245): a native graph, one
    cluster, heaviest bundling, consensus without MSA. Callers add their
    own output exclusions (GFA, `-g`)."""
    return (getattr(g, "is_native", False) and abpt.out_cons
            and not abpt.out_msa and abpt.cons_algrm == C.CONS_HB
            and abpt.max_n_cons == 1)


def native_consensus_hb(g, n_seq: int) -> ConsensusResult:
    """The consensus of `native_hb_eligible` configurations straight from
    the native graph (apg_cons_hb), with no export of the graph."""
    abc = ConsensusResult(n_seq=n_seq)
    if g.node_n <= 2:
        return abc
    ids, bases, covs = g.consensus_hb()
    abc.n_cons = 1
    abc.clu_n_seq = [n_seq]
    abc.clu_read_ids = [list(range(n_seq))]
    abc.cons_node_ids = [ids.tolist()]
    abc.cons_base = [bases.tolist()]
    abc.cons_cov = [covs.tolist()]
    abc.cons_phred = [[phred_score(c, n_seq) for c in abc.cons_cov[0]]]
    return abc


def generate_consensus(g: POAGraph, abpt: Params, n_seq: int) -> ConsensusResult:
    """Consensus entry point (src/abpoa_output.c:1184-1215): the read
    clusters when `-d > 1`, then heaviest bundling or majority vote."""
    abc = ConsensusResult(n_seq=n_seq)
    if g.node_n <= 2:
        return abc
    n_clu = 1
    clu_bits_list: Optional[List[int]] = None
    if abpt.max_n_cons > 1:
        from .cluster import multip_read_clu_kmedoids
        n_clu, clu_bits_list = multip_read_clu_kmedoids(g, abpt, n_seq)
    if abpt.cons_algrm == C.CONS_HB:
        heaviest_bundling(g, abpt, n_clu, clu_bits_list, abc)
    else:
        most_frequent(g, abpt, n_clu, clu_bits_list, abc)
    g.is_called_cons = True
    return abc
