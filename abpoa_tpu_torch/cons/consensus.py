"""Heaviest-bundling consensus, one cluster (abPOA src/abpoa_output.c:
heaviest bundling :478-548, max-path walk :376-392, phred :297-303)."""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import List

from .. import constants as C
from ..graph import POAGraph
from ..params import Params

NAT_E = 2.718281828459045


@dataclass
class ConsensusResult:
    n_cons: int = 0
    n_seq: int = 0
    cons_node_ids: List[List[int]] = field(default_factory=list)
    cons_base: List[List[int]] = field(default_factory=list)
    cons_cov: List[List[int]] = field(default_factory=list)
    cons_phred: List[List[int]] = field(default_factory=list)


def phred_score(n_cov: int, n_seq: int) -> int:
    """Sigmoid-mapped phred+33 (src/abpoa_output.c:297-303)."""
    if n_cov > n_seq:
        raise ValueError(f"unexpected n_cov/n_seq ({n_cov}/{n_seq})")
    x = 13.8 * (1.25 * n_cov / n_seq - 0.25)
    p = 1 - 1.0 / (1.0 + math.pow(NAT_E, -x))
    return 33 + int(-10 * math.log10(p) + 0.499)


def heaviest_bundling(g: POAGraph, abpt: Params, abc: ConsensusResult) -> None:
    """Reverse-BFS argmax-out-edge consensus over read-count edge weights,
    one cluster (src/abpoa_output.c:478-548)."""
    n = g.node_n
    src, sink = C.SRC_NODE_ID, C.SINK_NODE_ID
    abc.n_cons = 1

    score = [0] * n
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
                out_w = node.out_w[i]
                if out_w > path_max_w or (out_w == path_max_w and score[out_id] > path_score):
                    max_id = out_id
                    path_score = score[out_id]
                    path_max_w = out_w
            max_out_id[cur] = max_id
            break
        else:
            max_w, max_id = -(1 << 31), -1
            for i, out_id in enumerate(node.out_ids):
                out_w = node.out_w[i]
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
        cov = g.nodes[cur].n_read
        covs.append(cov)
        phreds.append(phred_score(cov, abc.n_seq))
        cur = max_out_id[cur]
    abc.cons_node_ids = [ids]
    abc.cons_base = [bases]
    abc.cons_cov = [covs]
    abc.cons_phred = [phreds]


def generate_consensus(g: POAGraph, abpt: Params, n_seq: int) -> ConsensusResult:
    """Consensus entry point (src/abpoa_output.c:1184-1215), heaviest bundling only."""
    abc = ConsensusResult(n_seq=n_seq)
    if g.node_n <= 2:
        return abc
    heaviest_bundling(g, abpt, abc)
    g.is_called_cons = True
    return abc
