"""Row-column MSA read out of the POA graph (abPOA src/abpoa_output.c:
abpoa_set_msa_seq / abpoa_collect_msa / abpoa_generate_rc_msa, :106-193)."""
from __future__ import annotations

from typing import List

import numpy as np

from .. import constants as C
from ..graph import POAGraph
from ..params import Params
from .consensus import ConsensusResult, generate_consensus


def _scatter_node(g: POAGraph, node_id: int, rank: int, msa: List[np.ndarray]) -> None:
    """Write the node's base into msa[read][rank-1] for every read on one of
    its out edges."""
    node = g.nodes[node_id]
    base = node.base
    for bits in node.read_ids:
        while bits:
            lsb = bits & -bits
            msa[lsb.bit_length() - 1][rank - 1] = base
            bits ^= lsb


def collect_msa(g: POAGraph, abpt: Params, n_seq: int) -> tuple[int, List[np.ndarray]]:
    """(msa_len, one uint8 row per read) with the gap encoded as abpt.m
    (src/abpoa_output.c:125-147)."""
    if g.node_n <= 2:
        return 0, []
    g.set_msa_rank()
    msa_len = int(g.node_id_to_msa_rank[C.SINK_NODE_ID]) - 1
    msa = [np.full(msa_len, abpt.m, dtype=np.uint8) for _ in range(n_seq)]
    for i in range(2, g.node_n):
        _scatter_node(g, i, g.msa_rank_of(i), msa)
    return msa_len, msa


def generate_rc_msa(g: POAGraph, abpt: Params, n_seq: int) -> ConsensusResult:
    """The MSA rows and, with consensus output, the consensus rows after them
    (src/abpoa_output.c:150-193)."""
    if g.node_n <= 2:
        return ConsensusResult(n_seq=n_seq)
    g.set_msa_rank()
    if abpt.out_cons:
        abc = generate_consensus(g, abpt, n_seq)
    else:
        abc = ConsensusResult(n_seq=n_seq)
    abc.msa_len, abc.msa_base = collect_msa(g, abpt, n_seq)
    if abpt.out_cons:
        for cons_i in range(abc.n_cons):
            row = np.full(abc.msa_len, abpt.m, dtype=np.uint8)
            for i, cur_id in enumerate(abc.cons_node_ids[cons_i]):
                row[g.msa_rank_of(cur_id) - 1] = abc.cons_base[cons_i][i]
            abc.msa_base.append(row)
    return abc
