"""Multi-allele read clustering via k-medoids over heterozygous MSA columns.

abPOA src/abpoa_output.c:650-1181. The pipeline:
candidate het columns from the MSA (>=2 alleles within frequency bounds,
deduplicated by identical read partition, priority-sorted by support) ->
het-weighted read-by-read distance matrix -> medoid init from het partitions ->
<=10 k-medoids iterations, with a cluster-count fallback loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..graph import POAGraph
from ..params import Params
from .msa import collect_msa

INT_MAX = 2**31 - 1


@dataclass
class CandHetPos:
    pos: int = 0
    depth: int = 0
    var_type: int = 0  # 0: SNP, 1: indel
    count: int = 0
    n_uniq_alles: int = 0
    alle_bases: List[int] = field(default_factory=list)
    n_clu_reads: List[int] = field(default_factory=list)          # indexed by allele value
    clu_read_ids: List[List[int]] = field(default_factory=list)   # indexed by allele value
    read_id_to_allele_idx: List[int] = field(default_factory=list)


def collect_cand_het_pos(msa: List[np.ndarray], msa_l: int, n_seq: int, m: int,
                         min_het: int) -> Tuple[List[CandHetPos], List[int]]:
    """(src/abpoa_output.c:677-822)"""
    cand: List[CandHetPos] = []
    min_het = max(2, min_het // 2)
    min_hom = n_seq - min_het
    for i in range(msa_l):
        depth = [0] * (m + 1)
        appearance = [0] * (m + 1)
        for j in range(n_seq):
            b = int(msa[j][i])
            depth[b] += 1
            if depth[b] == 1:
                appearance[b] = j
        alleles = []
        total_depth = 0
        var_type = 0
        for j in range(m + 1):
            if min_het <= depth[j] <= min_hom:
                alleles.append(j)
                total_depth += depth[j]
                if j == m:
                    var_type = 1
        if len(alleles) < 2:
            continue
        alleles.sort(key=lambda a: appearance[a])
        allele_to_idx = {a: k for k, a in enumerate(alleles)}
        n_clu_reads = [0] * (m + 1)
        clu_read_ids: List[List[int]] = [[] for _ in range(m + 1)]
        for j in range(n_seq):
            b = int(msa[j][i])
            if b in allele_to_idx:
                clu_read_ids[b].append(j)
                n_clu_reads[b] += 1
        # dedup: same partition seen before? (searched newest-first)
        het_i = -1
        for k in range(len(cand) - 1, -1, -1):
            c = cand[k]
            if c.n_uniq_alles != len(alleles):
                continue
            same = True
            for x, y in zip(c.alle_bases, alleles):
                if c.n_clu_reads[x] != n_clu_reads[y] or c.clu_read_ids[x] != clu_read_ids[y]:
                    same = False
                    break
            if same:
                het_i = k
                break
        if het_i >= 0:
            cand[het_i].count += 1
            if var_type == 0:
                cand[het_i].var_type = 0
            continue
        c = CandHetPos(pos=i, depth=total_depth, var_type=var_type, count=1,
                       n_uniq_alles=len(alleles), alle_bases=list(alleles),
                       n_clu_reads=n_clu_reads, clu_read_ids=clu_read_ids,
                       read_id_to_allele_idx=[-1] * n_seq)
        for j in range(m + 1):
            for rid in clu_read_ids[j]:
                c.read_id_to_allele_idx[rid] = allele_to_idx[j]
        cand.append(c)
    # bubble sort priority by (count desc, depth desc, var_type: SNP first)
    prio = list(range(len(cand)))
    swapped = True
    while swapped:
        swapped = False
        for j in range(len(cand) - 1):
            a, b = cand[prio[j]], cand[prio[j + 1]]
            if (a.count < b.count
                    or (a.count == b.count and a.depth < b.depth)
                    or (a.count == b.count and a.depth == b.depth and a.var_type > b.var_type)):
                prio[j], prio[j + 1] = prio[j + 1], prio[j]
                swapped = True
    return cand, prio


def collect_dis_matrix(msa: List[np.ndarray], n_seq: int,
                       cand: List[CandHetPos]) -> np.ndarray:
    """Het-weighted pairwise distances (src/abpoa_output.c:824-863)."""
    dis = np.zeros((n_seq, n_seq), dtype=np.int64)
    for c in cand:
        pos = c.pos
        var_weight = 2 if c.var_type == 0 else 1
        col = np.array([int(msa[j][pos]) for j in range(n_seq)])
        valid = np.isin(col, c.alle_bases)
        for i in range(n_seq):
            if not valid[i]:
                continue
            diff = valid & (col != col[i])
            dis[i, diff] += var_weight * c.count
    return dis


def _partition_index(cand: List[CandHetPos], het_i: int, read_i: int) -> int:
    idx = 0
    for k in range(het_i + 1):
        idx = idx * (cand[k].n_uniq_alles + 1) + cand[k].read_id_to_allele_idx[read_i] + 1
    return idx


def _collect_2medoids(cand: List[CandHetPos], het_i: int, dis: np.ndarray,
                      med: List[int]) -> int:
    c = cand[het_i]
    max_dis, max_i, max_j = 0, -1, -1
    for i in range(c.n_uniq_alles - 1):
        ai = c.alle_bases[i]
        for j in range(i + 1, c.n_uniq_alles):
            aj = c.alle_bases[j]
            for r1 in c.clu_read_ids[ai]:
                for r2 in c.clu_read_ids[aj]:
                    if dis[r1, r2] > max_dis:
                        max_dis, max_i, max_j = int(dis[r1, r2]), r1, r2
    if max_dis > 0:
        med[0], med[1] = max_i, max_j
        return 2
    return 0


def _collect_1medoid(cand: List[CandHetPos], het_i: int, dis: np.ndarray,
                     n_seq: int, med: List[int], n_medoids: int) -> int:
    """(src/abpoa_output.c:904-971)"""
    assert n_medoids > 0
    partition_counts: dict[int, int] = {}
    for i in range(n_seq):
        pi = _partition_index(cand, het_i, i)
        partition_counts[pi] = partition_counts.get(pi, 0) + 1
    max_dis, max_read_i, max_count = 0, -1, -1
    med_partitions = [_partition_index(cand, het_i, med[j]) for j in range(n_medoids)]
    for i in range(n_seq):
        pi = _partition_index(cand, het_i, i)
        if pi in med_partitions:
            continue
        min_dis = min(int(dis[i, med[j]]) for j in range(n_medoids))
        cnt = partition_counts[pi]
        if cnt > max_count or (cnt == max_count and min_dis > max_dis):
            max_dis, max_read_i, max_count = min_dis, i, cnt
    if max_read_i == -1:
        c = cand[het_i]
        for i in range(c.n_uniq_alles):
            allele = c.alle_bases[i]
            for read_i in c.clu_read_ids[allele]:
                min_dis = INT_MAX
                skip = False
                for j in range(n_medoids):
                    if med[j] == read_i:
                        skip = True
                        continue
                    if int(dis[read_i, med[j]]) < min_dis:
                        min_dis = int(dis[read_i, med[j]])
                if min_dis > max_dis and not skip:
                    max_dis, max_read_i = min_dis, read_i
    if max_read_i != -1:
        if len(med) <= n_medoids:
            med.extend([-1] * (n_medoids + 1 - len(med)))
        med[n_medoids] = max_read_i
        return 1
    return 0


def _collect_multi_medoids(cand: List[CandHetPos], het_i: int, dis: np.ndarray,
                           n_seq: int, max_n_cons: int, med: List[int],
                           n_medoids: int) -> int:
    n_to_collect = min(cand[het_i].n_uniq_alles, max_n_cons)
    while n_medoids < n_to_collect:
        if n_medoids == 0:
            new = _collect_2medoids(cand, het_i, dis, med)
        else:
            new = _collect_1medoid(cand, het_i, dis, n_seq, med, n_medoids)
        if new == 0:
            break
        n_medoids += new
    return n_medoids


def _init_kmedoids(cand: List[CandHetPos], prio: List[int], dis: np.ndarray,
                   n_seq: int, max_n_cons: int, med: List[int]) -> int:
    assert max_n_cons >= 2
    n_medoids, het_i = 0, 0
    while n_medoids < max_n_cons:
        if n_medoids == 0:
            n_medoids = _collect_multi_medoids(cand, prio[het_i], dis, n_seq,
                                               max_n_cons, med, n_medoids)
        else:
            n_medoids += _collect_1medoid(cand, prio[het_i], dis, n_seq, med, n_medoids)
        het_i += 1
        if het_i >= len(prio):
            break
    return n_medoids


def _collect_kmedoids0(dis: np.ndarray, max_n_cons: int, clu_reads: List[List[int]],
                       medoids: List[int]) -> None:
    for i in range(max_n_cons):
        min_sum, min_read = INT_MAX, -1
        for j, read_i in enumerate(clu_reads[i]):
            s = sum(int(dis[read_i, r]) for k, r in enumerate(clu_reads[i]) if k != j)
            if s < min_sum:
                min_sum, min_read = s, read_i
        if min_read != -1:
            medoids[i] = min_read
    medoids.sort()


def _update_kmedoids(dis: np.ndarray, n_seq: int, max_n_cons: int,
                     medoids: List[int], clu_reads: List[List[int]],
                     n_clu_seqs: List[int]) -> Tuple[bool, List[int]]:
    new_medoids = [-1] * max_n_cons
    for i in range(max_n_cons):
        n_clu_seqs[i] = 0
        clu_reads[i].clear()
    for i in range(n_seq):
        min_dis, min_clu, tied = INT_MAX, -1, False
        for j in range(max_n_cons):
            d = int(dis[i, medoids[j]])
            if d < min_dis:
                min_dis, min_clu, tied = d, j, False
            elif d == min_dis:
                tied = True
        if min_clu == -1:
            continue
        if tied:
            # reference resolves ties by balancing the first two clusters
            min_clu = 0 if n_clu_seqs[0] < n_clu_seqs[1] else 1
        clu_reads[min_clu].append(i)
        n_clu_seqs[min_clu] += 1
    _collect_kmedoids0(dis, max_n_cons, clu_reads, new_medoids)
    changed = False
    for i in range(max_n_cons):
        if new_medoids[i] == -1:
            changed = False
            break
        if new_medoids[i] != medoids[i]:
            changed = True
    return changed, new_medoids


def clu_reads_kmedoids(cand: List[CandHetPos], prio: List[int], dis: np.ndarray,
                       n_seq: int, min_het: int, max_n_cons: int
                       ) -> Tuple[int, Optional[List[int]]]:
    """(src/abpoa_output.c:1089-1134). Returns (n_clusters, clu bitsets)."""
    to_collect, n_clusters = max_n_cons, 1
    clu_reads: List[List[int]] = [[] for _ in range(max_n_cons)]
    n_clu_seqs = [0] * max_n_cons
    while True:
        medoids = [-1] * to_collect
        if _init_kmedoids(cand, prio, dis, n_seq, to_collect, medoids) <= 0:
            break
        it = 0
        while True:
            changed, medoids = _update_kmedoids(dis, n_seq, to_collect, medoids,
                                                clu_reads, n_clu_seqs)
            it += 1
            if not changed or it >= 10:
                break
        n_clu = sum(1 for i in range(to_collect) if n_clu_seqs[i] >= min_het)
        n_clustered = sum(n_clu_seqs[:to_collect])
        if n_clu != to_collect or n_clustered < math.ceil(n_seq * 0.8):
            to_collect -= 1
            if to_collect < 2:
                break
        else:
            n_clusters = n_clu
            break
    if n_clusters == 1:
        return 1, None
    bits_list = []
    for i in range(n_clusters):
        bits = 0
        for rid in clu_reads[i]:
            bits |= 1 << rid
        bits_list.append(bits)
    return n_clusters, bits_list


def multip_read_clu_kmedoids(g: POAGraph, abpt: Params, n_seq: int
                             ) -> Tuple[int, Optional[List[int]]]:
    """Driver (src/abpoa_output.c:1136-1181)."""
    g.set_msa_rank()
    msa_l, msa = collect_msa(g, abpt, n_seq)
    min_w = max(2, math.ceil(n_seq * abpt.min_freq))
    cand, prio = collect_cand_het_pos(msa, msa_l, n_seq, abpt.m, min_w)
    if len(cand) < 1:
        return 1, None
    dis = collect_dis_matrix(msa, n_seq, cand)
    return clu_reads_kmedoids(cand, prio, dis, n_seq, min_w, abpt.max_n_cons)
