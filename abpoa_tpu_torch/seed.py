"""Minimizer seeding, guide tree, DP chaining and anchored (windowed) POA:
the seeded route of `-S` and `-p`.

Counterpart of `abpoa_tpu/seed.py` (abPOA src/abpoa_seed.c: mm_sketch
:97-168 from minimap2, guide tree :244-337, anchor merge-join :344-377, DP
chaining :500-591; the anchored POA loop src/abpoa_align.c:209-310),
copied function by function. Each read after the first is cut at the chained
minimizer anchors it shares with the read before it into windows, subgraph
alignments against the graph as the reads before it left it; the windows of
one read go to the device as one batched launch of kernel B2 and one of
its backtrack X1w (`align/dispatch.py` `align_windows`), the k-mer match
runs between them are pushed as matches, and the whole read is fused once,
into the native host graph (`native/`; the Python graph with `-G`) through
the surface it shares with `graph.POAGraph` (`add_subgraph_alignment`; the
windows' bands come back through `write_band`, unless `-b < 0`). With `-G`
the windows carry their path scores, and with `-b < 0` they run unbanded,
as `align_windows_jax` builds its snapshots. The windows keep the JAX
package's order, as they seed and write back the graph's mpl/mpr.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from . import constants as C
from .align import dispatch
from .cigar import push_cigar
from .params import Params

U64_MAX = (1 << 64) - 1
_MASK64 = U64_MAX


def _hash64(key: int, mask: int) -> int:
    key = (~key + (key << 21)) & mask
    key = (key ^ (key >> 24)) & mask
    key = (key + (key << 3) + (key << 8)) & mask
    key = (key ^ (key >> 14)) & mask
    key = (key + (key << 2) + (key << 4)) & mask
    key = (key ^ (key >> 28)) & mask
    key = (key + (key << 31)) & mask
    return key


def mm_sketch(seq: np.ndarray, w: int, k: int, rid: int, both_strand: bool,
              out: List[Tuple[int, int]], aa: bool = False) -> None:
    """(w,k)-minimizer sketch, minimap2 algorithm (abpoa_seed.c:97-236).

    out entries: (x, y) with x = hash<<8|span, y = rid<<32|lastPos<<1|strand.
    """
    length = len(seq)
    if length <= 0:
        return
    bits = 5 if aa else 2
    sigma = 26 if aa else 4
    shift1 = bits * (k - 1)
    mask = (1 << (bits * k)) - 1
    kmer = [0, 0]
    buf: List[Tuple[int, int]] = [(U64_MAX, U64_MAX)] * w
    mn = (U64_MAX, U64_MAX)
    min_pos = 0
    l = 0
    buf_pos = 0
    i = 0
    while i < length:
        c = int(seq[i])
        info = (U64_MAX, U64_MAX)
        if c < sigma:
            kmer_span = min(l + 1, k)
            if both_strand and not aa:
                kmer[0] = ((kmer[0] << 2) | c) & mask
                kmer[1] = (kmer[1] >> 2) | ((3 ^ c) << shift1)
                if kmer[0] == kmer[1]:
                    i += 1
                    continue
                z = 0 if kmer[0] < kmer[1] else 1
            else:
                kmer[0] = ((kmer[0] << bits) | c) & mask
                z = 0
            l += 1
            if l >= k and kmer_span < 256:
                info = (_hash64(kmer[z], mask) << 8 | kmer_span,
                        (rid << 32) | (i << 1) | z)
        else:
            l = 0
            kmer[0] = kmer[1] = 0
        buf[buf_pos] = info
        if l == w + k - 1 and mn[0] != U64_MAX:
            for j in range(buf_pos + 1, w):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
            for j in range(buf_pos):
                if mn[0] == buf[j][0] and buf[j][1] != mn[1]:
                    out.append(buf[j])
        if info[0] <= mn[0]:
            if l >= w + k and mn[0] != U64_MAX:
                out.append(mn)
            mn, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            if l >= w + k - 1 and mn[0] != U64_MAX:
                out.append(mn)
            mn = (U64_MAX, U64_MAX)
            for j in range(buf_pos + 1, w):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            for j in range(buf_pos + 1):
                if mn[0] >= buf[j][0]:
                    mn, min_pos = buf[j], j
            if l >= w + k - 1 and mn[0] != U64_MAX:
                for j in range(buf_pos + 1, w):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
                for j in range(buf_pos + 1):
                    if mn[0] == buf[j][0] and mn[1] != buf[j][1]:
                        out.append(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
        i += 1
    if mn[0] != U64_MAX:
        out.append(mn)


def collect_mm(seqs: List[np.ndarray], abpt: Params
               ) -> Tuple[List[Tuple[int, int]], List[int]]:
    mm: List[Tuple[int, int]] = []
    mm_c = [0]
    for rid, seq in enumerate(seqs):
        mm_sketch(seq, abpt.w, abpt.k, rid, bool(abpt.amb_strand) and abpt.m <= 5,
                  mm, aa=abpt.m > 5)
        mm_c.append(len(mm))
    return mm, mm_c


def build_guide_tree(abpt: Params, n_seq: int, mm: List[Tuple[int, int]]) -> List[int]:
    """Jaccard-similarity greedy ordering (abpoa_seed.c:244-337)."""
    tree = list(range(n_seq))
    if not mm:
        return tree
    mm_sorted = sorted(mm, key=lambda t: t[0])
    # per-pair min-count hit accumulation over identical-hash buckets
    hit = np.zeros((n_seq, n_seq), dtype=np.int64)  # [i>=j]
    self_cnt = np.zeros(n_seq, dtype=np.int64)
    i0 = 0
    n = len(mm_sorted)
    for i in range(1, n + 1):
        if i == n or mm_sorted[i][0] != mm_sorted[i0][0]:
            cnt: dict[int, int] = {}
            for j in range(i0, i):
                rid = mm_sorted[j][1] >> 32
                cnt[rid] = cnt.get(rid, 0) + 1
                self_cnt[rid] += 1
            rids = sorted(cnt)
            for a in range(len(rids)):
                for b in range(a + 1, len(rids)):
                    r1, r2 = rids[a], rids[b]
                    hit[r2, r1] += min(cnt[r1], cnt[r2])
            i0 = i
    jac = np.zeros((n_seq, n_seq), dtype=np.float64)
    max_jac, max_i, max_j = -1.0, -1, -1
    for i in range(1, n_seq):
        for j in range(i):
            tot = self_cnt[i] + self_cnt[j] - hit[i, j]
            v = 0.0 if tot == 0 else float(hit[i, j]) / tot
            jac[i, j] = jac[j, i] = v
            if v > max_jac:
                max_jac, max_i, max_j = v, i, j
    order = [max_j, max_i]
    in_map = set(order)
    while len(order) < n_seq:
        best_jac, best = -1.0, n_seq
        for rid in range(n_seq):
            if rid in in_map:
                continue
            v = float(sum(jac[rid, r2] for r2 in order))
            if v > best_jac:
                best_jac, best = v, rid
        order.append(best)
        in_map.add(best)
    return order


def collect_anchors(mm: List[Tuple[int, int]], mm_c: List[int], tid: int, qid: int,
                    qlen: int, k: int, t_sorted: List[Tuple[int, int]],
                    q_cache: dict) -> List[int]:
    """Merge-join of sorted minimizer buckets (abpoa_seed.c:344-377).

    anchors: strand<<63 | t_lastPos<<32 | q_lastPos (sorted ascending).
    """
    if qid in q_cache:
        q_sorted = q_cache[qid]
    else:
        q_sorted = sorted(mm[mm_c[qid]: mm_c[qid + 1]], key=lambda t: t[0])
        q_cache.clear()
        q_cache[qid] = q_sorted
    anchors: List[int] = []
    i = j = 0
    nt, nq = len(t_sorted), len(q_sorted)
    while i < nt and j < nq:
        xi, xj = t_sorted[i][0], q_sorted[j][0]
        if xi == xj:
            _i = i
            while _i < nt and t_sorted[_i][0] == xi:
                yi = t_sorted[_i][1]
                _j = j
                while _j < nq and q_sorted[_j][0] == xj:
                    yj = q_sorted[_j][1]
                    if (yi & 1) == (yj & 1):
                        a = ((yi & 0xFFFFFFFF) >> 1) << 32 | ((yj & 0xFFFFFFFF) >> 1)
                    else:
                        a = (1 << 63) | ((yi & 0xFFFFFFFF) >> 1) << 32 \
                            | (qlen - (((yj & 0xFFFFFFFF) >> 1) + 1 - k) - 1)
                    anchors.append(a)
                    _j += 1
                _i += 1
            i, j = _i, _j
        elif xi < xj:
            i += 1
        else:
            j += 1
    anchors.sort()
    return anchors


def _ilog2_32(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else -1


def _get_chain_score(max_bw: int, i_qpos: int, i_tpos: int, j_qpos: int,
                     j_tpos: int, k: int) -> Optional[int]:
    delta_q = i_qpos - j_qpos
    delta_t = i_tpos - j_tpos
    score = min(delta_q, delta_t, k)
    delta_tq = abs(delta_q - delta_t)
    if delta_tq > max_bw:
        return None
    # C semantics: `score -= (double)` truncates the RESULT toward zero
    return int(score - ((_ilog2_32(delta_tq) >> 1) + delta_tq * 0.01 * k))


def _get_local_chain_score(j_end_tpos, j_end_qpos, i_end, anchors, pre_id, score):
    i = i_end
    while i != -1:
        i_tpos = (anchors[i] >> 32) & 0x7FFFFFFF
        i_qpos = anchors[i] & 0xFFFFFFFF
        if i_tpos <= j_end_tpos and i_qpos <= j_end_qpos:
            break
        i = pre_id[i]
    if i == -1:
        return score[i_end]
    return score[i_end] - score[i]


def dp_chaining(anchors: List[int], abpt: Params, tlen: int, qlen: int,
                par_anchors: List[int]) -> None:
    """minimap2-style DP chaining + second-level chaining (abpoa_seed.c:500-591)."""
    n_a = len(anchors)
    if n_a == 0:
        return
    max_bw, max_dis = 100, 100
    max_skip_anchors, max_non_best_anchors = 25, 50
    min_local_chain_score = 100
    min_w = abpt.min_w + abpt.k
    k = abpt.k
    score = [0] * n_a
    pre_id = [0] * n_a
    end_pos = [0] * n_a
    st = 0
    for i in range(n_a):
        ia = anchors[i]
        i_qpos = ia & 0xFFFFFFFF
        i_tpos = (ia >> 32) & 0x7FFFFFFF
        i_strand = ia >> 63
        max_j, n_skip, non_best, max_score = -1, 0, 0, k
        while st < i:
            sa = anchors[st]
            if (sa >> 63) != i_strand or ((sa >> 32) & 0x7FFFFFFF) + max_dis < i_tpos:
                st += 1
            else:
                break
        for j in range(i - 1, st - 1, -1):
            ja = anchors[j]
            j_qpos = ja & 0xFFFFFFFF
            j_tpos = (ja >> 32) & 0x7FFFFFFF
            if j_qpos >= i_qpos or j_qpos + max_dis < i_qpos:
                continue
            s = _get_chain_score(max_bw, i_qpos, i_tpos, j_qpos, j_tpos, k)
            if s is None:
                continue
            s += score[j]
            if s > max_score:
                max_score, max_j = s, j
                non_best = 0
                if n_skip > 0:
                    n_skip -= 1
            elif end_pos[j] == i:
                n_skip += 1
                if n_skip > max_skip_anchors:
                    break
            else:
                non_best += 1
                if non_best > max_non_best_anchors:
                    break
            if pre_id[j] >= 0:
                end_pos[pre_id[j]] = i
        score[i] = max_score
        pre_id[i] = max_j

    end_pos = [0] * n_a
    for i in range(n_a - 1, -1, -1):
        if pre_id[i] >= 0:
            end_pos[pre_id[i]] = 1
        if end_pos[i] == 0 and score[i] >= min_local_chain_score:
            end_pos[i] = 2
    # local chains sorted by score
    chains = sorted((score[i], i) for i in range(n_a) if end_pos[i] == 2)
    n_local = len(chains)
    anchor_map = [0] * n_a
    # walk back each chain (best first), claim anchors; keep unbranched chains
    out_chains: List[Tuple[int, int]] = []  # (x, y) like local_chains
    for idx in range(n_local - 1, -1, -1):
        j = chains[idx][1]
        end_id = j
        # NOTE: reference reads the strand from anchors[idx] (loop variable i),
        # not from the chain end anchor — replicated verbatim
        strand = anchors[idx] >> 63
        tpos = (anchors[j] >> 32) & 0x7FFFFFFF
        qpos = anchors[j] & 0xFFFFFFFF
        while True:
            start_id = j
            anchor_map[j] = 1
            j = pre_id[j]
            if not (j >= 0 and anchor_map[j] == 0):
                break
        if j < 0:
            out_chains.append((strand << 63 | tpos << 32 | qpos,
                               end_id << 32 | start_id))
    out_chains.sort(key=lambda t: t[0])
    _chain_of_local_chains(out_chains, anchors, score, pre_id, par_anchors,
                           min_w, tlen, qlen)


def _chain_of_local_chains(local_chains, anchors, score, pre_id, par_anchors,
                           min_w, tlen, qlen) -> None:
    """(abpoa_seed.c:398-479)"""
    n = len(local_chains)
    if n == 0:
        return
    chain_score = [0] * n
    pre_chain_id = [0] * n
    global_max_score, global_max_i = -(1 << 31), -1
    st = 0
    for i in range(n):
        ix, iy = local_chains[i]
        istrand = ix >> 63
        i_end_qpos = ix & 0xFFFFFFFF
        i_end_anchor = iy >> 32
        i_start_anchor = iy & 0xFFFFFFFF
        i_start_tpos = (anchors[i_start_anchor] >> 32) & 0x7FFFFFFF
        i_start_qpos = anchors[i_start_anchor] & 0xFFFFFFFF
        max_j, max_score = -1, score[i_end_anchor]
        while st < i:
            if (local_chains[st][0] >> 63) != istrand:
                st += 1
            else:
                break
        for j in range(i - 1, st - 1, -1):
            jx = local_chains[j][0]
            j_end_tpos = (jx >> 32) & 0x7FFFFFFF
            j_end_qpos = jx & 0xFFFFFFFF
            if j_end_qpos >= i_end_qpos:
                continue
            if i_start_tpos > j_end_tpos and i_start_qpos > j_end_qpos:
                s1 = chain_score[j] + score[i_end_anchor]
            else:
                s1 = chain_score[j] + _get_local_chain_score(
                    j_end_tpos, j_end_qpos, i_end_anchor, anchors, pre_id, score)
            if s1 > max_score:
                max_score, max_j = s1, j
        chain_score[i] = max_score
        pre_chain_id[i] = max_j
        if max_score > global_max_score:
            global_max_score, global_max_i = max_score, i
    if global_max_i < 0:
        return
    start_n = len(par_anchors)
    cur_i = global_max_i
    pre_i = pre_chain_id[cur_i]
    cur_y = local_chains[cur_i][1]
    last_tpos, last_qpos = tlen, qlen
    while pre_i != -1:
        pre_x, pre_y = local_chains[pre_i]
        pre_end_tpos = (pre_x >> 32) & 0x7FFFFFFF
        pre_end_qpos = pre_x & 0xFFFFFFFF
        i = cur_y >> 32
        while i != -1:
            cur_tpos = (anchors[i] >> 32) & 0x7FFFFFFF
            cur_qpos = anchors[i] & 0xFFFFFFFF
            if cur_tpos > pre_end_tpos and cur_qpos > pre_end_qpos:
                if last_tpos - cur_tpos >= min_w and last_qpos - cur_qpos >= min_w:
                    par_anchors.append(anchors[i])
                    last_tpos, last_qpos = cur_tpos, cur_qpos
            else:
                break
            i = pre_id[i]
        cur_i, pre_i, cur_y = pre_i, pre_chain_id[pre_i], pre_y
    i = cur_y >> 32
    while i != -1:
        cur_tpos = (anchors[i] >> 32) & 0x7FFFFFFF
        cur_qpos = anchors[i] & 0xFFFFFFFF
        if last_tpos - cur_tpos >= min_w and last_qpos - cur_qpos >= min_w:
            par_anchors.append(anchors[i])
            last_tpos, last_qpos = cur_tpos, cur_qpos
        i = pre_id[i]
    # collected back-to-front: reverse into ascending order
    par_anchors[start_n:] = par_anchors[start_n:][::-1]


def build_guide_tree_partition(seqs: List[np.ndarray], abpt: Params
                               ) -> Tuple[List[int], List[int], List[int]]:
    """(abpoa_seed.c:717-756). Returns (read_id_map, par_anchors, par_c).
    Timed as the run report's `seeding` and `guide_tree` phases."""
    from .obs import phase
    n_seq = len(seqs)
    read_id_map = list(range(n_seq))
    with phase("seeding"):
        mm, mm_c = collect_mm(seqs, abpt)
    if abpt.progressive_poa and n_seq > 2:
        with phase("guide_tree"):
            read_id_map = build_guide_tree(abpt, n_seq, mm)
    par_anchors: List[int] = []
    par_c = [0] * n_seq
    if abpt.disable_seeding or n_seq < 2:
        return read_id_map, par_anchors, par_c
    with phase("seeding"):
        q_cache: dict = {}
        t_sorted = sorted(mm[mm_c[read_id_map[0]]: mm_c[read_id_map[0] + 1]],
                          key=lambda t: t[0])
        for i in range(1, n_seq):
            tid, qid = read_id_map[i - 1], read_id_map[i]
            if i > 1:
                t_sorted = q_cache.get(tid) or sorted(
                    mm[mm_c[tid]: mm_c[tid + 1]], key=lambda t: t[0])
            anchors = collect_anchors(mm, mm_c, tid, qid, len(seqs[qid]),
                                      abpt.k, t_sorted, q_cache)
            dp_chaining(anchors, abpt, len(seqs[tid]), len(seqs[qid]),
                        par_anchors)
            par_c[i] = len(par_anchors)
    return read_id_map, par_anchors, par_c


def window_specs(g, par_anchors: List[int], ai: int, ai_end: int, k: int,
                 tpos_to_node_id: np.ndarray, qlen: int):
    """One read's windows from its anchors par_anchors[ai:ai_end]:
    ([(beg_id, end_id, beg_qpos, end_qpos)], the k-mer match run of node ids
    after each window but the last). The last window runs to the sink only
    when the graph has nodes (src/abpoa_align.c:268-290)."""
    specs = []
    kmer_runs = []
    beg_id, beg_qpos = C.SRC_NODE_ID, 0
    while ai < ai_end:
        a = par_anchors[ai]
        end_tpos = ((a >> 32) & 0x7FFFFFFF) - k + 1
        end_id = int(tpos_to_node_id[end_tpos])
        end_qpos = (a & 0xFFFFFFFF) - k + 1
        specs.append((beg_id, end_id, beg_qpos, end_qpos))
        kmer_runs.append([int(tpos_to_node_id[end_tpos + j])
                          for j in range(k)])
        beg_id = int(tpos_to_node_id[end_tpos + k - 1])
        beg_qpos = end_qpos + k
        ai += 1
    if g.node_n > 2:
        specs.append((beg_id, C.SINK_NODE_ID, beg_qpos, qlen))
    return specs, kmer_runs


def anchor_poa(ab, abpt: Params, seqs: List[np.ndarray], weights: List[np.ndarray],
               par_anchors: List[int], par_c: List[int], read_id_map: List[int],
               exist_n_seq: int) -> None:
    """Anchored windowed POA (src/abpoa_align.c:209-310): the reads in
    `read_id_map` order, each read's windows aligned in one batch against
    the graph the reads before it built, then the read fused whole."""
    from . import obs
    from .pipeline import _band_cols, _rc_encode
    g = ab.graph
    n_seq = len(seqs)
    k = abpt.k
    max_len = max((len(s) for s in seqs), default=0)
    tpos_to_node_id = np.zeros(max_len, dtype=np.int64)
    qpos_to_node_id = np.zeros(max_len, dtype=np.int64)
    last_read_id = -1
    for _i in range(n_seq):
        i = read_id_map[_i]
        read_id = exist_n_seq + i
        qlen = len(seqs[i])
        t_read = time.perf_counter()
        whole_cigar: List[int] = []
        ai = 0 if _i == 0 else par_c[_i - 1]
        if ai < par_c[_i]:
            # the strand comes from the anchors (no score retry)
            ab.is_rc[read_id] = bool(ab.is_rc[last_read_id]) ^ bool(par_anchors[ai] >> 63)
            if ab.is_rc[read_id]:
                qseq = _rc_encode(seqs[i])
                weight = weights[i][::-1].copy()
            else:
                qseq, weight = seqs[i], weights[i]
            if ab.is_rc[last_read_id]:  # remap anchors into last read's rc coords
                last_qlen = len(seqs[read_id_map[_i - 1]])
                for j in range(ai, par_c[_i]):
                    a = par_anchors[j]
                    end_tpos = (a >> 32) & 0x7FFFFFFF
                    end_qpos = a & 0xFFFFFFFF
                    par_anchors[j] = (a >> 63) << 63 \
                        | (last_qlen - end_tpos + k) << 32 | (qlen - end_qpos + k)
                par_anchors[ai: par_c[_i]] = par_anchors[ai: par_c[_i]][::-1]
        else:
            ab.is_rc[read_id] = False
            qseq, weight = seqs[i], weights[i]

        # the windows are fixed by the previous read's graph (anchors and
        # its position -> node map), so they are independent alignments
        # against the graph as it stands: one batch
        specs, kmer_runs = window_specs(g, par_anchors, ai, par_c[_i], k,
                                        tpos_to_node_id, qlen)
        for _b, _e, lo, hi in specs:
            # a window's row count is not known on the host: the model is
            # its query span, as in abpoa_tpu/seed.py:570
            obs.record_dp((hi - lo) + 2, _band_cols(abpt, hi - lo),
                          abpt.gap_mode)
        with obs.phase("align"):
            results = dispatch.align_windows(
                g, abpt, [(b, e, qseq[lo:hi]) for b, e, lo, hi in specs])
        for wi, res in enumerate(results):
            whole_cigar.extend(res.cigar)
            if wi < len(kmer_runs):
                for j, nid in enumerate(kmer_runs[wi]):
                    push_cigar(whole_cigar, C.CMATCH, 1, nid, j)
        with obs.phase("fusion"):
            g.add_subgraph_alignment(abpt, C.SRC_NODE_ID, C.SINK_NODE_ID,
                                     qseq, weight, whole_cigar, True,
                                     read_id, qpos_to_node_id)
        dt = time.perf_counter() - t_read
        obs.record_read(dt, qlen, _band_cols(abpt, qlen), abpt.device)
        obs.trace.add_span(f"read:{read_id}", "read", t_read, dt,
                           args={"qlen": qlen, "windows": len(specs)})
        tpos_to_node_id, qpos_to_node_id = qpos_to_node_id, tpos_to_node_id
        last_read_id = read_id


def anchor_poa_pipeline(ab, abpt: Params, seqs: List[np.ndarray],
                        weights: List[np.ndarray], exist_n_seq: int) -> None:
    """The seeded route of `pipeline.msa` (abpoa_tpu/seed.py:598)."""
    read_id_map, par_anchors, par_c = build_guide_tree_partition(seqs, abpt)
    anchor_poa(ab, abpt, seqs, weights, par_anchors, par_c, read_id_map,
               exist_n_seq)
