"""Split lockstep: K read sets advance one read a round, with one K-lane
launch of kernel B2 (and one of X1w) a round and each set's fusion on its
own host graph.

Counterpart of `abpoa_tpu/parallel/lockstep.py` (`ChurnHook` :43, `_Lane`
:65, `progressive_poa_split_batch` :89, its `mesh=` :107). With a mesh
(`parallel/shard.py`), each round's live lanes go in one sharded dispatch:
one B2 launch (and one X1w launch) a slot over its slice of the lanes.
Per lane a round is exactly
`pipeline.poa`'s step for one read: the alignment of the read to the lane's
graph (`dp_chunk.run_dp_chunk`, all lanes in one launch), with `-s` the
reverse complement of a read under the host float threshold
`min(qlen, node_n - 2) * max_mat * 0.3333` in a second K-lane launch of the
lanes under it, then the fusion. The band write-backs of a lane come in
`poa`'s order: forward, the reverse complement, then the fusion (which
sorts the graph). So each set's output is its per-read route's, byte for
byte, for any K and any join or retire schedule. The lane graphs are the
native host graph unless `pipeline.want_native` keeps the Python graph
(Z-drop, which `-l` and `msa_batch` leave to the set-by-set route:
`runner._lockstep_ok`).

Lanes retire the round they fuse their last read, and a `ChurnHook` may
evict lanes and board joiners at round boundaries. A joiner whose longest
read is off the group's `qp_rung` is refused, as in the JAX driver. A
failed X1w walk raises (`banded._result`): the JAX driver's
`split_bt_fallback` has no twin, since X1w is held to the host walk.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..obs.tally import Tally
from ..params import Params


def _zero_stats() -> dict:
    return {"groups": 0, "rounds": 0, "live_lanes": 0, "dp_lanes": 0,
            "rc_lanes": 0, "fusion_s": 0.0}


# over the life of the process: groups, rounds, live lanes summed over the
# rounds, lanes aligned (forward and reverse complement) and the seconds of
# the fusions (C++ or Python, the sort included)
stats = Tally(_zero_stats)


def reset_stats() -> None:
    stats.reset()


class ChurnHook:
    """Round-boundary lane churn of `progressive_poa_split_batch`.

    ``on_round(round_i, live_sids)`` is called before each round (round_i
    counts from 1) and returns ``(evict_sids, joiners)``: lanes to drop
    without a result and new sets to board as ``(sid, seqs, weights)``.
    A joiner off the group's query rung is refused through
    ``on_retire(sid, None, round_i)``.

    ``on_retire(sid, result, round_i)`` delivers a lane's result,
    ``(host_graph, is_rc_flags)``, the round it finishes.
    """

    def on_round(self, round_i: int, live_sids: list) -> tuple:
        return set(), []

    def on_retire(self, sid, result, round_i: int) -> None:  # pragma: no cover
        pass


class _Lane:
    __slots__ = ("sid", "seqs", "weights", "graph", "is_rc", "cursor",
                 "n_reads")

    def __init__(self, sid, seqs, weights, graph):
        self.sid = sid
        self.seqs = seqs
        self.weights = weights
        self.graph = graph
        self.is_rc = [False] * len(seqs)
        self.cursor = 0
        self.n_reads = len(seqs)


def _new_graph(abpt: Params):
    from ..pipeline import want_native
    if want_native(abpt):
        from ..native.graph import NativePOAGraph
        return NativePOAGraph()
    from ..graph import POAGraph
    return POAGraph()


def progressive_poa_split_batch(seq_sets: List[List[np.ndarray]],
                                weight_sets: List[List[np.ndarray]],
                                abpt: Params,
                                churn: Optional[ChurnHook] = None,
                                mesh=None) -> list:
    """Run K independent read sets in split lockstep. Returns one
    `(host_graph, is_rc_flags)` per initial set (None for a set a churn
    hook evicted). With `churn`, every lane's result (joiners' too) also
    goes to `churn.on_retire` the round the lane finishes. `mesh` splits
    each round's lanes over its slots (the host fusion is unchanged)."""
    from .. import obs
    from ..align.buckets import qp_rung
    from ..align.dp_chunk import run_dp_chunk
    from ..pipeline import _band_cols, _rc_encode
    from . import scheduler
    from .shard import mesh_size

    S = mesh_size(mesh)
    occ_route = "sharded" if S > 1 else "lockstep"
    K = len(seq_sets)
    qmax = max((len(s) for ss in seq_sets for s in ss), default=1)
    Qp = qp_rung(qmax)
    stats.add("groups", 1)
    obs.observe("lockstep.k", K)

    # the lane table, in boarding order (the launch's lane order)
    lanes: dict = {}
    seen_sids = set()
    final: dict = {}
    for sid in range(K):
        lanes[sid] = _Lane(sid, seq_sets[sid], weight_sets[sid],
                           _new_graph(abpt))
        seen_sids.add(sid)
    # the high-water mark of live lanes: occupancy = live / capacity
    capacity = max(len(lanes), 1)

    def retire(lane: _Lane, result, round_i: int) -> None:
        lanes.pop(lane.sid, None)
        if isinstance(lane.sid, int) and 0 <= lane.sid < K:
            final[lane.sid] = result
        if churn is not None:
            if lanes:
                obs.count("lockstep.early_retires")
            churn.on_retire(lane.sid, result, round_i)

    def fuse(lane: _Lane, cigar: list, q: np.ndarray, w: np.ndarray) -> None:
        t0 = time.perf_counter()
        lane.graph.add_alignment(abpt, q, w, cigar, True, lane.cursor)
        stats.add("fusion_s", time.perf_counter() - t0)
        lane.cursor += 1

    round_i = 0
    while True:
        if churn is not None:
            evict, joiners = churn.on_round(round_i + 1, list(lanes))
            for sid in evict or ():
                if lanes.pop(sid, None) is not None:
                    obs.count("lockstep.evictions")
            for sid, j_seqs, j_wgts in joiners or ():
                if sid in seen_sids:
                    raise ValueError(
                        f"split lockstep: duplicate lane sid {sid!r}")
                seen_sids.add(sid)
                j_qmax = max((len(s) for s in j_seqs), default=1)
                if not j_seqs or j_qmax + 2 > Qp:
                    churn.on_retire(sid, None, round_i + 1)
                    continue
                lanes[sid] = _Lane(sid, j_seqs, j_wgts, _new_graph(abpt))
                obs.count("lockstep.joins")
            capacity = max(capacity, len(lanes))
        if not lanes:
            break
        t_round = time.perf_counter()
        obs.rounds.begin_round()
        round_i += 1
        active = list(lanes.values())
        stats.add("rounds", 1)
        stats.add("live_lanes", len(active))
        obs.count("lockstep.chunks")
        occ = len(active) / capacity
        obs.observe("lockstep.noop_set_fraction", 1.0 - occ)
        scheduler.observe_lane_occupancy(occ, route=occ_route)
        if occ < 1.0:
            obs.count("lockstep.drain_chunks")

        # a lane's first read becomes its graph: fusion only, no DP
        dp_lanes: List[_Lane] = []
        done = []   # the lengths of the reads fused this round
        for lane in active:
            if lane.graph.node_n > 2:
                dp_lanes.append(lane)
                continue
            with obs.phase("fusion"):
                done.append(len(lane.seqs[lane.cursor]))
                fuse(lane, [], lane.seqs[lane.cursor],
                     lane.weights[lane.cursor])
            if lane.cursor >= lane.n_reads:
                retire(lane, (lane.graph, lane.is_rc), round_i)
        if not dp_lanes:
            _record_round(abpt, done, t_round, occ_route, len(active),
                          capacity, S)
            continue

        queries = [lane.seqs[lane.cursor] for lane in dp_lanes]
        with obs.phase("align"):
            for lane, q in zip(dp_lanes, queries):
                obs.record_dp(lane.graph.node_n, _band_cols(abpt, len(q)),
                              abpt.gap_mode)
            results = run_dp_chunk([lane.graph for lane in dp_lanes], abpt,
                                   queries, mesh=mesh)
            stats.add("dp_lanes", len(dp_lanes))
            flip = [False] * len(dp_lanes)
            if abpt.amb_strand:
                under = [i for i, (lane, q, res) in
                         enumerate(zip(dp_lanes, queries, results))
                         if res.best_score
                         < min(len(q), lane.graph.node_n - 2)
                         * abpt.max_mat * 0.3333]
                if under:
                    for i in under:
                        obs.record_dp(dp_lanes[i].graph.node_n,
                                      _band_cols(abpt, len(queries[i])),
                                      abpt.gap_mode)
                    rc_res = run_dp_chunk(
                        [dp_lanes[i].graph for i in under], abpt,
                        [_rc_encode(queries[i]) for i in under], mesh=mesh)
                    stats.add("rc_lanes", len(under))
                    for i, res in zip(under, rc_res):
                        if res.best_score > results[i].best_score:
                            results[i], flip[i] = res, True

        with obs.phase("fusion"):
            for lane, q, res, rc in zip(dp_lanes, queries, results, flip):
                w = lane.weights[lane.cursor]
                if rc:
                    lane.is_rc[lane.cursor] = True
                    q, w = _rc_encode(q), w[::-1].copy()
                done.append(len(q))
                fuse(lane, res.cigar, q, w)
                if lane.cursor >= lane.n_reads:
                    retire(lane, (lane.graph, lane.is_rc), round_i)
        _record_round(abpt, done, t_round, occ_route, len(active), capacity,
                      S)

    return [final.get(sid) for sid in range(K)]


def _record_round(abpt: Params, done: list, t_round: float, route: str,
                  lanes: int, k_cap: int, mesh: int) -> None:
    """The round's sample in the rounds timeline and one amortized latency
    record a read fused in it (a share of the round's wall;
    abpoa_tpu/parallel/lockstep.py:339)."""
    from .. import obs
    from ..pipeline import _band_cols
    wall = time.perf_counter() - t_round
    obs.rounds.record_round(route, lanes, k_cap, wall, mesh=mesh)
    if not done:
        return
    share = wall / len(done)
    for qlen in done:
        obs.record_read(share, qlen, _band_cols(abpt, qlen), abpt.device,
                        amortized=True)
