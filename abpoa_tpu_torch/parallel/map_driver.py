"""The map route: reads against one restored graph that never changes, K
reads in one K-lane launch of kernel B2 (and one of X1w) a round.

Counterpart of `abpoa_tpu/parallel/map_driver.py` (`MapHook` :44,
`load_static_graph` :65, `map_read_host` :82, `map_reads_split` :117, its
`mesh=` :130). With a mesh (`parallel/shard.py`) the graph's tables are
replicated on every card of it (one upload a card) and each round's reads
split over its slots. The
graph is restored once (`io/restore.py`, the `-i` ingest), its tables are
built once (`dp_chunk.StaticGraphTables`) and their graph half is uploaded
once per lane count; the graph is never fused into and its band is never
written back, so a read's result does not depend on the reads before it.
Every lane retires at the end of its round, so every round boundary is a
join point. With `-s`, the reads under the host float threshold
`min(qlen, node_n - 2) * max_mat * 0.3333` are aligned again as reverse
complements in a second K-lane launch, and the better score wins (strand
"-"). A failed X1w walk raises (`banded._result`): the JAX driver's
`map_bt_err` fallback has no twin, since X1w is held to the host walk.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..obs.tally import Tally
from ..params import Params


def _zero_stats() -> dict:
    return {"rounds": 0, "reads": 0, "rc_reads": 0}


# over the life of the process: map rounds, reads mapped and reads aligned
# again as reverse complements
stats = Tally(_zero_stats)


def reset_stats() -> None:
    stats.reset()


class MapHook:
    """Round-boundary streaming of `map_reads_split`.

    ``on_round(round_i, free_slots)`` is called before each round and
    returns up to ``free_slots`` joiners as ``(rid, query)`` (encoded
    reads). A joiner off the group's query rung (qlen + 2 > Qp) is refused
    through ``on_retire(rid, None, round_i)``.

    ``on_retire(rid, outcome, round_i)`` delivers one read's result, the
    round it ran: ``(AlignResult, strand)``, strand "+" or "-".
    """

    def on_round(self, round_i: int, free_slots: int) -> list:
        return []

    def on_retire(self, rid, outcome, round_i: int) -> None:  # pragma: no cover
        pass


def load_static_graph(path: str, abpt: Params):
    """Restore the GFA or MSA at `path` (the `-i` ingest) and build its
    tables once. Returns ``(ab, static)``; raises ValueError when the file
    restores no graph."""
    from ..align.dp_chunk import StaticGraphTables
    from ..io.restore import restore_graph
    from ..pipeline import Abpoa, _select_graph, want_native
    ab = Abpoa()
    _select_graph(ab, want_native(abpt))
    abpt.incr_fn = path
    restore_graph(ab, abpt)
    if ab.n_seq == 0 or ab.graph.node_n <= 2:
        raise ValueError(f"no graph restored from {path!r} "
                         "(expected abPOA GFA S/P lines or an MSA FASTA)")
    return ab, StaticGraphTables(ab.graph, abpt)


def map_read_host(static, abpt: Params, q: np.ndarray):
    """One read on its own (a one-lane round): the serial baseline of the
    map route. Returns ``(AlignResult, strand)``."""
    return map_reads_split(static, [q], abpt, k_cap=1)[0]


def map_reads_split(static, queries: Sequence[np.ndarray], abpt: Params,
                    k_cap: Optional[int] = None,
                    hook: Optional[MapHook] = None,
                    Qp: Optional[int] = None, mesh=None) -> list:
    """Map `queries` (and any joiners `hook` streams in) against the
    static graph, up to `k_cap` reads a round. Returns one
    ``(AlignResult, strand)`` per query, in order, or None for a read off
    the query rung `Qp` (by default that of the longest query); joiners are
    answered through `hook.on_retire` only. `mesh` splits each round's
    reads over its slots; `k_cap` then defaults to the mesh's size times
    the lockstep group size."""
    from .. import obs
    from ..align.buckets import qp_rung
    from ..pipeline import _band_cols, _rc_encode
    from . import scheduler
    from .shard import mesh_size
    if Qp is None:
        Qp = qp_rung(max((len(q) for q in queries), default=1))
    if k_cap is None:
        from .runner import lockstep_group_size
        from .shard import mesh_size
        k_cap = mesh_size(mesh) * lockstep_group_size()
    k_cap = max(1, int(k_cap))
    thr_base = abpt.max_mat * 0.3333
    pending: List[Tuple[int, np.ndarray]] = list(enumerate(queries))[::-1]
    final: dict = {}

    def retire(rid, outcome, round_i: int) -> None:
        if isinstance(rid, int) and 0 <= rid < len(queries):
            final[rid] = outcome
        if hook is not None:
            hook.on_retire(rid, outcome, round_i)

    round_i = 0
    while True:
        # board the pending reads first, then the hook's joiners
        lanes: List[Tuple[object, np.ndarray]] = []
        while pending and len(lanes) < k_cap:
            rid, q = pending.pop()
            if len(q) + 2 > Qp:
                retire(rid, None, round_i + 1)
                continue
            lanes.append((rid, q))
        if hook is not None:
            for rid, q in hook.on_round(round_i + 1, k_cap - len(lanes)) or ():
                if len(q) + 2 > Qp or len(lanes) >= k_cap:
                    retire(rid, None, round_i + 1)
                    continue
                lanes.append((rid, q))
                obs.count("map.joins")
        if not lanes:
            break
        t_round = time.perf_counter()
        obs.rounds.begin_round()
        round_i += 1
        stats.add("rounds", 1)
        obs.count("map.rounds")
        occ = len(lanes) / k_cap
        scheduler.observe_lane_occupancy(
            occ, route="sharded" if mesh_size(mesh) > 1 else "map")
        obs.metrics.publish_map_round(len(lanes), occ)
        with obs.phase("align"):
            for _, q in lanes:
                obs.record_dp(static.n_rows, _band_cols(abpt, len(q)),
                              abpt.gap_mode)
            results = static.align([q for _, q in lanes], mesh=mesh)
            strands = ["+"] * len(lanes)
            if abpt.amb_strand:
                under = [i for i, ((_, q), res) in
                         enumerate(zip(lanes, results))
                         if res.best_score < min(len(q), static.n_rows - 2)
                         * thr_base]
                if under:
                    for i in under:
                        obs.record_dp(static.n_rows,
                                      _band_cols(abpt, len(lanes[i][1])),
                                      abpt.gap_mode)
                    rc_res = static.align(
                        [_rc_encode(lanes[i][1]) for i in under], mesh=mesh)
                    stats.add("rc_reads", len(under))
                    for i, res in zip(under, rc_res):
                        if res.best_score > results[i].best_score:
                            results[i], strands[i] = res, "-"
        for (rid, _), res, strand in zip(lanes, results, strands):
            retire(rid, (res, strand), round_i)
        stats.add("reads", len(lanes))
        obs.count("map.reads", len(lanes))
        # the round's sample and a share of its wall a read
        # (abpoa_tpu/parallel/map_driver.py:278-285)
        wall = time.perf_counter() - t_round
        obs.rounds.record_round("sharded" if mesh_size(mesh) > 1 else "map",
                                len(lanes), k_cap, wall, mesh=mesh_size(mesh))
        share = wall / len(lanes)
        for _, q in lanes:
            obs.record_read(share, len(q), _band_cols(abpt, len(q)),
                            abpt.device, amortized=True)
    return [final.get(rid) for rid in range(len(queries))]
