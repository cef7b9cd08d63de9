"""The K-lane DP chunk of the lockstep and map routes: K (graph, read)
lanes in one launch of kernel B2, then one launch of X1w over its ok lanes.

Counterpart of `abpoa_tpu/align/dp_chunk.py`:
- `run_dp_chunk` (:61, a jit of a vmap over K sets of the banded DP, the
  best-cell pick and `_backtrack_w`) is one B2 launch with one block a lane,
  the lanes' whole graphs packed ragged through `roff`, and one X1w launch
  over that launch's ok lanes (`banded.align_windows_banded` with one graph
  a window). The port launches live lanes only: JAX pads the lane axis to
  `k_rung`, B2 needs no padding lane. A lane whose band outgrows W is
  launched again alone with the other such lanes at a doubled W, where JAX
  grows W for the whole group and replays the round; each lane's result is
  that of its own per-read alignment either way.
- `build_graph_tables`, `stamp_query` and `build_lockstep_tables`
  (:128, :206, :241) are the port's `tables.build_row_tables` (a native
  graph's through `native_row_tables`) and `tables.query_tables`.
- `StaticGraphTables` (:255) builds one graph's row tables once, and keeps
  on each device of the run the graph half of a K-lane pack (`lanes`): a
  launch of k <= K lanes of that graph uploads only the query half.
- `mesh=` (a tuple of devices, `parallel/shard.py`) splits the lanes of a
  chunk over the mesh's slots, JAX's `shard_dp_round` (shard.py:189); each
  lane's result is the unsharded one.
- `result_from_chunk` (:304) is `banded._result`, which rebuilds the cigar
  as JAX's `_result_from_packed` does; B2 keeps int32 planes, so
  `chunk_plane16` has no twin.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .. import constants as C
from ..params import Params
from .banded import align_windows_banded, pack_graph
from .result import AlignResult
from .tables import build_row_tables

# over the life of the process: the graph sorts before a chunk (their
# seconds), static tables built and graph halves uploaded
stats = {"sort_s": 0.0, "static_builds": 0, "static_uploads": 0}


def reset_stats() -> None:
    stats.update(sort_s=0.0, static_builds=0, static_uploads=0)


def run_dp_chunk(graphs: list, abpt: Params, queries: List[np.ndarray],
                 mesh=None) -> List[AlignResult]:
    """Align queries[i] to the whole of graphs[i], every lane in one B2
    launch (plus the relaunch of overflowed lanes) and one X1w launch a
    B2 launch: one AlignResult a lane, each that lane's per-read alignment
    (`dispatch.align_sequence_to_graph`), band write-back included. With
    `mesh`, one B2 launch a slot over its slice of the lanes."""
    if not queries:
        return []
    t0 = time.perf_counter()
    for g in graphs:
        if not g.is_topological_sorted:
            g.topological_sort(abpt)
    stats["sort_s"] += time.perf_counter() - t0
    windows = [(C.SRC_NODE_ID, C.SINK_NODE_ID, q) for q in queries]
    return align_windows_banded(list(graphs), abpt, windows, mesh=mesh)


class StaticGraphTables:
    """One graph's DP tables for the map route: its row tables built once,
    the index -> node id map the cigar rebuild reads, a node-id-indexed
    base array for the GAF's match count, and on each device that runs its
    lanes (every card of a mesh) the graph half of a pack of K lanes of
    that graph, uploaded once per device and K."""

    def __init__(self, g, abpt: Params) -> None:
        if not g.is_topological_sorted:
            g.topological_sort(abpt)
        self.graph = g
        self.abpt = abpt
        self.tables = build_row_tables(g, C.SRC_NODE_ID, C.SINK_NODE_ID, abpt)
        self.n_rows = self.tables.gn
        self.idx2nid = np.asarray(g.index_to_node_id[:self.n_rows],
                                  dtype=np.int64)
        base = np.zeros(int(self.idx2nid.max(initial=0)) + 1, np.int32)
        base[self.idx2nid] = self.tables.base[:self.n_rows]
        self.base_by_nid = base
        self._packs: dict = {}   # device -> (K, the graph half)
        stats["static_builds"] += 1

    def upload(self, K: int, dev=None) -> None:
        """Put the graph half of K lanes on `dev` (default the run's
        device), once per device and K."""
        dev = self.abpt.torch_device if dev is None else dev
        if self._packs.get(dev, (0,))[0] == K:
            return
        self._packs.pop(dev, None)
        half = pack_graph([self.tables] * K)
        self._packs[dev] = (K, [torch.from_numpy(a).to(dev) for a in half])
        stats["static_uploads"] += 1

    def align(self, queries: List[np.ndarray],
              mesh=None) -> List[AlignResult]:
        """`run_dp_chunk` with every lane on this graph: its tables and the
        pack's graph half serve every launch, and the graph's band is not
        written back, so no read's result depends on the reads before it.
        With `mesh`, the lanes split over its slots, each reading the pack
        on its own device."""
        if not queries:
            return []
        windows = [(C.SRC_NODE_ID, C.SINK_NODE_ID, q) for q in queries]
        return align_windows_banded(self.graph, self.abpt, windows,
                                    static=self, mesh=mesh)

    def lanes(self, k: int, dev=None) -> list:
        """The graph half of the first k lanes of the pack on `dev` (default
        the run's device; a pack of k lanes is uploaded when the one there
        is smaller): contiguous prefixes of its rows and roff."""
        dev = self.abpt.torch_device if dev is None else dev
        if k > self._packs.get(dev, (0,))[0]:
            self.upload(k, dev)
        pack = self._packs[dev][1]
        rows = k * self.n_rows
        half = [t[:rows] for t in pack[:8]] + [pack[8][:k + 1]]
        return half + [t[:rows] for t in pack[9:]]
