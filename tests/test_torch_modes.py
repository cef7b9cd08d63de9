"""Kernel B2's and X1w's remaining modes on the CPU, against the JAX package.

- The per-read alignment of the port (`banded.align_sequence_to_subgraph`:
  the tables, B2's plain version `banded_dp_torch`, X1w's plain version
  `backtrack_windows_torch`, the cigar rebuilt from its ops) equals the JAX
  package's per-read XLA DP (`align_sequence_to_subgraph_jax`, `_dp_full`)
  on the grid {global, local, extend, extend + Z-drop} x {convex, affine,
  linear} x {banded, unbanded} x {`-G` off, on} (local is unbanded only):
  cigar, best score, node_s/e, query_s/e, aligned and matched bases, and
  the mpl/mpr the alignment writes back into the graph. Convex gaps here,
  affine and linear in test_torch_modes_gaps.py. The graph is the JAX
  package's of tests/data/rcmix.fa's first 5 reads aligned in extend mode
  with Z-drop (reads of both strands: local alignments stop early and
  Z-drop fires on the 6th read), carried into the port's graph; the query
  is the 6th read.
- a local walk that stops before a zero cell inside the graph and the
  query (the read's middle between random flanks) equals the JAX
  package's host engine; there `_dp_full` dead-ends in linear and affine
  gaps (a reference-side difference, ROADMAP.md §C);
- `POAGraph.incre_path_score` equals the JAX graph's on every in-edge of a
  built graph, and the path-score table of `tables.build_row_tables` equals
  the one `_build_snapshot` gives its XLA DP.
All comparisons are exact.
"""
import copy
import functools
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu.align.jax_backend import (_build_snapshot,
                                         align_sequence_to_subgraph_jax)
from abpoa_tpu.io.fastx import read_fastx
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
from abpoa_tpu.pipeline import _ingest_records, poa
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align.banded import align_sequence_to_subgraph
from abpoa_tpu_torch.align.tables import build_row_tables
from abpoa_tpu_torch.params import Params

torch.set_num_threads(1)

GAPS = {"convex": {}, "affine": {"gap_open2": 0}, "linear": {"gap_open1": 0}}
MODES = {"global": {}, "local": {"align_mode": 1}, "extend": {"align_mode": 2},
         "extend-zdrop": {"align_mode": 2, "zdrop": 20}}
CUT = 400  # bases of each read kept: a graph of ~2 k rows
FIELDS = ("best_score", "node_s", "node_e", "query_s", "query_e",
          "n_aln_bases", "n_matched_bases")


def grid(gap: str) -> list:
    """(gap, mode, banded, path score) cases of one gap regime."""
    return [(gap, mode, banded, ps) for mode in MODES
            for banded in (True, False) for ps in (False, True)
            if not (banded and mode == "local")]


def fields(gap: str, mode: str, banded: bool, ps: bool) -> dict:
    kw = dict(GAPS[gap], **MODES[mode], inc_path_score=ps)
    if not banded:
        kw["wb"] = -1
    return kw


def make(cls, **kw):
    p = cls(device="cpu" if cls is Params else "numpy")
    for k, v in kw.items():
        setattr(p, k, v)
    return p.finalize()


@functools.lru_cache(maxsize=None)
def _graph(gap: str):
    """The JAX package's graph of rcmix.fa's first 5 reads in extend mode
    with Z-drop (host engine) and the 6th read."""
    recs = read_fastx(os.path.join(DATA_DIR, "rcmix.fa"))[:6]
    for r in recs:
        r.seq = r.seq[:CUT]
    jp = make(JaxParams, **GAPS[gap], align_mode=2, zdrop=20)
    ab = JaxAbpoa()
    seqs, weights = _ingest_records(ab, jp, recs[:5])
    poa(ab, jp, seqs, weights, 0)
    g = ab.graph.to_python() if getattr(ab.graph, "is_native", False) else ab.graph
    query = jp.char_to_code[np.frombuffer(recs[5].seq.encode(), dtype=np.uint8)]
    return g, query.astype(np.uint8)


def assert_per_read_equals_jax(gap, mode, banded, ps):
    kw = fields(gap, mode, banded, ps)
    jp, tp = make(JaxParams, **kw), make(Params, **kw)
    g, query = _graph(gap)
    jg = copy.deepcopy(g)
    jg.topological_sort(jp)
    tg = convert.graph_from_numpy(convert.graph_to_numpy(jg))
    want = align_sequence_to_subgraph_jax(jg, jp, 0, 1, query)
    got = align_sequence_to_subgraph(tg, tp, 0, 1, query)
    assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]
    assert list(got.cigar) == list(want.cigar)
    if banded:  # the band written back into the graph
        n = jg.node_n
        for attr in ("node_id_to_max_pos_left", "node_id_to_max_pos_right"):
            np.testing.assert_array_equal(getattr(tg, attr)[:n],
                                          getattr(jg, attr)[:n])
    return want


@pytest.mark.parametrize("gap,mode,banded,ps", grid("convex"))
def test_per_read_modes_equal_jax_dp_full(gap, mode, banded, ps):
    want = assert_per_read_equals_jax(gap, mode, banded, ps)
    if mode == "extend-zdrop":  # Z-drop stops the read early
        assert want.query_e < 100


def test_grid_covers_local_stops_and_zdrop():
    """The fixture reaches what the modes change: a local alignment that
    stops before the query's start and an extend alignment Z-drop ends."""
    g, query = _graph("convex")
    res = {}
    for mode in ("local", "extend", "extend-zdrop"):
        jp = make(JaxParams, **fields("convex", mode, mode != "local", False))
        jg = copy.deepcopy(g)
        jg.topological_sort(jp)
        res[mode] = align_sequence_to_subgraph_jax(jg, jp, 0, 1, query)
    assert res["extend-zdrop"].query_e < res["extend"].query_e
    assert res["local"].best_score > 0


def _flanked(gap):
    """The middle of the 6th read between 60 random bases on each side."""
    g, query = _graph(gap)
    flank = np.random.default_rng(3).integers(0, 4, (2, 60)).astype(np.uint8)
    return g, np.concatenate([flank[0], query[100:300], flank[1]])


@pytest.mark.parametrize("gap,ps", [("convex", False), ("linear", True),
                                    ("affine", False)])
def test_local_walk_stops_before_a_zero_cell_as_jax(gap, ps):
    """A local walk that stops before a zero cell inside both the graph
    and the query (X1w's local stop) equals the JAX package's host engine
    (`--device numpy`, the engine its CLI gives these configurations)."""
    from abpoa_tpu.align.dispatch import align_sequence_to_graph
    kw = fields(gap, "local", False, ps)
    jp, tp = make(JaxParams, **kw), make(Params, **kw)
    g, query = _flanked(gap)
    jg = copy.deepcopy(g)
    jg.topological_sort(jp)
    tg = convert.graph_from_numpy(convert.graph_to_numpy(jg))
    want = align_sequence_to_graph(jg, jp, query)
    got = align_sequence_to_subgraph(tg, tp, 0, 1, query)
    assert [getattr(got, f) for f in FIELDS] == [getattr(want, f) for f in FIELDS]
    assert list(got.cigar) == list(want.cigar)
    assert want.query_s > 0 and want.node_s > 2  # stopped inside both


@pytest.mark.parametrize("gap", ["linear", "affine"])
def test_jax_dp_full_dead_ends_on_the_flanked_local_case(gap):
    """A reference-side difference (ROADMAP.md §C): on the flanked query
    in local mode with linear or affine gaps, the JAX package's per-read
    XLA DP (`_dp_full`) ends its backtrack in a dead end and raises, where
    its host engine and the port align (the test above)."""
    jp = make(JaxParams, **fields(gap, "local", False, False))
    g, query = _flanked(gap)
    jg = copy.deepcopy(g)
    jg.topological_sort(jp)
    with pytest.raises(RuntimeError, match="device backtrack failed"):
        align_sequence_to_subgraph_jax(jg, jp, 0, 1, query)


def test_incre_path_score_equals_jax_graph():
    g, _ = _graph("convex")
    tg = convert.graph_from_numpy(convert.graph_to_numpy(g))
    scores = [(g.incre_path_score(n, k), tg.incre_path_score(n, k))
              for n in range(2, g.node_n)
              for k in range(len(g.nodes[n].in_ids))]
    assert scores and all(a == b for a, b in scores)
    assert {a for a, _ in scores} != {0}  # some edges score below 0


@pytest.mark.parametrize("banded", [True, False])
def test_path_score_table_equals_snapshot(banded):
    kw = fields("convex", "global", banded, True)
    jp, tp = make(JaxParams, **kw), make(Params, **kw)
    g, query = _graph("convex")
    jg = copy.deepcopy(g)
    jg.topological_sort(jp)
    tg = convert.graph_from_numpy(convert.graph_to_numpy(jg))
    snap = _build_snapshot(jg, jp, 0, 1, query)
    t = build_row_tables(tg, 0, 1, tp)
    gn, P = t.gn, t.pre_idx.shape[1]
    np.testing.assert_array_equal(t.pre_score[:gn], snap["pre_score"][:gn, :P])
    assert not snap["pre_score"][:gn, P:].any()
    assert t.pre_score[:gn].min() < 0
