"""The K-lane DP chunk (`abpoa_tpu_torch/align/dp_chunk.py`) on the CPU:
kernel B2's and X1w's plain versions over K (graph, read) lanes in one
launch, held exactly against the JAX package's `dispatch_dp_chunk` +
`result_from_chunk` on the same graphs and reads (cigar, best score,
node_e, query_e), in every gap regime at K = 1, 4 and 8, with lanes of
divergent graph sizes and read lengths:
- each lane also equals the port's one-read per-read route;
- a first W too narrow for the longest lanes relaunches those lanes alone
  at a doubled W, with the results unchanged;
- the amb-strand rescue's second launch (the reverse complements of the
  lanes under the threshold) equals JAX's second dispatch;
- a static graph's tables are built once and its graph half is uploaded
  once per K, a launch of k <= K lanes using the pack's first k lanes.
"""
import numpy as np
import pytest
import torch

from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import banded, dp_chunk
from abpoa_tpu_torch.align.dispatch import align_sequence_to_graph
from abpoa_tpu_torch.convert import (graph_from_numpy, graph_to_numpy,
                                     native_graph_from_numpy)
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.pipeline import _rc_encode

torch.set_num_threads(1)

GAPS = {"convex": {}, "affine": {"gap_open2": 0},
        "linear": {"gap_open1": 0, "gap_open2": 0}}


def jax_params(device, **kw):
    from abpoa_tpu.params import Params as JP
    abpt = JP()
    abpt.device = device
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


def port_params(**kw):
    abpt = Params(device="cpu")
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


def random_sets(rng, sizes, qlen_lo=40, qlen_hi=200, err=0.12):
    """Read sets of divergent lengths: set i has sizes[i] reads of a
    mutated reference whose length differs from set to set (the shape of
    tests/test_lockstep_split.py's `_random_sets`)."""
    sets, wsets = [], []
    for n in sizes:
        L = int(rng.integers(qlen_lo, qlen_hi))
        ref = rng.integers(0, 4, L).astype(np.uint8)
        reads = []
        for _ in range(n):
            r = ref.copy()
            n_mut = max(1, int(err * L))
            pos = rng.integers(0, L, n_mut)
            r[pos] = rng.integers(0, 4, n_mut)
            reads.append(r)
        sets.append(reads)
        wsets.append([np.ones(len(r), dtype=np.int64) for r in reads])
    return sets, wsets


def jax_graphs(sets, **kw):
    """JAX host graphs of every set but its last read (the JAX host loop),
    and the last reads."""
    from abpoa_tpu.pipeline import Abpoa, poa
    abpt = jax_params("numpy", **kw)
    graphs = []
    for reads in sets:
        ab = Abpoa()
        for r in reads[:-1]:
            ab.append_read(seq="x" * len(r))
        poa(ab, abpt, reads[:-1], [np.ones(len(r), np.int64) for r in reads[:-1]], 0)
        graphs.append(ab.graph)
    return graphs, [reads[-1] for reads in sets]


def jax_chunk(graphs, queries, **kw):
    """JAX's split-lockstep dispatch over the lanes: [(AlignResult,
    flags)]."""
    from abpoa_tpu.align.dp_chunk import (build_lockstep_tables,
                                          chunk_plane16, dispatch_dp_chunk,
                                          plan_degree_rung, plan_row_rung,
                                          result_from_chunk)
    from abpoa_tpu.compile.ladder import k_rung, plan_chunk_buckets, qp_rung
    abpt = jax_params("jax", **kw)
    qmax = max(len(q) for q in queries)
    Qp = qp_rung(qmax)
    _, W, _ = plan_chunk_buckets(abpt, qmax)
    tabs = [build_lockstep_tables(g, abpt, q, Qp) for g, q in zip(graphs, queries)]
    n = max(t["n_rows"] for t in tabs)
    packed = dispatch_dp_chunk(
        abpt, tabs, k_rung(len(tabs)), plan_row_rung(n),
        plan_degree_rung(max(t["pre_idx"].shape[1] for t in tabs)), Qp, W,
        chunk_plane16(abpt, qmax, n))
    return [result_from_chunk(abpt, packed[i], tabs[i], g.index_to_node_id)
            for i, g in enumerate(graphs)]


def port_graphs(graphs, native=True):
    make = native_graph_from_numpy if native else graph_from_numpy
    return [make(graph_to_numpy(g)) for g in graphs]


def same(got, want):
    """The fields JAX's result_from_chunk fills."""
    assert got.cigar == want.cigar
    assert (got.best_score, got.node_e, got.query_e) == \
        (want.best_score, want.node_e, want.query_e)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("gap", list(GAPS))
def test_chunk_equals_jax_and_per_read_route(gap, k):
    rng = np.random.default_rng(17 + k)
    sets, _ = random_sets(rng, [int(rng.integers(2, 6)) for _ in range(k)])
    jg, queries = jax_graphs(sets, **GAPS[gap])
    want = jax_chunk(jg, queries, **GAPS[gap])
    abpt = port_params(**GAPS[gap])
    launches = banded.stats["launches"]
    got = dp_chunk.run_dp_chunk(port_graphs(jg), abpt, queries)
    assert banded.stats["launches"] - launches == 1   # one launch, K lanes
    for g, q, res, (w, flags) in zip(port_graphs(jg), queries, got, want):
        assert not flags["overflow"] and not flags["bt_err"]
        same(res, w)
        same(align_sequence_to_graph(g, abpt, q), w)


def test_overflowed_lanes_relaunch_alone(monkeypatch):
    """A first W of 24 columns: the lanes whose band outgrows it go again,
    alone, at a doubled W; every lane still equals JAX's."""
    rng = np.random.default_rng(3)
    sets, _ = random_sets(rng, [3, 2, 4, 3], qlen_lo=40, qlen_hi=400)
    jg, queries = jax_graphs(sets)
    want = jax_chunk(jg, queries)
    abpt = port_params()
    sizes = []
    real = banded.run_windows

    def count(abpt_, tabs, queries_, W, graph_half=None):
        sizes.append((len(tabs), W))
        return real(abpt_, tabs, queries_, W, graph_half)

    monkeypatch.setattr(banded, "run_windows", count)
    retries = banded.retries
    windows = [(C.SRC_NODE_ID, C.SINK_NODE_ID, q) for q in queries]
    got = banded.align_windows_banded(port_graphs(jg), abpt, windows,
                                      band_width=24)
    assert banded.retries > retries
    assert sizes[0] == (4, 24) and 0 < sizes[1][0] < 4 and sizes[1][1] > 24
    for res, (w, _) in zip(got, want):
        same(res, w)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_amb_strand_second_launch_equals_jax(native):
    """Lanes whose reads are reverse complements fall under the threshold;
    the second launch over them (after the forward launch's band
    write-back, as `pipeline.poa` orders it) equals JAX's dispatch of the
    reverse complements on the same graphs."""
    rng = np.random.default_rng(11)
    sets, _ = random_sets(rng, [3, 4, 2, 3])
    jg, queries = jax_graphs(sets)
    queries = [_rc_encode(q) if i % 2 else q for i, q in enumerate(queries)]
    abpt = port_params(amb_strand=True)
    pg = port_graphs(jg, native)
    fwd = dp_chunk.run_dp_chunk(pg, abpt, queries)
    under = [i for i, (g, q, r) in enumerate(zip(pg, queries, fwd))
             if r.best_score < min(len(q), g.node_n - 2) * abpt.max_mat * 0.3333]
    assert under == [1, 3]
    rc = [_rc_encode(queries[i]) for i in under]
    got = dp_chunk.run_dp_chunk([pg[i] for i in under], abpt, rc)
    want = jax_chunk([jg[i] for i in under], rc)
    for i, res, (w, _) in zip(under, got, want):
        same(res, w)
        assert res.best_score > fwd[i].best_score   # the rescue flips it


def test_static_tables_built_once_and_uploaded_once_per_k():
    rng = np.random.default_rng(8)
    sets, _ = random_sets(rng, [5])
    jg, _ = jax_graphs(sets)
    abpt = port_params()
    g = port_graphs(jg)[0]
    builds = dp_chunk.stats["static_builds"]
    st = dp_chunk.StaticGraphTables(g, abpt)
    uploads = dp_chunk.stats["static_uploads"]
    queries = [r for r in random_sets(rng, [6])[0][0]]
    first = st.align(queries[:4])
    assert dp_chunk.stats["static_uploads"] - uploads == 1
    again = st.align(queries[:3]) + st.align(queries[3:4])   # prefixes
    assert dp_chunk.stats["static_uploads"] - uploads == 1
    assert dp_chunk.stats["static_builds"] - builds == 1
    lanes = st.lanes(2)
    assert lanes[8].tolist() == [0, st.n_rows, 2 * st.n_rows]
    assert lanes[0].shape[0] == 2 * st.n_rows
    for a, b in zip(first, again):
        assert a.cigar == b.cigar and a.best_score == b.best_score
    for q, res in zip(queries, first):   # == a graph never written back
        fresh = port_graphs(jg)[0]
        same(res, align_sequence_to_graph(fresh, abpt, q))
