"""Kernel S1 as the fused loop runs it, the tail of a fusion in place
(`finish_fusion_`: the span update and the edge sort), against the JAX
package, on the CPU.

- `finish_fusion_torch_`, with and without the span update, equals JAX
  `fused_loop._edge_sort` after the JAX loop's span update
  (abpoa_tpu/align/fused_loop.py:1447-1449) on the tie-heavy rows of
  `chip_smoke.tie_graph` (E = 8, 16, 32) and on the graphs of the fused
  loop that tests/test_torch_edge_sort.py uses (a graph straight out of a
  fusion, before its sort, and a mid-run graph with aligned groups) and on
  sim2k's fourth read fused, before its sort (rows on both sides move);
  the loop's graphs have count 0 on every row past node_n;
- the rows written are the rows that move: a row already in order keeps
  every slot, rows past node_n are not touched even where they hold junk
  and a nonzero count (the port's own contract; JAX sorts every row);
- the kernel's test of a row (`moving_rows`: a weight among the first cnt
  above the one before it) flags exactly the rows the exchange sort
  changes, on random rows with many ties and counts out of range;
- `fused_loop._finish_fusion` raises when the fused graph shares storage
  with the state's graph, which a read that reports an error runs again
  from;
- a run whose reads first overflow a tiny band (so each is run again from
  the state's graph after its in-place sort) gives the JAX loop's graph and
  consensus byte for byte.
Every comparison is exact. The CUDA kernel is held against its plain version
in tests/test_torch_cuda_twins.py and tests/test_torch_sort_twins.py.
"""
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import abpoa_tpu.align.device_graph as jdg
import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu.cons.consensus import generate_consensus as jax_consensus
from abpoa_tpu.io.output import output_fx_consensus as jax_output
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.edge_sort_kernel import (finish_fusion_,
                                                    finish_fusion_torch_,
                                                    moving_rows, sort_rows)
from abpoa_tpu_torch.cons.consensus import generate_consensus
from abpoa_tpu_torch.io.output import output_fx_consensus
from abpoa_tpu_torch.params import Params

import chip_smoke
from test_torch_cuda_twins import aligned_read, make_params, port_state
from test_torch_fused_loop import _reads

torch.set_num_threads(1)

SLOTS = ("in_ids", "in_w", "out_ids", "out_w")
FINISHED = SLOTS + ("n_span",)


def tie_case(E, n=80):
    """The tie graph's slots and counts, a random n_span and node_n."""
    arrays = chip_smoke.tie_graph(E)
    rng = np.random.default_rng(E)
    span = rng.integers(0, 50, arrays[0].shape[0]).astype(np.int32)
    return arrays + [span, np.array([n], np.int32)]


def graph_case(g):
    return [t.numpy().copy() for t in (g.in_ids, g.in_w, g.out_ids, g.out_w,
                                       g.in_cnt, g.out_cnt, g.n_span,
                                       g.node_n.reshape(1))]


@pytest.fixture(scope="module")
def cases():
    """name -> (in_ids, in_w, out_ids, out_w, in_cnt, out_cnt, n_span,
    node_n) numpy arrays: the tie graphs and the fused loop's graphs of
    tests/test_torch_edge_sort.py's `loop_graphs`, and sim2k's fourth read
    fused, before its sort, where rows move."""
    abpt, st, run, k, fwd = aligned_read("seq.fa", 6)
    fused = tfl._fuse_vectorized(st.g, *fwd[:3], run.seqs[k], run.lens[k],
                                 run.wgts[k])[0]
    heter = port_state("heter.fa", 8, make_params())[0].g
    out = {f"ties-E{E}": tie_case(E) for E in (8, 16, 32)}
    out["seq-fused-unsorted"] = graph_case(fused)
    out["heter-sorted"] = graph_case(heter)
    abpt, st, run, k, fwd = aligned_read("sim2k.fa", 3)
    out["sim2k-fused-unsorted"] = graph_case(tfl._fuse_vectorized(
        st.g, *fwd[:3], run.seqs[k], run.lens[k], run.wgts[k])[0])
    return out


LOOP = ["seq-fused-unsorted", "heter-sorted", "sim2k-fused-unsorted"]
NAMES = ["ties-E8", "ties-E16", "ties-E32"] + LOOP


def jax_finish(a, span: bool):
    """JAX: the loop's span update (fused_loop.py:1447-1449), then
    `_edge_sort` over every row."""
    N, A = a[0].shape[0], 2
    z = jnp.zeros(N, jnp.int32)
    g = jdg.DeviceGraph(
        base=z, in_ids=jnp.asarray(a[0]), in_w=jnp.asarray(a[1]),
        in_cnt=jnp.asarray(a[4]), out_ids=jnp.asarray(a[2]),
        out_w=jnp.asarray(a[3]), out_cnt=jnp.asarray(a[5]),
        aligned=jnp.zeros((N, A), jnp.int32), aligned_cnt=z, n_read=z,
        n_span=jnp.asarray(a[6]), node_n=jnp.int32(int(a[7][0])),
        ok=jnp.bool_(True))
    if span:
        nodes_r = jnp.arange(N, dtype=jnp.int32)
        g = g._replace(n_span=jnp.where(nodes_r < g.node_n, g.n_span + 1,
                                        g.n_span))
    g = jfl._edge_sort(g)
    return [np.asarray(getattr(g, k)) for k in FINISHED]


def port_finish(a, span: bool, node_n=None):
    t = [torch.from_numpy(x.copy()) for x in a]
    nn = t[7] if node_n is None else torch.tensor([node_n], dtype=torch.int32)
    finish_fusion_torch_(*t[:6], nn, t[6] if span else None)
    return [x.numpy() for x in t[:4]] + [t[6].numpy()]


@pytest.mark.parametrize("span", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_finish_fusion_matches_jax(name, span, cases):
    a = cases[name]
    got = port_finish(a, span)
    for k, x, y in zip(FINISHED, got, jax_finish(a, span)):
        np.testing.assert_array_equal(x, y, err_msg=k)
    # through the wrapper, which takes the plain version for CPU tensors
    t = [torch.from_numpy(x.copy()) for x in a]
    finish_fusion_(*t[:6], t[7], t[6] if span else None)
    for k, x, y in zip(FINISHED, [x.numpy() for x in t[:4]] + [t[6].numpy()],
                       got):
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name", LOOP)
def test_loop_graphs_have_no_counts_past_node_n(name, cases):
    """Why skipping the rows past node_n matches JAX on the loop's graphs."""
    a = cases[name]
    n = int(a[7][0])
    assert n < a[0].shape[0]
    assert not a[4][n:].any() and not a[5][n:].any()


@pytest.mark.parametrize("name", NAMES)
def test_only_the_rows_that_move_are_written(name, cases):
    a = cases[name]
    n = int(a[7][0])
    got = port_finish(a, True)
    want = jax_finish(a, True)
    for side, (ids, w, cnt) in enumerate(((0, 1, 4), (2, 3, 5))):
        moves = moving_rows(torch.from_numpy(a[w][:n]),
                            torch.from_numpy(a[cnt][:n])).numpy()
        # the rows JAX's sort changes are exactly the rows the port writes
        changed = ((want[ids][:n] != a[ids][:n]).any(1)
                   | (want[w][:n] != a[w][:n]).any(1))
        np.testing.assert_array_equal(moves, changed)
        for k in (ids, w):
            np.testing.assert_array_equal(got[k][:n][~moves], a[k][:n][~moves])
    if name.startswith("ties") or name == "sim2k-fused-unsorted":
        # rows out of order on both sides: the sort has work here
        for w, cnt in ((1, 4), (3, 5)):
            assert moving_rows(torch.from_numpy(a[w][:n]),
                               torch.from_numpy(a[cnt][:n])).sum() >= 10


@pytest.mark.parametrize("E", [8, 16, 32])
def test_rows_past_node_n_are_not_touched(E):
    a = tie_case(E)
    n = 50
    assert a[4][n:80].any()  # junk rows with counts past the node_n below
    t = [torch.from_numpy(x.copy()) for x in a]
    finish_fusion_(*t[:6], torch.tensor([n], dtype=torch.int32), t[6])
    got = [x.numpy() for x in t[:4]] + [t[6].numpy()]
    want = jax_finish(a[:7] + [np.array([n], np.int32)], True)
    for k, x, y, x0 in zip(FINISHED, got, want, a[:4] + [a[6]]):
        np.testing.assert_array_equal(x[n:], x0[n:], err_msg=k)
        np.testing.assert_array_equal(x[:n], y[:n], err_msg=k)


# ---- which rows the kernel writes --------------------------------------------

@pytest.mark.parametrize("E", [2, 5, 8, 16, 33, 64])
def test_moving_rows_are_the_rows_the_sort_changes(E):
    """The kernel's row test is exact: a row whose first cnt weights do not
    increase is one `sort_rows` leaves as it is, and every other row it
    changes (counts below 0 and past E included)."""
    rng = np.random.default_rng(E)
    B = 2000
    w = torch.from_numpy(rng.integers(1, 4, (B, E)).astype(np.int32))
    ids = torch.arange(B * E, dtype=torch.int32).reshape(B, E)
    cnt = torch.from_numpy(rng.integers(-1, E + 2, B).astype(np.int32))
    s_ids, s_w = sort_rows(ids, w, cnt)
    changed = (s_ids != ids).any(1) | (s_w != w).any(1)
    moves = moving_rows(w, cnt)
    assert torch.equal(moves, changed)
    assert 0 < int(moves.sum()) < B


# ---- the fused loop ----------------------------------------------------------

@pytest.mark.parametrize("name", FINISHED)
def test_finish_fusion_refuses_the_state_graphs_storage(name):
    st = port_state("seq.fa", 3, make_params())[0]
    g = st.g
    before = {k: t.clone() for k, t in g.tensors().items()}
    g2 = g._replace(**{k: getattr(g, k).clone() for k in FINISHED if k != name})
    with pytest.raises(RuntimeError, match=name):
        tfl._finish_fusion(g2, g)
    # a view of the same storage is refused as well
    g3 = g._replace(**{k: (getattr(g, k).view(getattr(g, k).shape)
                           if k == name else getattr(g, k).clone())
                       for k in FINISHED})
    with pytest.raises(RuntimeError, match=name):
        tfl._finish_fusion(g3, g)
    for k, t in g.tensors().items():
        assert torch.equal(t, before[k]), k
    # fresh copies are finished in place, the state's graph left alone
    g4 = g._replace(**{k: getattr(g, k).clone() for k in FINISHED})
    assert tfl._finish_fusion(g4, g) is g4
    assert torch.equal(g4.n_span[:int(g.node_n)], g.n_span[:int(g.node_n)] + 1)
    for k, t in g.tensors().items():
        assert torch.equal(t, before[k]), k


def test_rerun_after_band_overflow_matches_jax():
    """Tiny W: reads overflow the band after their fusion and sort ran in
    place, are run again from the state's graph at a wider band, and the
    run ends with the JAX loop's graph and consensus."""
    tp = Params(device="cpu").finalize()
    jp = JaxParams()
    jp.device = "jax"
    jp.finalize()
    seqs, w = _reads("seq.fa", tp)
    tfl.reset_stats()
    pg, _, _ = tfl.progressive_poa_fused(seqs, w, tp,
                                         init_caps=(2048, 8, 8, 8))
    assert tfl.stats["grow"].get(tfl.ERR_BAND_CAP, 0) > 0
    assert tfl.stats["reads"] > len(seqs) - 1  # some read ran twice
    jpg, _, _ = jfl.progressive_poa_fused(seqs, w, jp, use_pallas=False)
    a, b = convert.graph_to_numpy(pg), convert.graph_to_numpy(jpg)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, want = io.StringIO(), io.StringIO()
    output_fx_consensus(generate_consensus(pg, tp, len(seqs)), tp, got)
    jax_output(jax_consensus(jpg, jp, len(seqs)), jp, want)
    assert got.getvalue() == want.getvalue() and got.getvalue().count(">") == 1
