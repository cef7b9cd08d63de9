"""Kernel X1w's tile rule (csrc/backtrack_windows.cu: the walker reads a
step from the shared-memory tile that holds it, else from device memory) on
fixtures built to reach each of its branches (`chip_smoke.tile_fixture`,
graphs built through the port's per-read route on the CPU):

- a bubble whose insertion branch (300 rows) is longer than a tile's rows,
  so the row after it has a predecessor past any tile;
- a query with an insertion run and a deletion run of 60, longer than a
  tile's 32 columns;
- a local walk that starts and stops inside the graph;
- `-G` path scores, and a `-b -1` whole-row window (B2u's planes).

X1w's plain version (`backtrack_windows_torch`) over each fixture's B2 or
B2u launch equals the JAX package's packed walk (`_dp_full_batch` through
`jax_backend.align_windows_jax`, as test_torch_windows_backtrack.py holds
it) in linear, affine and convex gaps, tolerance 0: the header, the
window's final mpl/mpr and the ops. The host replay of the tile rule
(`chip_smoke.tile_replay`) on each fixture's walk reaches the branch the
fixture was built for: a step whose predecessor lies below the tile, a
step past the tile's columns, a stage change. `tile_shape` fits two stages
in a block's shared memory for every gap mode, P and score matrix.
"""
import copy
import functools

import numpy as np
import pytest

import chip_smoke
import abpoa_tpu.graph as jgraph
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align.backtrack_kernel import (HEADER,
                                                    backtrack_windows_torch,
                                                    tile_shape)
from test_torch_windows_backtrack import _jax_packed

GAPS = list(chip_smoke.TILE_GAPS)
KINDS = list(chip_smoke.TILE_FIXTURES)


def _jax_graph(g):
    """The JAX package's graph of the port's graph `g` (the same fields:
    `convert.graph_from_numpy` with the JAX package's classes)."""
    a = convert.graph_to_numpy(g)
    saved = convert.POAGraph, convert.Node
    convert.POAGraph, convert.Node = jgraph.POAGraph, jgraph.Node
    try:
        return convert.graph_from_numpy(a)
    finally:
        convert.POAGraph, convert.Node = saved


@functools.lru_cache(maxsize=None)
def _walk(kind: str, gap: str):
    """The fixture's walk by X1w's plain version: (Params, graph, query,
    X1w's inputs and keywords, its packed output as numpy, the layout)."""
    p, g, query = chip_smoke.tile_fixture(kind, gap)
    ts, out, t = chip_smoke.tile_launch(p, g, query)
    xin, xkw, layout = banded.walk_inputs(p, ts, out, [t], [query], [0])
    packed = backtrack_windows_torch(*xin, **xkw).numpy()
    return p, g, query, xin, xkw, packed, layout, t.gn


@pytest.mark.parametrize("gap", GAPS)
@pytest.mark.parametrize("kind", KINDS)
def test_fixture_walk_equals_jax_packed(kind, gap):
    p, g, query, _, _, packed, layout, gn = _walk(kind, gap)
    jp = JaxParams(device="numpy")
    for k, v in {**chip_smoke.TILE_GAPS[gap], **chip_smoke.TILE_FIXTURES[kind]}.items():
        setattr(jp, k, v)
    jp.finalize()
    jg = _jax_graph(g)
    jg.topological_sort(jp)
    want = _jax_packed(jp, copy.deepcopy(jg), [(C.SRC_NODE_ID, C.SINK_NODE_ID, query)])
    (h, b, o, _), (w_head, w_mpl, w_mpr, w_ops) = layout[0], want[0]
    n_ops = int(packed[h])
    assert packed[h: h + HEADER].tolist() == w_head.tolist()
    assert packed[h + 7] == 0 and n_ops > 400  # no err; a real walk
    np.testing.assert_array_equal(packed[b: b + gn], w_mpl)
    np.testing.assert_array_equal(packed[b + gn: b + 2 * gn], w_mpr)
    np.testing.assert_array_equal(packed[o: o + 2 * n_ops].reshape(n_ops, 2), w_ops)


# the branch of the tile rule each fixture is built to reach (convex gaps)
BRANCHES = {"bubble": ("far", "rows"), "gaps": ("columns",),
            "local": ("columns",), "path scores": ("columns",),
            "whole rows": ("columns",)}


@pytest.mark.parametrize("kind", KINDS)
def test_tile_replay_reaches_the_fixture_branch(kind):
    p, g, query, xin, xkw, packed, layout, _ = _walk(kind, "convex")
    rep = chip_smoke.tile_replay(xin, xkw, packed)
    assert rep["steps"] == int(packed[layout[0][0]])
    for branch in BRANCHES[kind]:
        assert rep[branch] >= 1, (branch, rep)
    assert rep["changes"] >= 1 and rep["loads"] > rep["changes"]
    if kind == "bubble":  # the step at the join row reads device memory
        assert rep["held"] < rep["steps"]
    else:
        assert rep["held"] == rep["steps"] and rep["far"] == 0
    if kind == "local":  # it starts before the query's end, stops above row 0
        h = layout[0][0]
        assert int(packed[h + 10]) < len(query) and int(packed[h + 1]) > 0


@pytest.mark.parametrize("gap", [C.LINEAR_GAP, C.AFFINE_GAP, C.CONVEX_GAP])
@pytest.mark.parametrize("P", [1, 4, 16, 32, 64])
def test_tile_shape_fits_two_stages_in_a_block(gap, P):
    for path_score in (False, True):
        for m in (5, 27):  # nucleotides, amino acids
            s = tile_shape(gap, P, path_score, m)
            assert 64 <= s["R"] <= 256 and s["R"] % 8 == 0
            assert s["smem"] <= 232448
            assert s["staged_p"] == (P if P <= 32 else 0)
            assert s["planes"] == {C.LINEAR_GAP: 1, C.AFFINE_GAP: 3,
                                   C.CONVEX_GAP: 5}[gap]
