"""`align_windows` (the port: B2 batched over a read's windows, its plain
version on the CPU) against the JAX package's `align_windows_jax` (the XLA
vmap `_dp_full_batch`, on the CPU), window by window, tolerance 0: each
window's cigar and best score, and the graph's max_pos_left/right (the
band state the windows seed and write back) after the call.

The windows are those the JAX CLI's seeded route aligns for reads 2-4 of
tests/data/sim2k.fa, captured with the graph they were aligned against, in
linear, affine and convex gaps, at `-S -k 11 -w 5 -n 50` (12-16 windows a
read) here and at `-S -n 200` (one window a read: sim2k's reads share no
chained anchor at k = 19) in test_torch_windows_n200.py. Degenerate
windows ride in one batch with a read's real ones: an empty query (two
adjacent anchors) and a subgraph of only its two ends (gn = 2).
"""
import copy
import io
import os

import numpy as np
import pytest

from conftest import DATA_DIR

from abpoa_tpu import cli as jcli
from abpoa_tpu.align import dispatch as jdispatch
from abpoa_tpu.align.jax_backend import align_windows_jax
from abpoa_tpu.io.fastx import read_fastx
from abpoa_tpu.pipeline import Abpoa as JaxAbpoa
from abpoa_tpu.pipeline import msa as jax_msa
from abpoa_tpu_torch import cli as tcli
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align.dispatch import align_windows

GAPS = {"convex": [], "affine": ["-O", "4"], "linear": ["-O", "0"]}
SEEDS = {"n200": ["-S", "-n", "200"], "k11": ["-S", "-k", "11", "-w", "5", "-n", "50"]}
_CAPTURED = {}


def _captured(seeds: str, gap: str):
    """(JAX Params, port Params, [(graph, windows)] of reads 0-4) of the
    JAX CLI's seeded route on sim2k's first 5 reads: each read's windows
    with a copy of the graph they were aligned against."""
    key = (seeds, gap)
    if key not in _CAPTURED:
        args = [os.path.join(DATA_DIR, "sim2k.fa"), *SEEDS[seeds], *GAPS[gap]]
        jabpt = jcli.args_to_params(
            jcli.build_parser().parse_args(args + ["--device", "numpy"])).finalize()
        tabpt = tcli.args_to_params(
            tcli.build_parser().parse_args(args + ["--device", "cpu"])).finalize()
        caught = []
        real = jdispatch.align_windows

        def record(g, abpt, windows):
            caught.append((copy.deepcopy(g),
                           [(b, e, q.copy()) for b, e, q in windows]))
            return real(g, abpt, windows)

        jdispatch.align_windows = record
        try:
            jax_msa(JaxAbpoa(), jabpt, read_fastx(args[0])[:5], io.StringIO())
        finally:
            jdispatch.align_windows = real
        _CAPTURED[key] = (jabpt, tabpt, caught)
    return _CAPTURED[key]


def _assert_windows_equal(jabpt, tabpt, jg, windows):
    """Both packages align `windows` against copies of graph jg: results
    and band arrays equal."""
    jg = copy.deepcopy(jg)
    tg = convert.graph_from_numpy(convert.graph_to_numpy(jg))
    want = align_windows_jax(jg, jabpt, windows)
    got = align_windows(tg, tabpt, windows)
    assert len(got) == len(want) == len(windows)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.best_score == b.best_score, k
        assert a.cigar == b.cigar, k
    np.testing.assert_array_equal(tg.node_id_to_max_pos_left,
                                  jg.node_id_to_max_pos_left)
    np.testing.assert_array_equal(tg.node_id_to_max_pos_right,
                                  jg.node_id_to_max_pos_right)
    return got


def check_reads_2_to_4(seeds: str, gap: str) -> list:
    """Reads 2-4's windows of the `seeds` run in `gap`: equal; returns the
    windows a read."""
    jabpt, tabpt, caught = _captured(seeds, gap)
    sizes = []
    for jg, windows in caught[2:5]:
        assert jg.node_n > 2
        _assert_windows_equal(jabpt, tabpt, jg, windows)
        sizes.append(len(windows))
    return sizes


@pytest.mark.parametrize("gap", list(GAPS))
def test_align_windows_equals_jax(gap):
    assert min(check_reads_2_to_4("k11", gap)) >= 10


@pytest.mark.parametrize("gap", list(GAPS))
def test_degenerate_windows_equal_jax(gap):
    """Read 4's windows, batched with an empty query on the first window's
    subgraph and a window of only its two ends."""
    jabpt, tabpt, caught = _captured("k11", gap)
    jg, windows = caught[4]
    b0, e0, q0 = windows[0]
    i2n = jg.index_to_node_id
    pair = next((int(i2n[i]), int(i2n[i + 1])) for i in range(1, jg.node_n - 2)
                if int(i2n[i + 1]) in jg.nodes[int(i2n[i])].out_ids)
    extra = [(b0, e0, q0[:0]), (*pair, q0[:7])]
    reads = banded.stats["reads"]
    got = _assert_windows_equal(jabpt, tabpt, jg, windows + extra)
    assert banded.stats["reads"] == reads + 1  # one batch
    assert got[-2].cigar == [] or all(c & 0xF == 2 for c in got[-2].cigar)


def test_no_windows_and_empty_graph():
    jabpt, tabpt, caught = _captured("k11", "convex")
    assert align_windows(convert.graph_from_numpy(convert.graph_to_numpy(
        caught[2][0])), tabpt, []) == []
    empty = caught[0][0]
    assert empty.node_n == 2 and caught[0][1] == []
    from abpoa_tpu_torch.graph import POAGraph
    res = align_windows(POAGraph(), tabpt, [(0, 1, np.zeros(3, np.uint8))] * 2)
    assert [r.cigar for r in res] == [[], []]
