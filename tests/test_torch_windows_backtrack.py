"""Kernel X1w's plain version (`backtrack_windows_torch`, the best cell and
the walk of each window of a B2 launch) against the JAX package's packed
output of `_dp_full_batch` (`device_backtrack` vmapped with `_dp_full`'s
best-cell pick), window by window, tolerance 0: the 11-int header
[n_ops, fin_i, fin_j, n_aln, n_match, start_i, start_j, err, best_score,
best_i, best_j], the final mpl/mpr of the window's rows and the op stream.

The windows are those the JAX CLI's seeded route aligns for reads 2-4 of
tests/data/sim2k.fa at `-S -k 11 -w 5 -n 50` (test_torch_windows.py's
capture), in linear, affine and convex gaps, on the port's native graph
carried across from the captured graph (and on its Python graph in convex
gaps); a first launch at W = 32 sends windows through the relaunch, and a
read aligned whole is a one-window launch.
"""
import copy
import os

import numpy as np
import pytest

from conftest import DATA_DIR

from abpoa_tpu.align import jax_backend
from abpoa_tpu.io.fastx import read_fastx
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align.backtrack_kernel import HEADER
from abpoa_tpu_torch.align.tables import build_row_tables, initial_band_width
from test_torch_windows import GAPS, _captured


def _jax_packed(jabpt, jg, windows) -> list:
    """Per window (header, mpl, mpr, ops) of JAX's packed output."""
    rows = []
    real = jax_backend._result_from_packed

    def record(g, abpt, packed, snap, R, max_ops):
        gn = snap["gn"]
        n_ops = int(packed[0])
        rows.append((packed[:HEADER].copy(),
                     packed[HEADER: HEADER + gn].copy(),
                     packed[HEADER + R: HEADER + R + gn].copy(),
                     packed[HEADER + 2 * R:].reshape(max_ops, 2)[:n_ops].copy()))
        return real(g, abpt, packed, snap, R, max_ops)

    jax_backend._result_from_packed = record
    try:
        jax_backend.align_windows_jax(copy.deepcopy(jg), jabpt, windows)
    finally:
        jax_backend._result_from_packed = real
    return rows


def _port_packed(tabpt, tg, windows, W) -> tuple:
    """Per window (header, mpl, mpr, ops) of X1w's plain version over the
    B2 launches of `banded.align_windows_banded`'s loop from band width W;
    and the number of launches."""
    tabs = [build_row_tables(tg, b, e) for b, e, _ in windows]
    queries = [q for _, _, q in windows]
    todo, got, launches = list(range(len(windows))), {}, 0
    while todo:
        launches += 1
        args, out = banded.run_windows(tabpt, [tabs[i] for i in todo],
                                       [queries[i] for i in todo], W)
        ok = out[7].tolist()
        slots = [k for k in range(len(todo)) if ok[k]]
        if slots:
            packed, layout = banded.walk_windows(
                tabpt, args, out, [tabs[i] for i in todo],
                [queries[i] for i in todo], slots)
            buf = packed.numpy()
            for k, (h, b, o, _) in zip(slots, layout):
                gn = tabs[todo[k]].gn
                n_ops = int(buf[h])
                got[todo[k]] = (buf[h: h + HEADER], buf[b: b + gn],
                                buf[b + gn: b + 2 * gn],
                                buf[o: o + 2 * n_ops].reshape(n_ops, 2))
        todo = [i for k, i in enumerate(todo) if not ok[k]]
        W = banded.next_band_width(W, max((len(queries[i]) for i in todo),
                                          default=0))
    return [got[i] for i in range(len(windows))], launches


def _check(jabpt, tabpt, jg, windows, engine: str, W=None) -> int:
    a = convert.graph_to_numpy(jg)
    tg = (convert.native_graph_from_numpy(a) if engine == "native"
          else convert.graph_from_numpy(a))
    want = _jax_packed(jabpt, jg, windows)
    W = W or max(initial_band_width(tabpt, len(q)) for _, _, q in windows)
    got, launches = _port_packed(tabpt, tg, windows, W)
    assert len(got) == len(want) == len(windows)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[0].tolist() == w[0].tolist(), (k, "header")
        assert g[0][7] == 0  # err
        for name, x, y in zip(("mpl", "mpr", "ops"), g[1:], w[1:]):
            np.testing.assert_array_equal(x, y, err_msg=f"window {k}: {name}")
    return launches


@pytest.mark.parametrize("gap", list(GAPS))
def test_windows_equal_jax_packed(gap):
    jabpt, tabpt, caught = _captured("k11", gap)
    for jg, windows in caught[2:5]:
        assert len(windows) >= 10
        assert _check(jabpt, tabpt, jg, windows, "native") == 1


def test_windows_on_the_python_graph_equal_jax_packed():
    jabpt, tabpt, caught = _captured("k11", "convex")
    jg, windows = caught[3]
    _check(jabpt, tabpt, jg, windows, "python")


@pytest.mark.parametrize("gap", list(GAPS))
def test_relaunched_windows_equal_jax_packed(gap):
    jabpt, tabpt, caught = _captured("k11", gap)
    jg, windows = caught[4]
    assert _check(jabpt, tabpt, jg, windows, "native", W=32) >= 2


@pytest.mark.parametrize("gap", list(GAPS))
def test_one_window_read_equals_jax_packed(gap):
    """Read 5 aligned whole against read 4's graph: the per-read route's
    launch of one window (and its relaunch from W = 32)."""
    jabpt, tabpt, caught = _captured("k11", gap)
    jg = caught[4][0]
    rec = read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))[5]
    q = tabpt.char_to_code[np.frombuffer(rec.seq.encode(), np.uint8)].astype(np.uint8)
    assert _check(jabpt, tabpt, jg, [(0, 1, q)], "native") == 1
    assert _check(jabpt, tabpt, jg, [(0, 1, q)], "native", W=32) >= 2
