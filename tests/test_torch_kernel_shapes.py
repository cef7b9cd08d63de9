"""The shapes the Hopper designs of kernels B1/B3 and X1 rely on.

- The fused loop's predecessor and successor tables are transposes over
  rows 1..gn-2 on every state the DP sees (after capacity growth, a Kahn
  repair, the `-s` rescue, aligned groups): the precondition of B1 pulling
  each row's band from its predecessors instead of pushing it to its
  successors.
- `computed_rows`: the plane rows the kernel defines.
- `launch_shape`: the block, ring depth and shared memory the wrapper picks
  stay inside Hopper's limits for every width the kernel takes.
- `backtrack_torch` equals JAX's `_backtrack_w` on a synthetic graph with
  P = 64 predecessor slots whose first hit sits in slot 40.
Every comparison is exact. The CUDA kernels are held against their plain
versions on the same cases on the card in test_torch_cuda_twins.py, which
imports no JAX.
The far-predecessor cases against Pallas are in test_torch_fused_dp.py,
whose one Pallas subprocess runs them.
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import jax.numpy as jnp

import abpoa_tpu.align.fused_loop as jfl
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.backtrack_kernel import backtrack_torch
from abpoa_tpu_torch.align.fused_dp_kernel import (MAX_W, SMEM_LIMIT,
                                                   computed_rows, launch_shape)
from abpoa_tpu_torch.io.fastx import read_fastx

from test_torch_cuda_twins import _wide_case, encode, make_params

torch.set_num_threads(1)

GAPS = {"convex": {}, "affine": {"gap_open2": 0},
        "linear": {"gap_open1": 0, "gap_open2": 0}}


# ---- the pre/out transposition ----------------------------------------------

def _assert_transposed(tables, gn: int):
    base_packed, pre_idx, pre_cnt, out_idx, out_cnt, _ = [t.numpy() for t in tables]
    pushed = {(r, int(t)) for r in range(1, gn - 1)
              for t in out_idx[r, :out_cnt[r]]}
    pulled = {(int(p), t) for t in range(1, gn)
              for p in pre_idx[t, :pre_cnt[t]] if 1 <= p <= gn - 2}
    assert pushed == pulled
    assert all(p < t for p, t in pulled)  # the order is topological
    src_out = {t for t in range(1, gn) if 0 in pre_idx[t, :pre_cnt[t]]}
    assert src_out == {t for t in range(1, gn) if base_packed[t] & 0x100}


TRANSPOSE_RUNS = {
    "seq-growth": ("seq.fa", {}, (64, 2, 2, 32)),
    "sim2k-kahn": ("sim2k.fa", {}, None),
    "rcmix-amb": ("rcmix.fa", {"amb_strand": True}, None),
    "heter-groups": ("heter.fa", {}, None),
}


@pytest.mark.parametrize("name", list(TRANSPOSE_RUNS))
def test_tables_are_transposes(name, monkeypatch):
    fa, kw, caps = TRANSPOSE_RUNS[name]
    abpt = make_params(**kw)
    seqs = [encode(abpt, r.seq) for r in read_fastx(os.path.join(DATA_DIR, fa))]
    if fa == "sim2k.fa":
        seqs = seqs[:12]  # the first Kahn repair comes within 12 reads
    real = tfl._build_tables
    seen = []

    def checked(g, order, n2i, remain):
        tables = real(g, order, n2i, remain)
        _assert_transposed(tables, int(g.node_n))
        seen.append(int(g.node_n))
        return tables

    monkeypatch.setattr(tfl, "_build_tables", checked)
    tfl.reset_stats()
    tfl.progressive_poa_fused(seqs, [np.ones(len(s), dtype=np.int64) for s in seqs],
                              abpt, init_caps=caps)
    assert len(seen) >= len(seqs) - 1
    if caps:
        assert tfl.stats["grow"], "no capacity growth"
    if fa == "sim2k.fa":
        assert tfl.stats["kahn"] > 0
    if kw.get("amb_strand"):
        assert tfl.stats["rc_reads"] > 0


# ---- computed rows --------------------------------------------------------

def test_computed_rows_stops_at_the_overflow_row():
    beg = torch.tensor([0, 0, 0, 10, 0, 0], dtype=torch.int32)
    end = torch.tensor([5, 8, 300, 20, 0, 0], dtype=torch.int32)
    assert computed_rows(beg, end, torch.tensor([0]), 6, 128) == 3
    assert computed_rows(beg, end, torch.tensor([1]), 6, 128) == 5


# ---- launch shapes ---------------------------------------------------------

@pytest.mark.parametrize("W", [1, 100, 128, 512, 1000, 2048, 8192, MAX_W])
@pytest.mark.parametrize("gap", list(GAPS))
def test_launch_shape_fits_hopper(W, gap):
    gap_mode = make_params(**GAPS[gap]).gap_mode
    for P in (1, 8, 16, 64, 256):
        s = launch_shape(W, P, gap_mode)
        assert 0 < s["smem"] <= SMEM_LIMIT
        assert s["depth"] >= 0 and s["depth"] & (s["depth"] - 1) == 0
        assert s["depth"] != 1
        assert 1 <= s["warps"] <= 32 and s["cpt"] <= 16
        assert s["warps"] * 32 * s["cpt"] >= W
    if W == 512 and gap == "convex":  # the headline's shape keeps a deep ring
        assert launch_shape(W, 16, gap_mode)["depth"] >= 32


def test_launch_shape_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        launch_shape(MAX_W + 1, 8, C.CONVEX_GAP)
    with pytest.raises(ValueError):
        launch_shape(0, 8, C.CONVEX_GAP)
    with pytest.raises(ValueError):
        launch_shape(2048, 8, C.CONVEX_GAP, warps=1)  # 32 columns a thread
    with pytest.raises(ValueError):
        launch_shape(512, 8, C.CONVEX_GAP, warps=33)
    with pytest.raises(ValueError):
        launch_shape(512, 20000, C.CONVEX_GAP)  # the tables alone pass 227 KB
    assert launch_shape(MAX_W, 8, C.CONVEX_GAP)["depth"] == 0


# ---- a backtrack over 64 predecessor slots ---------------------------------

@pytest.mark.parametrize("gap", list(GAPS))
def test_backtrack_p64_matches_jax(gap):
    abpt, args, bta, kw = _wide_case(gap)
    ops, res = backtrack_torch(*bta, **kw)
    H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed, query, mat, sc = bta
    assert pre_idx.shape[1] == 64
    pre_msk = np.arange(64)[None, :] < pre_cnt.numpy()[:, None]
    bi, bj, e1, oe1, e2, oe2, inf, _ = sc.tolist()
    want = jfl._backtrack_w(
        *[jnp.asarray(t.numpy()) for t in (H, E1, E2, F1, F2, beg, end, pre_idx)],
        jnp.asarray(pre_msk), jnp.asarray(base_packed.numpy() & 0xFF),
        jnp.asarray(query.numpy()), jnp.asarray(mat.numpy()), jnp.int32(bi),
        jnp.int32(bj), *[jnp.int32(x) for x in (e1, oe1, e2, oe2, inf)], **kw)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want[0]))
    assert res.tolist() == [int(np.asarray(x)) for x in want[1:]]
    # matches along the chain (rows 42..) took predecessor slot 40
    n = int(res[0])
    rows = ops[:n, 1].tolist()
    steps = list(zip(ops[:n, 0].tolist(), rows, rows[1:]))
    assert any(op == 0 and r >= 42 and nxt == r - 1 for op, r, nxt in steps)
    assert int(res[5]) == 0
