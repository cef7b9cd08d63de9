"""The PyTorch port's banded DP kernel against the JAX package's Pallas kernel.

`banded_dp_torch` (the plain version of the CUDA kernel, and the CPU path of
the `banded_dp` wrapper) must equal `pallas_banded_dp` run in interpret mode
on the same tables, on every output: five int32 planes, band bounds, final
mpl/mpr and the overflow flag, with tolerance 0. Tables come from real
mid-run graphs of tests/data fixtures, including the `-s` retry's
re-seeded launch and a source with several successors. The CUDA kernel
itself is compared with the plain version on the card in
test_torch_banded_shapes.py (marked `cuda`, skipped without one).
"""
import os

import numpy as np
import pytest
import torch

from abpoa_tpu.align.pallas_kernel import pallas_banded_dp
from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
from abpoa_tpu_torch.align.tables import initial_band_width
from abpoa_tpu_torch.kernels import build

from test_torch_banded_shapes import (OUT_NAMES, graph_and_query, inputs,
                                      params, reseeded, tensors)


def _pallas(args, W):
    (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0,
     qp_pad, row0) = args
    R = base.shape[0]
    out = pallas_banded_dp(
        scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0,
        qp_pad, row0[0:1], row0[1:2], row0[2:3],
        R=R, W=W, P=pre_idx.shape[1], O=out_idx.shape[1], D=64,
        Qp=qp_pad.shape[1] - W, interpret=True)
    out = [np.array(x) for x in out]
    for k in range(5):  # row 0 comes from the host (pallas_backend.py:202)
        out[k][0] = row0[k]
    return out


CASES = [
    # (fixture, reads in the graph, forced W or None)
    ("seq.fa", 5, None),
    ("seq.fa", 8, None),
    ("sim2k.fa", 2, None),
    ("sim2k.fa", 3, None),
    ("sim2k.fa", 2, 64),   # band wider than W: ok == 0 on both sides
]


@pytest.mark.parametrize("fa,n_graph,force_w", CASES)
def test_banded_dp_torch_equals_pallas(fa, n_graph, force_w):
    abpt = params()
    g, query = graph_and_query(fa, n_graph, abpt)
    W = force_w or initial_band_width(abpt, len(query))
    _, args = inputs(abpt, g, query, W)
    got = _assert_plain_equals_pallas(args, W)
    assert int(got[7][0]) == (0 if force_w else 1)


def _assert_plain_equals_pallas(args, W):
    want = _pallas(args, W)
    got = banded_dp_torch(*tensors(args))
    for name, a, b in zip(OUT_NAMES, got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    return got


@pytest.mark.parametrize("fa,n_graph,force_w", [
    ("rcmix.fa", 3, None),
    ("seq.fa", 5, None),
    ("sim2k.fa", 2, 128),  # band wider than W: ok == 0 on both sides
])
def test_banded_dp_torch_equals_pallas_reseeded(fa, n_graph, force_w):
    """The `-s` retry's launch: seeds mpl0/mpr0 are the forward launch's
    final mpl/mpr, not the neutral pair of a fresh sort."""
    abpt = params()
    g, rc = reseeded(fa, n_graph, abpt)
    W = force_w or initial_band_width(abpt, len(rc))
    t, args = inputs(abpt, g, rc, W)
    rows = slice(1, t.gn)
    seeded = (t.mpl0[rows] != t.gn) & (t.mpl0[rows] != 1)
    assert seeded.mean() > 0.5, "the seeds are not the last launch's"
    got = _assert_plain_equals_pallas(args, W)
    assert int(got[7][0]) == (0 if force_w else 1)


@pytest.mark.parametrize("fa,n_graph", [("rcmix.fa", 2), ("seq.fa", 3)])
def test_banded_dp_torch_equals_pallas_source_fanout(fa, n_graph):
    """A source with several successors: each is seeded with 1 through
    mpl0/mpr0 (row 0 pushes nothing)."""
    abpt = params()
    g, query = graph_and_query(fa, n_graph, abpt)
    assert len(g.nodes[0].out_ids) >= 2
    W = initial_band_width(abpt, len(query))
    _, args = inputs(abpt, g, query, W)
    assert int(_assert_plain_equals_pallas(args, W)[7][0]) == 1


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    abpt = params()
    g, query = graph_and_query("seq.fa", 4, abpt)
    W = initial_band_width(abpt, len(query))
    _, args = inputs(abpt, g, query, W)
    ts = tensors(args)
    before = banded_dp.launches
    got = banded_dp(*ts)
    want = banded_dp_torch(*ts)
    assert banded_dp.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _cpu_args():
    abpt = params()
    g, query = graph_and_query("seq.fa", 3, abpt)
    _, args = inputs(abpt, g, query, 256)
    return tensors(args)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "row0"])
def test_wrapper_rejects_badinputs(fault):
    ts = _cpu_args()
    if fault == "dtype":
        ts[1] = ts[1].to(torch.int64)
    elif fault == "contiguity":
        R, P = ts[2].shape
        wide = torch.zeros(R, P + 1, dtype=torch.int32)
        wide[:, :P] = ts[2]
        ts[2] = wide[:, :P]
    elif fault == "shape":
        ts[3] = ts[3][:-1].contiguous()
    else:
        ts[10] = ts[10][:3].contiguous()
    with pytest.raises((TypeError, ValueError)):
        banded_dp(*ts)


def test_kernel_build_is_keyed_by_sources():
    srcs = build.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "backtrack.cu", "backtrack_windows.cu", "fuse_alignment.cu",
        "fused_dp.cu", "topo_sort.cu", "unbanded_dp.cu"]
    path = build.library_path()
    assert path == build.library_path()
    assert os.path.dirname(path).endswith(os.path.join("build", "abpoa_tpu_torch"))
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
