"""The PyTorch port's banded DP kernel against the JAX package's Pallas kernel.

`banded_dp_torch` (the plain version of the CUDA kernel, and the CPU path of
the `banded_dp` wrapper) must equal `pallas_banded_dp` run in interpret mode
on the same tables, on every output: five int32 planes, band bounds, final
mpl/mpr and the overflow flag, with tolerance 0. Tables come from real
mid-run graphs of tests/data fixtures. The CUDA kernel itself is compared
with the plain version on the card (marked `cuda`, skipped without one).
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu.align.pallas_kernel import pallas_banded_dp
from abpoa_tpu_torch.align import banded_kernel
from abpoa_tpu_torch.align.banded import align_sequence_to_subgraph
from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
from abpoa_tpu_torch.align.tables import (build_row_tables, initial_band_width,
                                          query_tables)
from abpoa_tpu_torch.graph import POAGraph
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.kernels import build
from abpoa_tpu_torch.params import Params


def _params(device="cpu", **kw):
    abpt = Params(device=device)
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


def _encode(abpt, rec):
    return abpt.char_to_code[np.frombuffer(rec.seq.encode(), dtype=np.uint8)].astype(np.uint8)


def _graph_and_query(fa, n_graph, abpt):
    """A graph of the first n_graph reads (built by the port on the CPU) and
    the next read."""
    recs = read_fastx(os.path.join(DATA_DIR, fa))
    g = POAGraph()
    for i in range(n_graph):
        q = _encode(abpt, recs[i])
        cigar = []
        if g.node_n > 2:
            cigar = align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    return g, _encode(abpt, recs[n_graph])


def _inputs(abpt, g, query, W):
    t = build_row_tables(g, 0, 1)
    q = query_tables(abpt, t, query, W)
    return t, [q["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
               t.out_cnt, t.remain, t.mpl0, t.mpr0, q["qp_pad"], q["row0"]]


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
    abpt = _params()
    g, query = _graph_and_query(fa, n_graph, abpt)
    W = force_w or initial_band_width(abpt, len(query))
    _, args = _inputs(abpt, g, query, W)
    want = _pallas(args, W)
    got = banded_dp_torch(*[torch.from_numpy(np.ascontiguousarray(a, np.int32))
                            for a in args])
    names = ["H", "E1", "E2", "F1", "F2", "begend", "mplr", "ok"]
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert int(got[7][0]) == (0 if force_w else 1)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    abpt = _params()
    g, query = _graph_and_query("seq.fa", 4, abpt)
    W = initial_band_width(abpt, len(query))
    _, args = _inputs(abpt, g, query, W)
    ts = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in args]
    before = banded_dp.launches
    got = banded_dp(*ts)
    want = banded_dp_torch(*ts)
    assert banded_dp.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _cpu_args():
    abpt = _params()
    g, query = _graph_and_query("seq.fa", 3, abpt)
    _, args = _inputs(abpt, g, query, 256)
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in args]


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "row0"])
def test_wrapper_rejects_bad_inputs(fault):
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
        "backtrack.cu", "banded_dp.cu", "fused_dp.cu", "topo_sort.cu"]
    path = build.library_path()
    assert path == build.library_path()
    assert os.path.dirname(path).endswith(os.path.join("build", "abpoa_tpu_torch"))
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); run with chip_smoke.py")
    abpt = _params(device="cuda")
    cpu = _params()
    g, query = _graph_and_query("sim2k.fa", 3, cpu)
    for W in (64, initial_band_width(abpt, len(query)), 1536):
        _, args = _inputs(abpt, g, query, W)
        ts = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda() for a in args]
        before = banded_kernel.banded_dp.launches
        got = banded_dp(*ts)
        torch.cuda.synchronize()
        assert banded_kernel.banded_dp.launches == before + 1
        want = banded_dp_torch(*ts)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
