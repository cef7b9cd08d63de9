"""What kernel B2's Hopper design (the seeded instantiation of B1's kernel)
relies on, with no JAX in the process.

- `build_row_tables` gives predecessor and successor tables that are
  transposes over rows 1..gn-2, and row 0 pushes nothing: the precondition
  of B2 pulling each row's band from its predecessors where Pallas pushes
  it to the successors. Checked on every table the per-read route builds
  on seq.fa, sim2k and rcmix (`-s`, so with re-seeded launches).
- `launch_shape(..., seeded=True)`: the block, ring depth and shared memory
  stay inside Hopper's limits for every width B2 takes (64..32768).
- The F chains' int32 scan holds at W = 32768 with the per-read route's
  -inf.
- The SASS check that keeps B1's code unchanged by B2's seeded flag
  (`kernels/sass_diff.py`) reads the functions it should.
The CUDA kernel is held against its plain version on the card (marked
`cuda`, skipped without one). This file imports no JAX: the card machine
has none. The comparisons with Pallas are in test_torch_banded.py.
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import banded, banded_kernel
from abpoa_tpu_torch.align.banded import align_sequence_to_subgraph
from abpoa_tpu_torch.align.banded_kernel import banded_dp, banded_dp_torch
from abpoa_tpu_torch.align.fused_dp_kernel import (MAX_W_SEEDED, SMEM_LIMIT,
                                                   computed_rows,
                                                   launch_shape)
from abpoa_tpu_torch.align.oracle import INT32_MIN, dp_inf_min
from abpoa_tpu_torch.align.tables import (build_row_tables, initial_band_width,
                                          query_tables)
from abpoa_tpu_torch.graph import POAGraph
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.pipeline import Abpoa, _ingest_records, _rc_encode, poa

INT32_MAX = 2 ** 31 - 1
OUT_NAMES = ["H", "E1", "E2", "F1", "F2", "begend", "mplr", "ok", "ext"]


def params(device="cpu", **kw):
    abpt = Params(device=device)
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


def encode(abpt, rec):
    return abpt.char_to_code[np.frombuffer(rec.seq.encode(), dtype=np.uint8)].astype(np.uint8)


def graph_and_query(fa, n_graph, abpt):
    """A graph of the first n_graph reads (built by the port's per-read
    route on abpt's device) and the next read."""
    recs = read_fastx(os.path.join(DATA_DIR, fa))
    g = POAGraph()
    for i in range(n_graph):
        q = encode(abpt, recs[i])
        cigar = []
        if g.node_n > 2:
            cigar = align_sequence_to_subgraph(g, abpt, 0, 1, q).cigar
        g.add_alignment(abpt, q, None, cigar, True)
    g.topological_sort(abpt)
    return g, encode(abpt, recs[n_graph])


def reseeded(fa, n_graph, abpt):
    """The `-s` retry's launch (pipeline.poa): the next read aligned
    forward, which writes its mpl/mpr back into the unsorted graph, and its
    reverse complement, whose tables are seeded from them."""
    g, query = graph_and_query(fa, n_graph, abpt)
    align_sequence_to_subgraph(g, abpt, 0, 1, query)
    return g, _rc_encode(query)


def inputs(abpt, g, query, W):
    """banded_dp's inputs (numpy) for `query` against the whole graph."""
    t = build_row_tables(g, 0, 1)
    q = query_tables(abpt, t, query, W)
    return t, [q["scalars"], t.base, t.pre_idx, t.pre_cnt, t.out_idx,
               t.out_cnt, t.remain, t.mpl0, t.mpr0, q["qp_pad"], q["row0"]]


def tensors(args, dev="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in args]


# ---- the pre/out transposition of the per-read tables ---------------------

def assert_transposed(t):
    """Pallas's pushes (rows 1..gn-2 to their out lists) reach exactly the
    (row, target) pairs the kernel pulls (each row's predecessors in
    1..gn-2); row 0 pushes nothing and its successors are seeded with 1."""
    gn = t.gn
    pushed = {(r, int(x)) for r in range(1, gn - 1)
              for x in t.out_idx[r, :t.out_cnt[r]]}
    pulled = {(int(p), r) for r in range(1, gn)
              for p in t.pre_idx[r, :t.pre_cnt[r]] if 1 <= p <= gn - 2}
    assert pushed == pulled
    assert all(p < r for p, r in pulled)  # the order is topological
    assert t.out_cnt[0] == 0 and not t.out_cnt[gn - 1:].any()
    src_out = [r for r in range(1, gn) if 0 in t.pre_idx[r, :t.pre_cnt[r]]]
    assert src_out and all(t.mpl0[r] == t.mpr0[r] == 1 for r in src_out)
    assert (t.pre_cnt[1:gn] > 0).all() and not t.pre_cnt[gn:].any()


TRANSPOSE_RUNS = {"seq": ("seq.fa", 10, {}), "sim2k": ("sim2k.fa", 4, {}),
                  "rcmix-s": ("rcmix.fa", 8, {"amb_strand": True})}


@pytest.mark.parametrize("name", list(TRANSPOSE_RUNS))
def test_row_tables_are_transposes(name, monkeypatch):
    fa, n, kw = TRANSPOSE_RUNS[name]
    abpt = params(**kw)
    real = banded.build_row_tables
    seen = []

    def checked(g, beg, end, abpt=None):
        t = real(g, beg, end, abpt)
        assert_transposed(t)
        seen.append(t.gn)
        return t

    monkeypatch.setattr(banded, "build_row_tables", checked)
    ab = Abpoa()
    seqs, weights = _ingest_records(ab, abpt, read_fastx(os.path.join(DATA_DIR, fa))[:n])
    poa(ab, abpt, seqs, weights, 0)
    assert len(seen) >= n - 1
    if kw:  # some reads were retried as their reverse complement
        assert len(seen) > n - 1 and any(ab.is_rc)


# ---- launch shapes ---------------------------------------------------------

@pytest.mark.parametrize("W", [64, 256, 512, 1536, 4096, 16384, 16385, 20001,
                               MAX_W_SEEDED])
def test_b2_launch_shape_fits_hopper(W):
    for P in (1, 4, 16, 64):
        s = launch_shape(W, P, C.CONVEX_GAP, seeded=True)
        assert 0 < s["smem"] <= SMEM_LIMIT
        assert s["depth"] >= 0 and s["depth"] & (s["depth"] - 1) == 0
        assert s["depth"] != 1
        assert 1 <= s["block_warps"] <= 32 and s["cpt"] <= 32
        assert s["block_warps"] * 32 * s["cpt"] >= W
        if W > 16384:  # past B1's widest: 32 columns a thread, no ring
            assert s["cpt"] == 32 and s["depth"] == 0
    # the headline's shape keeps a deep ring
    assert launch_shape(512, 16, C.CONVEX_GAP, seeded=True)["depth"] >= 32
    # B2's staged table rows carry mpl0/mpr0: one int a row more than B1's
    assert (launch_shape(512, 16, C.CONVEX_GAP, seeded=True)["smem"]
            == launch_shape(512, 16, C.CONVEX_GAP)["smem"] + 4 * 4)


def test_b2_launch_shape_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        launch_shape(MAX_W_SEEDED + 1, 8, C.CONVEX_GAP, seeded=True)
    with pytest.raises(ValueError):  # B1 stops at 16 columns a thread
        launch_shape(20001, 8, C.CONVEX_GAP)
    with pytest.raises(ValueError):
        launch_shape(20001, 8, C.CONVEX_GAP, warps=8, seeded=True)


@pytest.mark.parametrize("gaps", [{}, {"gap_open1": 8, "gap_ext1": 4},
                                  {"gap_open2": 40, "gap_ext2": 3}])
def test_f_chain_fits_int32_at_full_width(gaps):
    """The kernel scans the F chains in int32 (csrc/fused_dp.cu): every
    term A[k] + k * ext with A >= inf - oe must stay above INT32_MIN, and
    the largest, a full-length score plus W * ext, below INT32_MAX, at
    W = 32768 with the per-read route's -inf (query_tables)."""
    abpt = params(**gaps)
    inf = dp_inf_min(abpt)
    oe, ext = max(abpt.gap_oe1, abpt.gap_oe2), max(abpt.gap_ext1, abpt.gap_ext2)
    # the lowest value a row forms: an E update of a -inf predecessor
    assert inf - oe - ext > INT32_MIN
    W = MAX_W_SEEDED
    assert W * abpt.max_mat + W * ext < INT32_MAX
    # a prefix max at column j less j * ext is at least A[j] >= inf - oe
    A = np.full(W, inf - oe, dtype=np.int64)
    k = np.arange(W, dtype=np.int64)
    chain = np.maximum.accumulate(A + k * ext) - k * ext
    assert chain.min() >= inf - oe and (A + k * ext).max() < INT32_MAX


# ---- the kernel on the card -------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); run with chip_smoke.py")
    return torch.device("cuda")


def assert_kernel_equals_plain(got, want, gn):
    """Exact on the plane rows the kernel defines and on every other
    output."""
    W = want[0].shape[1]
    R = want[5].shape[0] // 2
    rows = computed_rows(want[5][:R], want[5][R:], want[7], gn, W)
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu(), b.cpu()
        if k < 5:
            a, b = a[:rows], b[:rows]
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=OUT_NAMES[k])


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version_on_card():
    dev = _card()
    cpu = params()
    g, query = graph_and_query("sim2k.fa", 3, cpu)
    for W in (64, initial_band_width(cpu, len(query)), 1536):
        t, args = inputs(cpu, g, query, W)
        ts = tensors(args, dev)
        before = banded_kernel.banded_dp.launches
        got = banded_dp(*ts)
        torch.cuda.synchronize()
        assert banded_kernel.banded_dp.launches == before + 1
        assert_kernel_equals_plain(got, banded_dp_torch(*ts), t.gn)


@pytest.mark.cuda
@pytest.mark.parametrize("fa,n_graph", [("rcmix.fa", 3), ("sim2k.fa", 2)])
def test_cuda_kernel_equals_plain_on_reseeded_launch(fa, n_graph):
    dev = _card()
    cpu = params()
    g, rc = reseeded(fa, n_graph, cpu)
    t, args = inputs(cpu, g, rc, initial_band_width(cpu, len(rc)))
    ts = tensors(args, dev)
    got = banded_dp(*ts)
    torch.cuda.synchronize()
    assert_kernel_equals_plain(got, banded_dp_torch(*ts), t.gn)


def test_sass_diff_reads_b1_functions_only():
    """The SASS check that keeps B1's code unchanged by B2's seeded flag
    (kernels/sass_diff.py) keys B1's functions by <CPT, GAP>, skips B2's,
    and ignores addresses and encodings."""
    from abpoa_tpu_torch.kernels.sass_diff import parse_b1

    def listing(name, addr):
        return (f"\t\tFunction : _ZN15fused_dp_kernel{name}Ev\n"
                f"\t.headerflags\t@\"EF_CUDA_SM90\"\n"
                f"        /*{addr}*/                   LDC R1, c[0x0][0x28] ;"
                f"                    /* 0x00000a00ff017b82 */\n"
                f"                                                          "
                f"                   /* 0x000fe20000000800 */\n")
    old = parse_b1(listing("ILi8ELi2EE", "0000") + listing("ILi1ELi0EE", "0000"))
    new = parse_b1(listing("ILi8ELi2ELb0EE", "0010")
                   + listing("ILi32ELi2ELb1EE", "0000"))
    assert sorted(old) == [(1, 0), (8, 2)] and sorted(new) == [(8, 2)]
    assert old[(8, 2)] == new[(8, 2)] == ["LDC R1, c[0x0][0x28] ;"]
