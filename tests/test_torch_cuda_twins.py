"""The CUDA kernels B1/B3, B2, X1, X1w, S1 and K1 against their plain PyTorch
versions on the card, and the cases they share with the CPU tests.

This file imports no JAX, so the card machine, which has none, collects it.
The cases are the ones the CPU test files hold against the JAX package:
- B1/B3 (`fused_dp`): the kernel tables of mid-run graphs of
  tests/data/seq.fa, test.fa and sim2k.fa in every gap regime x align mode
  x plane width, a band overflow, and predecessors 70 rows back
  (`build_cases`; against Pallas in test_torch_fused_dp.py);
- X1 (`backtrack`): the planes of those cases, with the gap-placement flags
  (`BT_CASES`; against JAX in test_torch_fused_steps.py), and a synthetic
  graph with 64 predecessor slots (`_wide_case`; test_torch_kernel_shapes.py);
- B2 (`banded_dp`) in extend + Z-drop and `-G` mode, B2u (`unbanded_dp`,
  the whole-row windows) in local mode and without a band, at each of its
  cluster sizes (`chip_smoke.CLUSTER_CASES`), and X1w's local and `-G`
  walks (`chip_smoke.MODE_CASES`; against JAX in test_torch_modes.py and
  test_torch_modes_gaps.py); a window sent to the kernel of the other kind
  is refused;
- X1w (`backtrack_windows`): the windows of a seeded read of sim2k.fa in
  the three gap modes, some overflowed, and one whole-read window
  (against JAX in test_torch_windows_backtrack.py);
- K1 (`topo_sort`) on graphs of the fused loop (`topo_graph_cases`; against
  JAX in test_torch_fused_steps.py), and S1 as the loop runs it
  (`finish_fusion_`, in place, with and without the span update, each
  launch on fresh copies; against JAX in
  test_torch_finish_fusion.py). S1 and K1 on the graphs made for their
  traps are in test_torch_sort_twins.py;
- the K-lane chunk of the lockstep and map routes: a K-lane B2 launch
  and X1w's walk of it (against JAX in test_torch_dp_chunk.py), and the
  map route's GAF on the card == on the CPU (test_torch_map.py);
- the routes from a restored graph (`-i`; against JAX in
  test_torch_incremental.py): the per-read route, B2 from the restored
  graph, and the fused loop from the restored state, each equal to its CPU
  run, with B1 and B2 launched on their own routes only.
Every comparison is exact; B1/B3 are compared on the plane rows they compute.
Without a card every test here skips before its cases are built.

    pytest -m cuda tests/test_torch_cuda_twins.py    # on the card
"""
import copy
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import chip_smoke
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.backtrack_kernel import (backtrack, backtrack_lanes,
                                                    backtrack_torch)
from abpoa_tpu_torch.align.buckets import qp_rung
from abpoa_tpu_torch.align.edge_sort_kernel import (finish_fusion_,
                                                    finish_fusion_torch_)
from abpoa_tpu_torch.align.fused_dp_kernel import (computed_rows, fused_dp,
                                                   fused_dp_torch, launch_shape)
from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min
from abpoa_tpu_torch.align.topo_kernel import topo_sort, topo_sort_torch
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params

# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)

# ---- the cases ---------------------------------------------------------------

OUT_NAMES = ("H", "E1", "E2", "F1", "F2", "beg", "end", "ok", "ext")
IN_NAMES = ("scalars", "base_packed", "pre_idx", "pre_cnt", "out_idx",
            "out_cnt", "remain", "row0", "qp_pad")

GAPS = {"convex": {}, "affine": {"gap_open2": 0},
        "linear": {"gap_open1": 0, "gap_open2": 0}}
MODES = {"global": {}, "extend": {"align_mode": C.EXTEND_MODE, "zdrop": 5},
         "local": {"align_mode": C.LOCAL_MODE}}
GRID = [f"{g}-{m}-{w}" for g in GAPS for m in MODES
        for w in ("int16", "int32")]
EXTRA = ["overflow-convex-global-int32", "testfa-convex-global-int32",
         "testfa-linear-local-int16"]
HBM = ["hbm-convex-int32", "hbm-affine-int16"]
FAR = [f"far-{g}-{m}" for g in GAPS for m in ("global", "extend")]


def make_params(**kw) -> Params:
    abpt = Params(device="cpu")
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


def encode(abpt, seq: str) -> np.ndarray:
    return abpt.char_to_code[np.frombuffer(seq.encode(), dtype=np.uint8)].astype(np.uint8)


def port_state(fa: str, n_reads: int, abpt: Params, init_caps=None):
    """The port's fused-loop state after the first n_reads reads of fa
    (built on the CPU), and every read of fa encoded."""
    seqs = [encode(abpt, r.seq) for r in read_fastx(os.path.join(DATA_DIR, fa))]
    w = [np.ones(len(s), dtype=np.int64) for s in seqs[:n_reads]]
    tfl.progressive_poa_fused(seqs[:n_reads], w, abpt, init_caps=init_caps)
    return tfl.last_state, seqs


def kernel_inputs(abpt: Params, st, query: np.ndarray, W: int, plane16: bool,
                  local: bool) -> tuple:
    """B1's inputs for `query` against the state's graph, as the fused loop
    builds them."""
    tables = tfl._build_tables(st.g, st.order, st.n2i, st.remain)
    qlen = len(query)
    qp = np.zeros((abpt.m, qp_rung(qlen)), dtype=np.int32)
    qp[:, 1: qlen + 1] = abpt.mat[:, query]
    inf = dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN)
    return tfl.dp_inputs(abpt, st, tables, torch.from_numpy(qp), qlen, W,
                         inf, local)


def _query(seqs) -> np.ndarray:
    """Read 7 of seq.fa with its last 15 bases replaced by random ones, so
    extend mode's Z-drop fires."""
    rng = np.random.default_rng(5)
    q = seqs[6].copy()
    q[-15:] = rng.integers(0, 4, 15)
    return q


def build_cases() -> dict:
    """name -> (inputs, statics, query) where statics = dict(gap_mode,
    plane16, extend, zdrop_on, local, hbm)."""
    cases = {}
    base = make_params()
    st, seqs = port_state("seq.fa", 6, base, init_caps=(256, 8, 8, 128))
    query = _query(seqs)
    for name in GRID + HBM:
        parts = name.split("-")
        hbm = parts[0] == "hbm"
        gap = parts[1] if hbm else parts[0]
        mode = "local" if hbm else parts[1]
        plane16 = parts[-1] == "int16"
        abpt = make_params(**GAPS[gap], **MODES[mode])
        args = kernel_inputs(abpt, st, query, 128, plane16, mode == "local")
        cases[name] = (args, dict(
            gap_mode=abpt.gap_mode, plane16=plane16,
            extend=mode == "extend", zdrop_on=mode == "extend",
            local=mode == "local", hbm=hbm), query)
    # a band wider than W: sim2k with a 100-column extra band at W = 128
    abpt = make_params(wb=100)
    st2, seqs2 = port_state("sim2k.fa", 2, abpt)
    args = kernel_inputs(abpt, st2, seqs2[2], 128, False, False)
    cases[EXTRA[0]] = (args, dict(gap_mode=abpt.gap_mode, plane16=False,
                                  extend=False, zdrop_on=False, local=False,
                                  hbm=False), seqs2[2])
    # test.fa: the graph of its first 3 reads and the 4th
    st3, seqs3 = port_state("test.fa", 3, base, init_caps=(256, 8, 8, 128))
    for name in EXTRA[1:]:
        _, gap, mode, width = name.split("-")
        abpt = make_params(**GAPS[gap], **MODES[mode])
        plane16 = width == "int16"
        args = kernel_inputs(abpt, st3, seqs3[3], 128, plane16, mode == "local")
        cases[name] = (args, dict(
            gap_mode=abpt.gap_mode, plane16=plane16, extend=False,
            zdrop_on=False, local=mode == "local", hbm=False), seqs3[3])
    # predecessors 70 rows back, in the seq.fa cases' table shapes, so the
    # Pallas child reuses those cases' compilations
    like = cases["convex-global-int32"][0]
    preds, bases, query = chip_smoke.synthetic_graph("far")
    for name in FAR:
        _, gap, mode = name.split("-")
        abpt = make_params(**GAPS[gap], **MODES[mode])
        args, _ = chip_smoke.synthetic_inputs(
            abpt, preds, bases, query, 128, False, False, P=like[2].shape[1],
            R=like[1].shape[0], O=like[4].shape[1])
        cases[name] = (args, dict(
            gap_mode=abpt.gap_mode, plane16=False, extend=mode == "extend",
            zdrop_on=mode == "extend", local=False, hbm=False), query)
    return cases


def _assert_equal(got, want, rows=None, skip=()):
    for k, (a, b) in enumerate(zip(got, want)):
        name = OUT_NAMES[k]
        if name in skip:
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if rows is not None and name in ("H", "E1", "E2", "F1", "F2", "beg", "end"):
            a, b = a[:rows], b[:rows]
        assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=name)


def _run_plain(case):
    args, s, _ = case
    return fused_dp_torch(*args, gap_mode=s["gap_mode"], plane16=s["plane16"],
                          extend=s["extend"], zdrop_on=s["zdrop_on"],
                          local=s["local"])


def make_run(abpt, seqs, st, W, plane16):
    """The loop's per-run constants for reads `seqs` at band width W."""
    from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min
    Qp = qp_rung(max(len(s) for s in seqs))
    mat = np.ascontiguousarray(abpt.mat.astype(np.int32))
    sp, wp, lens, qp = tfl._pad_read_set(
        seqs, [np.ones(len(s), dtype=np.int64) for s in seqs], Qp, mat, abpt.m)
    N = st.g.caps[0]
    return tfl._Run(abpt=abpt, seqs=torch.from_numpy(sp),
                    wgts=torch.from_numpy(wp), lens=lens.tolist(),
                    qp=torch.from_numpy(qp), mat=torch.from_numpy(mat), W=W,
                    max_ops=N + Qp + 8, plane16=plane16,
                    inf=dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN),
                    local=abpt.align_mode == C.LOCAL_MODE,
                    extend=abpt.align_mode == C.EXTEND_MODE,
                    zdrop_on=abpt.align_mode == C.EXTEND_MODE and abpt.zdrop > 0,
                    int16_limit=1 << 30)


def aligned_read(fa, n_graph, **kw):
    """A port state after n_graph reads of fa, the next read's forward op
    stream against it, and the loop constants."""
    abpt = make_params(**kw)
    st, seqs = port_state(fa, n_graph, abpt)
    run = make_run(abpt, seqs, st, 256, False)
    k = n_graph
    tables = tfl._build_tables(st.g, st.order, st.n2i, st.remain)
    fwd = tfl._align_strand(run, st, tables, run.seqs[k], run.qp[k],
                            run.lens[k])
    return abpt, st, run, k, fwd


BT_CASES = [(n, False, False) for n in GRID] + [
    ("convex-global-int16", True, False), ("convex-global-int16", False, True),
    ("convex-global-int32", True, True), ("affine-global-int32", True, True),
    ("linear-global-int16", True, True), ("convex-local-int32", False, True),
    ("convex-extend-int16", True, False)]


def _bt_inputs(case):
    args, s, q = case
    scalars, base_packed, pre_idx, pre_cnt = args[:4]
    H, E1, E2, F1, F2, beg, end, ok, ext = fused_dp_torch(
        *args, gap_mode=s["gap_mode"], plane16=s["plane16"],
        extend=s["extend"], zdrop_on=s["zdrop_on"], local=s["local"])
    sc = scalars.tolist()
    qlen, inf = sc[0], sc[3]
    n = torch.tensor([sc[8]], dtype=torch.int32)
    bi, bj, _ = tfl.best_cell(H, beg, end, pre_idx, pre_cnt, n, ext, qlen, inf,
                              s["extend"] or s["local"])
    Qp = args[8].shape[1] - H.shape[1]
    query = torch.zeros(Qp, dtype=torch.int32)
    query[:qlen] = torch.from_numpy(q.astype(np.int32))
    return (H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base_packed,
            query), (int(bi), int(bj)), sc, Qp


def topo_graph_cases():
    """name -> port DeviceGraph: fused-but-unsorted graphs (seq.fa; sim2k.fa,
    where rows move), a sorted mid-run graph with aligned groups (heter.fa)
    and a larger one (sim2k.fa)."""
    out = {}
    for name, fa, n in (("seq-fused-unsorted", "seq.fa", 6),
                        ("sim2k-fused-unsorted", "sim2k.fa", 3)):
        abpt, st, run, k, fwd = aligned_read(fa, n)
        fwd_op, fwd_arg, n_fwd = fwd[:3]
        out[name] = tfl._fuse_vectorized(
            st.g, fwd_op, fwd_arg, n_fwd, run.seqs[k], run.lens[k],
            run.wgts[k])[0]
    out["heter-sorted"] = port_state("heter.fa", 8, make_params())[0].g
    out["sim2k-sorted"] = port_state("sim2k.fa", 5, make_params())[0].g
    return out


def _topo_args(g):
    return (g.in_ids, g.in_w, g.out_ids, g.out_w, g.in_cnt, g.out_cnt,
            g.aligned, g.aligned_cnt, g.node_n.reshape(1))


def _wide_case(gap):
    abpt = make_params(**GAPS[gap])
    preds, bases, query = chip_smoke.synthetic_graph("wide")
    args, inf = chip_smoke.synthetic_inputs(abpt, preds, bases, query, 128,
                                            False, False, P=64)
    out = fused_dp_torch(*args, gap_mode=abpt.gap_mode, plane16=False)
    bta, max_ops = chip_smoke.bt_inputs(abpt, args, out, query, inf, False)
    kw = dict(max_ops=max_ops, gap_mode=abpt.gap_mode, gap_on_right=False,
              put_gap_at_end=False, local=False)
    return abpt, args, bta, kw


# ---- the kernels on the card ---------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _card_present():
    """Skip the module before any case is built when there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card():
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cases():
    return build_cases()


@pytest.fixture(scope="module")
def topo_graphs():
    return topo_graph_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRID + EXTRA)
def test_fused_dp_kernel_matches_plain_on_card(name, cases):
    dev = _card()
    args, s, _ = cases[name]
    kw = {k: v for k, v in s.items() if k != "hbm"}
    got = fused_dp(*[a.to(dev) for a in args], **kw)
    torch.cuda.synchronize()
    want = _run_plain(cases[name])
    # the kernel defines the plane rows 0..last computed only
    rows = computed_rows(want[5], want[6], want[7], int(args[0][8]),
                         args[7].shape[1])
    _assert_equal([g.cpu() for g in got], [w.numpy() for w in want], rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FAR)
def test_fused_dp_far_kernel_matches_plain_on_card(name, cases):
    dev = _card()
    args, s, _ = cases[name]
    assert launch_shape(128, args[2].shape[1], s["gap_mode"])["depth"] < 70
    kw = {k: v for k, v in s.items() if k != "hbm"}
    got = fused_dp(*[a.to(dev) for a in args], **kw)
    torch.cuda.synchronize()
    want = _run_plain(cases[name])
    rows = computed_rows(want[5], want[6], want[7], int(args[0][8]), 128)
    _assert_equal([g.cpu() for g in got], [w.numpy() for w in want], rows=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name,right,at_end", BT_CASES)
def test_backtrack_kernel_matches_plain_on_card(name, right, at_end, cases):
    dev = _card()
    planes_etc, (bi, bj), sc, Qp = _bt_inputs(cases[name])
    s = cases[name][1]
    mat = torch.from_numpy(make_params().mat.astype(np.int32))
    max_ops = planes_etc[0].shape[0] + Qp + 8
    bt_sc = torch.tensor([bi, bj, sc[4], sc[5], sc[6], sc[7], sc[3], max_ops],
                         dtype=torch.int32)
    kw = dict(max_ops=max_ops, gap_mode=s["gap_mode"], gap_on_right=right,
              put_gap_at_end=at_end, local=s["local"])
    want = backtrack_torch(*planes_etc, mat, bt_sc, **kw)
    got = backtrack(*[t.to(dev) for t in (*planes_etc, mat, bt_sc)], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seq-fused-unsorted", "heter-sorted",
                                  "sim2k-sorted"])
def test_topo_sort_kernel_matches_plain_on_card(name, topo_graphs):
    dev = _card()
    args = _topo_args(topo_graphs[name])
    want = topo_sort_torch(*args)
    got = topo_sort(*[t.to(dev).contiguous() for t in args])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("span", [False, True])
@pytest.mark.parametrize("name", ["seq-fused-unsorted", "sim2k-fused-unsorted",
                                  "heter-sorted", "sim2k-sorted"])
def test_finish_fusion_kernel_matches_plain_on_card(name, span, topo_graphs):
    dev = _card()
    g = topo_graphs[name]
    args = [t.clone() for t in (g.in_ids, g.in_w, g.out_ids, g.out_w,
                                g.in_cnt, g.out_cnt, g.node_n.reshape(1),
                                g.n_span)]
    gpu = [t.to(dev) for t in args]
    finish_fusion_(*gpu[:7], gpu[7] if span else None)
    finish_fusion_torch_(*args[:7], args[7] if span else None)
    torch.cuda.synchronize()
    for a, b in zip(gpu[:4] + gpu[7:], args[:4] + args[7:]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("gap", list(GAPS))
def test_wide_kernels_match_plain_on_card(gap):
    dev = _card()
    abpt, args, bta, kw = _wide_case(gap)
    got = fused_dp(*[a.to(dev) for a in args], gap_mode=abpt.gap_mode,
                   plane16=False)
    torch.cuda.synchronize()
    want = fused_dp_torch(*args, gap_mode=abpt.gap_mode, plane16=False)
    rows = computed_rows(want[5], want[6], want[7], int(args[0][8]), 128)
    for k in range(9):
        a, b = got[k].cpu(), want[k]
        if k < 5:
            a, b = a[:rows], b[:rows]
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=OUT_NAMES[k])
    ops, res = backtrack(*[t.to(dev) for t in bta], **kw)
    torch.cuda.synchronize()
    wops, wres = backtrack_torch(*bta, **kw)
    np.testing.assert_array_equal(ops.cpu().numpy(), wops.numpy())
    np.testing.assert_array_equal(res.cpu().numpy(), wres.numpy())


# ---- the routes from a restored graph (`-i`) -------------------------------------

def _cli_output(args, device):
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    import io
    buf = io.StringIO()
    ns = cli.build_parser().parse_args(args + ["--device", device])
    msa_from_file(Abpoa(), cli.args_to_params(ns).finalize(), ns.input, buf)
    return buf.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("flags,route", [(["-r", "1"], "per-read"),
                                         (["-r", "3"], "per-read"),
                                         ([], "fused")])
def test_restored_graph_routes_on_card_match_cpu(flags, route):
    """seq4.fa onto seq10.gfa's graph: with read-id outputs each new read is
    aligned by B2 (the per-read route), else the fused loop starts from the
    restored state; cuda gives the CPU's bytes."""
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    args = [os.path.join(DATA_DIR, "seq4.fa"), "-i",
            os.path.join(DATA_DIR, "seq10.gfa"), *flags]
    banded_dp.launches = fused_dp.launches = 0
    got = _cli_output(args, "cuda")
    b2, b1 = banded_dp.launches, fused_dp.launches
    assert got == _cli_output(args, "cpu")
    assert (b2 >= 2, b1 >= 2) == (route == "per-read", route == "fused")
    assert (b2 == 0) == (route == "fused") and (b1 == 0) == (route == "per-read")


@pytest.mark.cuda
@pytest.mark.parametrize("gap,flags", [("convex", []), ("affine", ["-O", "4"]),
                                       ("linear", ["-O", "0"])])
def test_backtrack_windows_kernel_matches_plain_on_card(gap, flags, tmp_path):
    """X1w on the card == its plain version (headers, bands, ops) over the
    windows of sim2k's 4th read at -S -k 11 -w 5 -n 50, at the first W
    and at W = 64 (where some windows overflow and are not walked), over
    the 5th read aligned whole against the final graph (one window), over
    one launch of 200 windows of sim2k's seeded reads (more blocks than the
    card has SMs: they run in waves), and over the tile fixtures
    (`chip_smoke.tile_fixture`: a predecessor past any tile, insertion and
    deletion runs past a tile's columns, a local walk, -G, a -b -1
    whole-row window on B2u), whose walks must also change stage."""
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import banded_dp
    from abpoa_tpu_torch.align.tables import build_row_tables, initial_band_width
    reads = read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))
    fa = str(tmp_path / "sim2k.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">{r.name}\n{r.seq}\n" for r in reads))
    calls, undo = chip_smoke.record_windows()
    try:
        ab = chip_smoke.run_pipeline(
            [fa, *chip_smoke.SIM2K_WINDOWS, *flags, "--device", "cuda"],
            str(tmp_path / "out.fa"))
    finally:
        undo()
    p = make_params(**GAPS[gap])
    p.device = "cuda"
    p.finalize()
    assert len(calls) == len(reads)  # one a read; the first aligns nothing
    tabs, queries, _ = calls[3]["launches"][0]  # the 4th read's windows
    t_all = build_row_tables(ab.graph, 0, 1)
    many = [(t, q) for c in calls[1:]
            for t, q in zip(*c["launches"][0][:2])][:200]
    assert len(many) == 200
    cases = [(tabs, queries, max(initial_band_width(p, len(q)) for q in queries)),
             (tabs, queries, 64), ([t_all], [encode(p, reads[4].seq)], None),
             ([t for t, _ in many], [q for _, q in many],
              max(initial_band_width(p, len(q)) for _, q in many))]
    for tb, qs, W in cases:
        W = W or initial_band_width(p, len(qs[0]))
        ts = chip_smoke.to_dev(banded.pack_windows(p, tb, qs, W), _card())
        out = banded_dp(*ts, gap_mode=p.gap_mode)
        torch.cuda.synchronize()
        assert any(out[7].tolist())
        assert chip_smoke.x1w_check(p, ts, out, tb, qs, f"{gap} W={W}")[0] == 0
    for kind in chip_smoke.TILE_FIXTURES:
        pc, g, query = chip_smoke.tile_fixture(kind, gap)
        pc.device = "cuda"
        pc.finalize()
        ts, out, t = chip_smoke.tile_launch(pc, g, query)
        torch.cuda.synchronize()
        err, xin, xkw, want = chip_smoke.x1w_check(pc, ts, out, [t], [query],
                                                   f"{gap} {kind}")
        assert err == 0
        assert chip_smoke.tile_replay(xin, xkw, want)["changes"] >= 1


@pytest.mark.cuda
def test_backtrack_windows_tile_shape_matches_its_mirror_on_card():
    """The kernel library's X1w tile (`abpoa_backtrack_windows_tile`) is the
    one `backtrack_kernel.tile_shape` (which tile_replay reads) describes."""
    import ctypes
    from abpoa_tpu_torch.align.backtrack_kernel import tile_shape
    from abpoa_tpu_torch.kernels import build
    _card()
    lib = build.load()
    out = (ctypes.c_int * 5)()
    for gap in (C.LINEAR_GAP, C.AFFINE_GAP, C.CONVEX_GAP):
        for P in (1, 4, 16, 32, 64):
            for ps in (0, 1):
                for m in (5, 27):
                    assert lib.abpoa_backtrack_windows_tile(
                        gap, P, ps, m, ctypes.cast(out, ctypes.c_void_p)) == 0
                    want = tile_shape(gap, P, bool(ps), m)
                    assert list(out) == [want["R"], want["C"], want["planes"],
                                         want["staged_p"], want["smem"]]


@pytest.fixture(scope="module")
def mode_graphs():
    return chip_smoke.mode_graphs(DATA_DIR)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.MODE_CASES,
                         ids=[" ".join(map(str, c)) for c in chip_smoke.MODE_CASES])
def test_b2_modes_and_x1w_walks_match_plain_on_card(mode_graphs, case):
    """B2 in local, extend with Z-drop, unbanded and `-G` mode on the card
    == its plain version, and X1w's walk from the mode's best cell (a
    local stop, path scores) == its plain version (chip_smoke.py phase A's
    cases; against JAX in test_torch_modes*.py)."""
    r = chip_smoke.mode_case(_card(), mode_graphs, case, chip_smoke.Rates())
    assert (r["err"], r["err_w"]) == (0, 0)


WHOLE_CASES = [c for c in chip_smoke.MODE_CASES if chip_smoke.whole_row(c)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WHOLE_CASES,
                         ids=[" ".join(map(str, c)) for c in WHOLE_CASES])
def test_unbanded_kernel_matches_plain_on_card(mode_graphs, case):
    """Kernel B2u on MODE_CASES' whole-row cases (local; global, extend and
    extend + Z-drop without a band; linear, affine and convex; with and
    without -G) == its plain version, and X1w's walk from its planes ==
    its plain version; B2u is the kernel launched, B2 not."""
    from abpoa_tpu_torch.align.banded_kernel import banded_dp, unbanded_dp
    banded_dp.launches = unbanded_dp.launches = 0
    r = chip_smoke.mode_case(_card(), mode_graphs, case, chip_smoke.Rates())
    assert (r["err"], r["err_w"]) == (0, 0)
    assert unbanded_dp.launches > 0 and banded_dp.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.CLUSTER_CASES,
                         ids=[" ".join(map(str, c)) for c in chip_smoke.CLUSTER_CASES])
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_unbanded_cluster_sizes_match_plain_on_card(mode_graphs, case, cs):
    """B2u at cs blocks a cluster, at a W that is no multiple of cs x 32
    (the last block's slice passes W), == its plain version, and X1w's walk
    from its planes == its plain version."""
    W = chip_smoke.cluster_width(len(mode_graphs[case[0]][1]))
    assert W % (cs * 32)
    r = chip_smoke.mode_case(_card(), mode_graphs, case, chip_smoke.Rates(),
                             W=W, cs=cs)
    assert (r["err"], r["err_w"]) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("unbanded", [False, True])
def test_window_of_the_other_kind_is_refused_on_card(mode_graphs, unbanded):
    """A whole-row window sent to B2, or a banded one to B2u, is not
    computed: its ok is -1, beside a window of the kernel's own kind in
    the same launch, and `check_ok` (which align_windows_banded reads)
    raises; no kernel falls back to the other."""
    from abpoa_tpu_torch.align import banded
    from abpoa_tpu_torch.align.banded_kernel import (banded_dp, check_ok,
                                                     unbanded_dp)
    from abpoa_tpu_torch.align.tables import build_row_tables
    g, query = mode_graphs["sim2k"]
    g = copy.deepcopy(g)
    own, other = make_params(wb=-1), make_params()
    g.topological_sort(own)
    if not unbanded:
        own, other = other, own
    tabs = [build_row_tables(g, 0, 1, p) for p in (own, other)]
    W = 2 * 1024 + 512
    half = [banded.pack_windows(p, [t], [query], W)
            for p, t in zip((own, other), tabs)]
    arrs = banded.pack_windows(own, tabs, [query, query], W)
    arrs[0] = np.stack([half[0][0][0], half[1][0][0]])  # each its kind's scalars
    ts = chip_smoke.to_dev(arrs, _card())
    banded_dp.launches = unbanded_dp.launches = 0
    out = banded_dp(*ts, unbanded=unbanded)
    torch.cuda.synchronize()
    assert out[7].tolist() == [1, -1]
    assert (banded_dp.launches, unbanded_dp.launches) == ((0, 1) if unbanded else (1, 0))
    with pytest.raises(RuntimeError, match="other kind"):
        check_ok(out[7])


# ---- the K-lane chunk of the lockstep and map routes -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("gap", list(GAPS))
def test_lane_chunk_kernels_match_plain_on_card(gap):
    """The split lockstep's first and last K-lane launches over four sets
    (the first reads of seq.fa, test.fa, heter.fa and rcmix.fa, driven on
    the CPU) on the card: B2 == its plain version on the computed rows,
    begend, mplr, ok and ext, and X1w's walk of the ok lanes == its plain
    version (chip_smoke.lanes_check; against JAX in
    test_torch_dp_chunk.py)."""
    from abpoa_tpu_torch.parallel import lockstep
    p = make_params(**GAPS[gap])
    sets = [[encode(p, r.seq) for r in read_fastx(os.path.join(DATA_DIR, f))][:4]
            for f in ("seq.fa", "test.fa", "heter.fa", "rcmix.fa")]
    launches, undo = chip_smoke.record_launches()
    try:
        lockstep.progressive_poa_split_batch(
            sets, [[np.ones(len(s), np.int64) for s in ss] for ss in sets], p)
    finally:
        undo()
    pc = make_params(**GAPS[gap])
    pc.device = "cuda"
    pc.finalize()
    assert len(launches[0][0]) == 4
    for tabs, queries, W in (launches[0], launches[-1]):
        err_w, _, _, finish = chip_smoke.lanes_check(_card(), pc, tabs,
                                                     queries, W, gap)
        assert (finish()[0], err_w) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k_cap", [1, 3])
def test_map_on_card_equals_cpu(k_cap):
    """seq.fa's reads against seq10.gfa's graph through the map route: the
    GAF on the card (the graph half on the device, rounds on its first k
    lanes) == the CPU's."""
    from abpoa_tpu_torch.io.gaf import gaf_record
    from abpoa_tpu_torch.parallel import map_driver
    texts = []
    for device in ("cuda", "cpu"):
        abpt = Params(device=device, amb_strand=True).finalize()
        _ab, static = map_driver.load_static_graph(
            os.path.join(DATA_DIR, "seq10.gfa"), abpt)
        recs = read_fastx(os.path.join(DATA_DIR, "seq.fa"))
        qs = [encode(abpt, r.seq) for r in recs]
        out = map_driver.map_reads_split(static, qs, abpt, k_cap=k_cap)
        texts.append("".join(gaf_record(r.name, q, res, static.base_by_nid,
                                        strand) + "\n"
                             for r, q, (res, strand) in zip(recs, qs, out)))
    assert texts[0] == texts[1] and texts[0].count("\n") == 10


# ---- the device lockstep's lane launches on the card ---------------------------
# Three lanes of uneven graphs (the states after 6 reads of seq.fa, 3 of
# test.fa and 5 of heter.fa, padded to common capacities) and each lane's
# next read; each lane kernel on the card == its plain version on the CPU
# (held lane by lane against the single-set functions, and those against
# JAX, in test_torch_fused_batch_lanes.py), on every lane, on one lane (the
# single-set launch, L = 1) and on a lane list.

LANE_SETS = (("seq.fa", 6), ("test.fa", 3), ("heter.fa", 5))


def lane_case(**kw):
    """(abpt, the stacked lanes (g, order, n2i, remain), query, weight, qp,
    qlens, W, inf, local) on the CPU."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    abpt = make_params(**kw)
    sts, reads = [], []
    for fa, n in LANE_SETS:
        st, seqs = port_state(fa, n, abpt)
        sts.append(st)
        reads.append(seqs[n])
    N = max(st.g.caps[0] for st in sts)
    E = max(st.g.caps[1] for st in sts)
    A = max(st.g.caps[2] for st in sts)
    sts = [tfl._grow_state(st, N, E, A) for st in sts]
    Qp = qp_rung(max(len(r) for r in reads))
    mat = np.ascontiguousarray(abpt.mat.astype(np.int32))
    sp, wp, lens, qp = tfl._pad_read_set(
        reads, [np.ones(len(r), dtype=np.int64) for r in reads], Qp, mat,
        abpt.m)
    lanes = (fla.stack_graphs([st.g for st in sts]),
             *(torch.stack([getattr(st, k) for st in sts])
               for k in ("order", "n2i", "remain")))
    local = abpt.align_mode == C.LOCAL_MODE
    W = 1024 if local else 256
    inf = dp_inf_min(abpt, INT32_MIN)
    return (abpt, lanes, torch.from_numpy(sp), torch.from_numpy(wp),
            torch.from_numpy(qp), lens.tolist(), W, inf, local)


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    from abpoa_tpu_torch.align.device_graph import DeviceGraph
    if isinstance(x, DeviceGraph):
        return DeviceGraph(**{k: v.to(dev) for k, v in x.tensors().items()})
    return type(x)(_to(v, dev) for v in x)


def _lane_dp(case, dev, lanes=None, pick=None):
    """B1's lane inputs on `dev` (lanes `pick` of the case only, when
    given) and its outputs."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp_lanes
    abpt, (g, order, n2i, remain), q, w, qp, qlens, W, inf, local = case
    if pick is not None:
        ix = torch.tensor(pick)
        g = type(g)(**{k: v[ix] for k, v in g.tensors().items()})
        order, n2i, remain, q, w, qp = (t[ix] for t in
                                        (order, n2i, remain, q, w, qp))
        qlens = [qlens[i] for i in pick]
    g, order, n2i, remain, q, w, qp = _to((g, order, n2i, remain, q, w, qp),
                                          dev)
    tables = fla._build_tables_l(g, order, n2i, remain)
    args, ql = fla.dp_inputs_l(abpt, g, remain, tables, qp, qlens, W, inf,
                               local)
    out = fused_dp_lanes(*args, gap_mode=abpt.gap_mode, plane16=False,
                         local=local, lanes=lanes)
    return g, order, args, ql, q, w, out


def _lanes_equal(got, want, lanes, args):
    """Per lane: the planes on the rows B1 computed, beg/end, ok, ext."""
    for l in lanes:
        gn = int(args[0][l, 8])
        rows = computed_rows(want[5][l], want[6][l], want[7][l:l + 1], gn,
                             want[0].shape[2])
        for q in range(5):
            assert torch.equal(got[q][l, :rows].cpu(), want[q][l, :rows]), (l, q)
        for q in range(5, 9):
            assert torch.equal(got[q][l].cpu(), want[q][l]), (l, q)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("shape", ["L3", "L1", "list"])
def test_lane_kernels_match_plain_on_card(mode, shape):
    """B1 (B3 in local mode) and X1 over the lanes, in one launch each."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    case = lane_case(**({"align_mode": 1} if mode == "local" else {}))
    pick = [1] if shape == "L1" else None
    lanes = [0, 2] if shape == "list" else None
    L = 1 if shape == "L1" else 3
    todo = lanes or list(range(L))
    gc, order_c, args_c, ql_c, q_c, w_c, want = _lane_dp(case, "cpu", lanes,
                                                         pick)
    gd, order_d, args_d, ql_d, q_d, w_d, got = _lane_dp(case, _card(), lanes,
                                                        pick)
    torch.cuda.synchronize()
    _lanes_equal(got, want, todo, args_c)
    abpt, local = case[0], case[8]
    inf = case[7]
    mat = torch.from_numpy(np.ascontiguousarray(abpt.mat.astype(np.int32)))
    max_ops = gc.in_ids.shape[1] + q_c.shape[1] + 8
    kw = dict(max_ops=max_ops, gap_mode=abpt.gap_mode, gap_on_right=False,
              put_gap_at_end=False, local=local)
    outs = []
    for dev, g, args, ql, q, out in ((torch.device("cpu"), gc, args_c, ql_c,
                                      q_c, want),
                                     (_card(), gd, args_d, ql_d, q_d, want)):
        # X1 on the plain version's planes, moved to each device
        o = _to(out, dev)
        bi, bj, _ = fla.best_cell_l(o[0], o[5], o[6], args[2], args[3],
                                    g.node_n, o[8], ql, inf, local)
        bt = torch.tensor([abpt.gap_ext1, abpt.gap_oe1, abpt.gap_ext2,
                           abpt.gap_oe2, inf, max_ops], dtype=torch.int32,
                          device=dev)
        sc = torch.cat([bi[:, None].to(torch.int32), bj[:, None].to(torch.int32),
                        bt.expand(len(bi), 6)], 1).contiguous()
        outs.append(backtrack_lanes(*o[:7], args[2], args[3], args[1], q,
                                    mat.to(dev), sc, lanes=lanes, **kw))
    torch.cuda.synchronize()
    for l in todo:
        assert torch.equal(outs[1][0][l].cpu(), outs[0][0][l])
        assert torch.equal(outs[1][1][l].cpu(), outs[0][1][l])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["L3", "list"])
def test_lane_tail_kernels_match_plain_on_card(shape):
    """S1 (in place, span on) and K1 over the lanes' fused graphs, and F1
    (the sequential fusion) of each lane's read and of a collision stream."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    from abpoa_tpu_torch.align.edge_sort_kernel import finish_fusion_lanes_
    from abpoa_tpu_torch.align.fuse_kernel import fuse_alignment_lanes
    from abpoa_tpu_torch.align.topo_kernel import topo_sort_lanes
    case = lane_case()
    abpt, (g, order, n2i, remain), q, w, qp, qlens, W, inf, local = case
    lanes = [0, 2] if shape == "list" else None
    todo = lanes or [0, 1, 2]
    _, _, args, ql, _, _, out = _lane_dp(case, "cpu")
    mat = torch.from_numpy(np.ascontiguousarray(abpt.mat.astype(np.int32)))
    bi, bj, _ = fla.best_cell_l(out[0], out[5], out[6], args[2], args[3],
                                g.node_n, out[8], ql, inf, local)
    max_ops = g.in_ids.shape[1] + q.shape[1] + 8
    bt = torch.tensor([abpt.gap_ext1, abpt.gap_oe1, abpt.gap_ext2,
                       abpt.gap_oe2, inf, max_ops], dtype=torch.int32)
    sc = torch.cat([bi[:, None], bj[:, None], bt.expand(3, 6)], 1).contiguous()
    ops, res = backtrack_lanes(*out[:7], args[2], args[3], args[1], q, mat, sc,
                               max_ops=max_ops, gap_mode=abpt.gap_mode,
                               gap_on_right=False, put_gap_at_end=False,
                               local=False)
    fwd = fla.forward_ops_l(ops, res, order, bj, ql, max_ops)
    # lane 1's stream becomes two mismatches onto one aligned group when the
    # graph has one
    cnt = g.aligned_cnt[1]
    if int(cnt.max()) > 0:
        a = int(torch.nonzero(cnt == cnt.max())[0, 0])
        b = int(g.aligned[1, a, 0])
        fwd[0][1, :2], fwd[1][1, :2] = 0, torch.tensor([a, b])
        fwd[2][1] = 2
    g2 = fla._fuse_vectorized_l(g, *fwd, q, ql, w)[0]
    results = []
    for dev in (torch.device("cpu"), _card()):
        gd = _to(g2, dev)
        s1 = {k: v.clone() for k, v in gd.tensors().items()}
        finish_fusion_lanes_(s1["in_ids"], s1["in_w"], s1["out_ids"],
                             s1["out_w"], s1["in_cnt"], s1["out_cnt"],
                             s1["node_n"], s1["n_span"], lanes=lanes)
        k1 = topo_sort_lanes(gd.in_ids, gd.in_w, gd.out_ids, gd.out_w,
                             gd.in_cnt, gd.out_cnt, gd.aligned,
                             gd.aligned_cnt, gd.node_n, lanes=lanes)
        f1 = fuse_alignment_lanes(_to(g, dev), *_to(fwd, dev), _to(q, dev),
                                  _to(w, dev), _to(ql, dev), q.shape[1] + 2,
                                  lanes=lanes)
        results.append((s1, k1, f1))
    torch.cuda.synchronize()
    (s1c, k1c, f1c), (s1d, k1d, f1d) = results
    for l in todo:
        for k in ("in_ids", "in_w", "out_ids", "out_w", "n_span"):
            assert torch.equal(s1d[k][l].cpu(), s1c[k][l]), (l, k)
        for a, b in zip(k1d, k1c):
            assert torch.equal(a[l].cpu(), b[l])
    for k, v in f1c[0].tensors().items():
        assert torch.equal(getattr(f1d[0], k).cpu(), v), k
    assert torch.equal(f1d[1].cpu(), f1c[1]) and torch.equal(f1d[2].cpu(), f1c[2])


def _sets(abpt, names):
    out = []
    for fa in names:
        s = [encode(abpt, r.seq) for r in read_fastx(os.path.join(DATA_DIR, fa))]
        out.append((s, [np.ones(len(x), dtype=np.int64) for x in s]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, {"out_msa": True, "amb_strand": True},
                                   {"align_mode": 2, "zdrop": 100}],
                         ids=["cons", "r2-s", "extend-z100"])
def test_device_lockstep_on_card_matches_cpu(flags, monkeypatch):
    """The device lockstep over five sets on the card == on the CPU, with
    collisions forced in the lane of set 1 (kernel F1 and K1 on that lane
    every round)."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    real, real_round = fla._fuse_vectorized_l, fla._read_round
    live = {}

    def round_(run, ls, N):
        live["sets"] = ls.sets
        return real_round(run, ls, N)

    def colliding(*a, **k):
        out = list(real(*a, **k))
        if 1 in live["sets"]:
            out[4] = out[4].clone()
            out[4][live["sets"].index(1)] = True
        return tuple(out)

    monkeypatch.setattr(fla, "_read_round", round_)
    monkeypatch.setattr(fla, "_fuse_vectorized_l", colliding)
    got = {}
    for dev in ("cpu", "cuda"):
        abpt = make_params(device=dev, **flags)
        sets = _sets(abpt, ("seq.fa", "test.fa", "seq4.fa", "heter.fa",
                            "rcmix.fa"))
        got[dev] = fla.progressive_poa_fused_batch(
            [s for s, _ in sets], [w for _, w in sets], abpt)
    for (a, ra), (b, rb) in zip(got["cpu"], got["cuda"]):
        x, y = convert_graph(a), convert_graph(b)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert ra == rb


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, {"align_mode": 1, "amb_strand": True}],
                         ids=["cons", "local-s"])
def test_device_lockstep_lane_groups_on_card(flags, monkeypatch):
    """B1 and X1 over groups of two lanes (as where the lanes' planes do not
    fit on the card) == the CPU's run in one pass."""
    from abpoa_tpu_torch.align import fused_lanes as fla
    from abpoa_tpu_torch.align import fused_loop as tfl
    got = {}
    for dev in ("cpu", "cuda"):
        abpt = make_params(device=dev, **flags)
        sets = _sets(abpt, ("seq.fa", "test.fa", "seq4.fa", "heter.fa",
                            "rcmix.fa"))
        if dev == "cuda":
            real = fla.plane_groups
            monkeypatch.setattr(fla, "plane_groups", lambda todo, lb, budget:
                                real(todo, lb, 2 * lb))
        tfl.reset_stats()
        got[dev] = fla.progressive_poa_fused_batch(
            [s for s, _ in sets], [w for _, w in sets], abpt)
    assert tfl.stats["plane_splits"] > 0
    for (a, ra), (b, rb) in zip(got["cpu"], got["cuda"]):
        x, y = convert_graph(a), convert_graph(b)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert ra == rb


def convert_graph(pg):
    from abpoa_tpu_torch import convert
    return convert.graph_to_numpy(pg)
