"""Kernel B1/B3 of the port (`fused_dp`) against the JAX package's Pallas
kernels.

`fused_dp_torch` (the plain version of `csrc/fused_dp.cu`, and the CPU path
of the `fused_dp` wrapper) must equal `pallas_fused_dp` run in interpret mode
on the same inputs, on all nine outputs, with tolerance 0: over linear,
affine and convex gaps x global, extend (+Z-drop) and local mode x int16 and
int32 planes, plus a band overflow. Inputs are the kernel tables of mid-run
graphs of tests/data/seq.fa, test.fa and sim2k.fa, built by the port's
fused loop on the CPU, and a synthetic graph (`chip_smoke.synthetic_graph`)
whose predecessors sit 70 rows back, past the CUDA kernel's 64-row
shared-memory ring at W = 128 but inside Pallas's 512-row ring, in three
gap regimes, global and extend with Z-drop: there the plain version pulls
each row's band from its predecessors, the Pallas kernel pushes it to the
successors. The Pallas side runs in one subprocess with a timeout, as
tests/test_pallas_fused.py runs it. The Pallas kernel leaves row 0 and
beg/end[0] to its caller, which patches them (fused_loop.py:1305-1315); the
port's kernel writes them itself, so the Pallas outputs are patched the same
way before the comparison. In local mode `fused_dp_torch` must also equal
`pallas_fused_dp_local_hbm` (B3) on every row it computes (rows 0..gn-2;
B3 leaves later rows unwritten and reports end = qlen for every row).
The CUDA kernel itself is compared with the plain version on the card, on
the plane rows it computes (marked `cuda`, skipped without one).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import jax.numpy as jnp

from abpoa_tpu.align.fused_loop import _row0_planes as jax_row0_planes
import chip_smoke
from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.align.buckets import qp_rung
from abpoa_tpu_torch.align.fused_dp_kernel import (computed_rows, fused_dp,
                                                   fused_dp_torch, launch_shape,
                                                   row0_planes)
from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params

# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


_PALLAS_CHILD = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
sys.path.insert(0, {root!r})
from abpoa_tpu.align.pallas_fused import (pallas_fused_dp,
                                          pallas_fused_dp_local_hbm)
data = np.load({src!r})
out = {{}}
names = sorted({{k.split("__")[0] for k in data.files}})
for name in names:
    a = lambda k: data[name + "__" + k]
    gap, p16, ext, zd, loc, hbm = [int(x) for x in a("statics")]
    dt = jnp.int16 if p16 else jnp.int32
    row0 = a("row0")
    args = [jnp.asarray(a(k)) for k in ("scalars", "base_packed", "pre_idx",
                                        "pre_cnt", "out_idx", "out_cnt",
                                        "remain")]
    args += [jnp.asarray(row0[i: i + 1]).astype(dt) for i in range(3)]
    args.append(jnp.asarray(a("qp_pad")))
    kw = dict(R=a("base_packed").shape[0], W=row0.shape[1],
              P=a("pre_idx").shape[1], O=a("out_idx").shape[1],
              gap_mode=gap, plane16=bool(p16), interpret=True)
    if hbm:
        res = pallas_fused_dp_local_hbm(*args, **kw)
    else:
        res = pallas_fused_dp(*args, extend=bool(ext), zdrop_on=bool(zd),
                              local=bool(loc), **kw)
    for k, v in zip({out_names!r}, res):
        out[name + "__" + k] = np.asarray(v)
np.savez({dst!r}, **out)
print("PALLAS-OK")
"""


@pytest.fixture(scope="module")
def cases():
    return build_cases()


@pytest.fixture(scope="module")
def pallas_out(cases, tmp_path_factory):
    """The Pallas kernels' outputs for every case, run in interpret mode in
    one subprocess, with row 0 and beg/end[0] patched as the JAX fused loop
    patches them."""
    d = tmp_path_factory.mktemp("pallas")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    arrays = {}
    for name, (args, s, _) in cases.items():
        for k, t in zip(IN_NAMES, args):
            arrays[f"{name}__{k}"] = t.numpy()
        arrays[f"{name}__statics"] = np.array(
            [s["gap_mode"], s["plane16"], s["extend"], s["zdrop_on"],
             s["local"], s["hbm"]], dtype=np.int32)
    np.savez(src, **arrays)
    code = _PALLAS_CHILD.format(root=ROOT, src=src, dst=dst,
                                out_names=OUT_NAMES)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=1500)
    assert "PALLAS-OK" in proc.stdout, (
        f"child rc={proc.returncode}\n{proc.stderr[-3000:]}")
    data = np.load(dst)
    out = {}
    for name, (args, _, _) in cases.items():
        res = [data[f"{name}__{k}"].copy() for k in OUT_NAMES]
        row0, sc = args[7].numpy(), args[0].numpy()
        for p in range(5):
            res[p][0] = row0[p]
        res[5][0], res[6][0] = 0, sc[9]
        out[name] = res
    return out


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


@pytest.mark.parametrize("name", GRID + EXTRA)
def test_fused_dp_torch_matches_pallas(name, cases, pallas_out):
    got = _run_plain(cases[name])
    _assert_equal(got, pallas_out[name])


def test_grid_reaches_zdrop_and_overflow(cases, pallas_out):
    """The grid exercises what it claims: extend mode Z-drops and the
    overflow case stops with ok = 0 after computing some rows."""
    dropped = [n for n in GRID if "extend" in n and pallas_out[n][8][3] == 1]
    assert dropped, "no extend case Z-dropped"
    ovf = pallas_out[EXTRA[0]]
    assert ovf[7][0] == 0 and (ovf[6][1:] > 0).sum() >= 5


@pytest.mark.parametrize("name", FAR)
def test_fused_dp_far_predecessors_match_pallas(name, cases, pallas_out):
    args = cases[name][0]
    got = _run_plain(cases[name])
    _assert_equal(got, pallas_out[name])
    gn = int(args[0][8])
    assert computed_rows(got[5], got[6], got[7], gn, 128) == gn - 1
    beg, end = got[5], got[6]
    # the rows past 70 read their far predecessor's cells
    assert any(beg[r] <= end[r - 70] + 1 for r in range(71, gn - 1))
    if "extend" in name:
        assert int(got[8][3]) == 1  # Z-drop fired


@pytest.mark.parametrize("name", HBM)
def test_fused_dp_local_matches_pallas_local_hbm(name, cases, pallas_out):
    args = cases[name][0]
    gn = int(args[0][8])
    got = _run_plain(cases[name])
    want = pallas_out[name]
    _assert_equal(got, want, rows=gn - 1)
    # the local instantiation of B1 on the same inputs
    twin = pallas_out[name.replace("hbm-", "").replace("-int", "-local-int")]
    _assert_equal(got, twin)


@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("local", [False, True], ids=["banded", "local"])
@pytest.mark.parametrize("plane16", [False, True], ids=["int32", "int16"])
def test_row0_planes_match_jax(gap, local, plane16):
    abpt = make_params(**GAPS[gap])
    inf = dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN)
    dt = jnp.int16 if plane16 else jnp.int32
    for end0 in (0, 7, 127):
        got = row0_planes(128, torch.tensor(end0, dtype=torch.int32), abpt,
                          inf, local, "cpu")
        want = jax_row0_planes(
            128, jnp.int32(end0), *[dt(x) for x in (
                abpt.gap_open1, abpt.gap_ext1, abpt.gap_oe1, abpt.gap_open2,
                abpt.gap_ext2, abpt.gap_oe2, inf)], gap_mode=abpt.gap_mode,
            local=local)
        np.testing.assert_array_equal(got.numpy(),
                                      np.stack([np.asarray(x) for x in want]))


def test_wrapper_runs_plain_version_on_cpu(cases):
    args, s, _ = cases["convex-global-int16"]
    before = (fused_dp.launches, fused_dp.local_launches)
    got = fused_dp(*args, **{k: v for k, v in s.items() if k != "hbm"})
    assert (fused_dp.launches, fused_dp.local_launches) == before
    _assert_equal(got, [t.numpy() for t in _run_plain(cases["convex-global-int16"])])
    with pytest.raises(TypeError):
        fused_dp(*[a.long() for a in args], **{k: v for k, v in s.items() if k != "hbm"})


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


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
