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
the plane rows it computes, in test_torch_cuda_twins.py (which also holds
the cases, and imports no JAX).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abpoa_tpu.align.fused_loop import _row0_planes as jax_row0_planes
from abpoa_tpu_torch.align.fused_dp_kernel import (computed_rows, fused_dp,
                                                   row0_planes)
from abpoa_tpu_torch.align.oracle import INT16_MIN, INT32_MIN, dp_inf_min

from test_torch_cuda_twins import (EXTRA, FAR, GAPS, GRID, HBM, IN_NAMES,
                                   OUT_NAMES, _assert_equal, _run_plain,
                                   build_cases, make_params)

# the suite runs several test processes at once: one torch thread each
# keeps the plain versions from competing with the other workers' timings
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
