"""Kernel B2u (`csrc/unbanded_dp.cu`, the whole-row windows of the per-read
DP) on the CPU, with no JAX in the process:

- `unbanded_launch_shape`: the cluster of CS blocks a window, each block's
  slice of the row, its threads, ring depth and shared memory stay inside
  Hopper's limits for every width B2u takes (up to 32768), in each gap mode,
  with and without `-G`'s path scores, by default and at a forced CS;
- every caller derives the host flag that picks B2 or B2u from `Params`
  (`wb < 0`, local mode included), and it matches each window's
  scalars[13] and mode: the per-read route (`-b -1`, `-m 1`), the seeded
  route (`-S -b -1`), the map route's K lanes (`map -b -1`) and the pyapi
  aligner (`l`, `e`);
- a window sent to the kernel of the other kind raises.
B2u itself is held against its plain version on the card
(test_torch_cuda_twins.py, marked `cuda`); its plain version,
`banded_dp_torch`, against JAX's unbanded DP in test_torch_modes*.py.
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

import chip_smoke
from abpoa_tpu_torch import cli, pyapi
from abpoa_tpu_torch.align import banded, banded_kernel
from abpoa_tpu_torch.align.banded_kernel import (banded_dp, banded_dp_torch,
                                                 check_ok, unbanded_dp)
from abpoa_tpu_torch.align.fused_dp_kernel import (MAX_W_SEEDED, SMEM_LIMIT,
                                                   UNBANDED_MAX_CS,
                                                   unbanded_launch_shape,
                                                   unbanded_smem_bytes)
from abpoa_tpu_torch.align.tables import build_row_tables
from abpoa_tpu_torch.graph import POAGraph
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch.pipeline import Abpoa, _ingest_records, _select_graph, poa, want_native

WIDTHS = [128, 200, 1000, 1024, 1537, 2048, 4000, 8192, 10112, 16384, 17624,
          20000, MAX_W_SEEDED]
GAPS = {"convex": 2, "affine": 1, "linear": 0}


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def check_shape(ls: dict, W: int, P: int, gap: int, ps: bool) -> None:
    cs, S, lanes, warps = ls["cs"], ls["slice"], ls["lanes"], ls["warps"]
    assert cs in (1, 2, 4, 8, 16)
    assert lanes in (1, 2, 4, 8)
    assert S == warps * 32 * lanes
    assert cs * S >= W                       # the blocks cover the row
    assert S - (-(-W // cs)) < 32 * lanes    # with less than a warp run spare
    assert ls["threads"] == (warps + 1) * 32 <= 1024
    D = ls["depth"]
    assert D == 0 or (D >= 2 and D & (D - 1) == 0 and D <= 64)
    assert ls["smem"] == unbanded_smem_bytes(P, S, D, gap, ps) <= SMEM_LIMIT
    if D < 64:  # the deepest ring that fits
        assert unbanded_smem_bytes(P, S, max(2, 2 * D), gap, ps) > SMEM_LIMIT


@pytest.mark.parametrize("ps", [False, True], ids=["no-G", "G"])
@pytest.mark.parametrize("gap", list(GAPS))
@pytest.mark.parametrize("W", WIDTHS)
def test_cluster_launch_shape(W, gap, ps):
    """The default shape: the fewest blocks (a power of two up to 16) that
    leave each at most 31 warps of one lane a thread, the rest of the rules
    of `check_shape`; with at most 8 blocks a cluster (where the card cannot
    hold 16) the same rules hold."""
    P = 64 if ps else 12
    ls = unbanded_launch_shape(W, P, GAPS[gap], ps)
    check_shape(ls, W, P, GAPS[gap], ps)
    cs = ls["cs"]
    assert cs == UNBANDED_MAX_CS or -(-W // cs) <= 31 * 32
    assert cs == 1 or -(-W // (cs // 2)) > 31 * 32
    if W == 10112 and gap == "convex" and not ps:  # the 10 kb read's shape
        assert (cs, ls["slice"], ls["lanes"], ls["depth"]) == (16, 640, 1, 16)
    ls8 = unbanded_launch_shape(W, P, GAPS[gap], ps, max_cs=8)
    check_shape(ls8, W, P, GAPS[gap], ps)
    assert ls8["cs"] == min(cs, 8)


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_forced_cluster_sizes(cs):
    """A forced CS gives a valid shape wherever 8 lanes a thread of 31 warps
    cover the slice, and raises elsewhere; a width outside 1..32768 or a CS
    that is no power of two up to 16 raises."""
    for W in (128, 1000, 1614, 10112, 17624, MAX_W_SEEDED):
        if -(-W // cs) > 8 * 31 * 32:
            with pytest.raises(ValueError, match="cannot cover"):
                unbanded_launch_shape(W, 8, 2, cs=cs)
        else:
            check_shape(unbanded_launch_shape(W, 8, 2, cs=cs), W, 8, 2, False)
    for bad in ((0, None), (MAX_W_SEEDED + 1, None), (1000, 3), (1000, 32)):
        with pytest.raises(ValueError):
            unbanded_launch_shape(bad[0], 8, 2, cs=bad[1])


# ---- every caller's flag ----------------------------------------------------

def _encode(abpt, seq):
    return abpt.char_to_code[np.frombuffer(seq.encode(), dtype=np.uint8)].astype(np.uint8)


def _per_read(flags, tmp_path):
    """The per-read route (pipeline.poa, as C8 drives it) over seq.fa."""
    abpt = cli.args_to_params(cli.build_parser().parse_args(
        [os.path.join(DATA_DIR, "seq.fa"), *flags, "--device", "cpu"])).finalize()
    ab = Abpoa()
    seqs, weights = _ingest_records(ab, abpt, read_fastx(os.path.join(DATA_DIR, "seq.fa")))
    _select_graph(ab, want_native(abpt))
    poa(ab, abpt, seqs, weights, 0)


def _cli(argv, tmp_path):
    assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "out")]) == 0


def _sim2k_4(tmp_path) -> str:
    """sim2k's first 4 reads, which -S -k 11 -w 5 -n 50 cuts into windows."""
    fa = str(tmp_path / "sim2k_4.fa")
    with open(fa, "w") as fp:
        fp.write("".join(f">{r.name}\n{r.seq}\n" for r in
                         read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))[:4]))
    return fa


def _pyapi(mode, tmp_path):
    seqs = [r.seq for r in read_fastx(os.path.join(DATA_DIR, "seq.fa"))]
    pyapi.msa_aligner(aln_mode=mode, device="cpu").msa(seqs, out_cons=True,
                                                       out_msa=True)


ROUTES = {
    "per-read -b -1": (lambda t: _per_read(["-b", "-1"], t), True),
    "per-read -m 1": (lambda t: _per_read(["-m", "1"], t), True),
    "per-read -m 2 (banded)": (lambda t: _per_read(["-m", "2"], t), False),
    "seeded -S -b -1": (lambda t: _cli([_sim2k_4(t), *chip_smoke.SIM2K_WINDOWS,
                                        "-b", "-1"], t), True),
    "map -b -1 lanes": (lambda t: _cli(["map", "-g", os.path.join(DATA_DIR, "seq10.gfa"),
                                        os.path.join(DATA_DIR, "seq.fa"), "-b", "-1",
                                        "-K", "4"], t), True),
    "pyapi l": (lambda t: _pyapi("l", t), True),
    "pyapi e": (lambda t: _pyapi("e", t), False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_callers_flag_matches_scalars(route, tmp_path, monkeypatch):
    """Every launch a route makes passes `unbanded` equal, on every window,
    to scalars[13] == 0 or local mode (what the kernels check), and of the
    route's kind; the map route's launches hold several lanes."""
    calls = []
    real = banded.banded_dp

    def recording(*args, unbanded=False, **kw):
        sc = args[0] if args[0].dim() == 2 else args[0][None]
        calls.append((unbanded, sc[:, 12].tolist(), sc[:, 13].tolist()))
        return real(*args, unbanded=unbanded, **kw)

    monkeypatch.setattr(banded, "banded_dp", recording)
    run, whole = ROUTES[route]
    run(tmp_path)
    assert calls
    for flag, modes, bands in calls:
        assert flag == whole
        assert [m == 2 or b == 0 for m, b in zip(modes, bands)] == [whole] * len(modes)
    if route.startswith("map"):
        assert max(len(m) for _, m, _ in calls) > 1
    if route.startswith("seeded"):
        assert sum(len(m) for _, m, _ in calls) > len(calls)  # several windows a read


# ---- a window of the other kind ---------------------------------------------------

@pytest.fixture(scope="module")
def two_kinds():
    """seq.fa's first 4 reads as a graph and its 5th read: (banded inputs,
    whole-row inputs), banded_dp's batch-form tensors on the CPU."""
    recs = read_fastx(os.path.join(DATA_DIR, "seq.fa"))
    p0 = Params(device="cpu").finalize()
    g = POAGraph()
    for r in recs[:4]:
        q = _encode(p0, r.seq)
        cig = banded.align_sequence_to_subgraph(g, p0, 0, 1, q).cigar if g.node_n > 2 else []
        g.add_alignment(p0, q, None, cig, True)
    g.topological_sort(p0)
    query = _encode(p0, recs[4].seq)
    out = []
    for kw in ({}, {"wb": -1}):
        p = Params(device="cpu", **kw).finalize()
        t = build_row_tables(g, 0, 1, p)
        out.append(chip_smoke.to_dev(banded.pack_windows(p, [t], [query], 256), "cpu"))
    return out


def test_mismatched_flag_raises(two_kinds):
    """On the CPU each wrapper checks every window's kind before it runs
    the plain version: a banded window with unbanded=True (or sent to
    unbanded_dp), a whole-row one with unbanded=False, and a batch that
    mixes the two raise; the right flag runs the plain version."""
    band, whole = two_kinds
    with pytest.raises(ValueError, match="banded window sent to kernel B2u"):
        banded_dp(*band, unbanded=True)
    with pytest.raises(ValueError, match="banded window sent to kernel B2u"):
        unbanded_dp(*band)
    with pytest.raises(ValueError, match="whole-row window sent to kernel B2"):
        banded_dp(*whole)
    mixed = [torch.cat([a, b]) for a, b in zip(band, whole)]
    mixed[11] = torch.tensor([0, band[1].shape[0], band[1].shape[0] + whole[1].shape[0]],
                             dtype=torch.int32)
    for flag in (False, True):
        with pytest.raises(ValueError, match="window sent to kernel"):
            banded_dp(*mixed, unbanded=flag)
    for got, want in zip(banded_dp(*whole, unbanded=True), banded_dp_torch(*whole)):
        assert torch.equal(got, want)
    for got, want in zip(banded_dp(*band), banded_dp_torch(*band)):
        assert torch.equal(got, want)


def test_check_ok_raises_on_a_refused_window():
    """ok = -1 (a kernel's refusal on the card) raises; 0 and 1 are
    returned as a list."""
    assert check_ok(torch.tensor([1, 0, 1], dtype=torch.int32)) == [1, 0, 1]
    with pytest.raises(RuntimeError, match="other kind"):
        check_ok(torch.tensor([1, -1], dtype=torch.int32))


def test_no_launch_on_the_cpu(two_kinds):
    """The CPU runs the plain version: neither kernel's count moves."""
    before = (banded_kernel.banded_dp.launches, banded_kernel.unbanded_dp.launches)
    banded_dp(*two_kinds[1], unbanded=True)
    banded_dp(*two_kinds[0])
    assert (banded_kernel.banded_dp.launches,
            banded_kernel.unbanded_dp.launches) == before
