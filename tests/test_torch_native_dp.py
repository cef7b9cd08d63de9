"""The port's native host DP (`--device native`, the breaker's host rung)
against the JAX package's.

- `apg_align` on seeded graphs: the same reads built into a graph by each
  package's pipeline on its native device, then one held-out read aligned
  by each package's native DP, in global, local and extend (Z-drop) mode,
  with linear, affine and convex gaps, with and without `-G`, with int16
  and int32 planes (ABPOA_TPU_NATIVE_I32): the same cigar, score, ends and
  counts;
- the goldens through `--device native`, byte for byte, and flag sets
  without a golden against the JAX CLI on its native device.
"""
import io
import os

import numpy as np
import pytest

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu_torch import constants as C

MODES = {"global": {}, "local": {"align_mode": 1},
         "extend": {"align_mode": 2, "zdrop": 20}}
GAPS = {"convex": {}, "affine": {"gap_open2": 0},
        "linear": {"gap_open1": 0}}


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _params(pkg, device, fields):
    p = pkg.Params()
    for k, v in fields.items():
        setattr(p, k, v)
    p.device = device
    return p.finalize()


def _graph(pkg_pipeline, abpt, records):
    ab = pkg_pipeline.Abpoa()
    pkg_pipeline.msa(ab, abpt, records, io.StringIO())
    g = ab.graph
    assert getattr(g, "is_native", False)
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    return g


def _fields(res):
    return (list(res.cigar), int(res.best_score), res.node_s, res.node_e,
            res.query_s, res.query_e, res.n_aln_bases, res.n_matched_bases)


def _reads(fa, n):
    from abpoa_tpu_torch.io.fastx import read_fastx
    return read_fastx(os.path.join(DATA_DIR, fa))[:n]


@pytest.mark.parametrize("i32", [False, True])
@pytest.mark.parametrize("ps", [False, True])
@pytest.mark.parametrize("gap", sorted(GAPS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_apg_align_equals_jax_native(monkeypatch, mode, gap, ps, i32):
    import abpoa_tpu.params as jparams
    import abpoa_tpu.pipeline as jpipe
    from abpoa_tpu.align.native_backend import \
        align_sequence_to_subgraph_native
    import abpoa_tpu_torch.params as pparams
    import abpoa_tpu_torch.pipeline as ppipe
    from abpoa_tpu_torch.align.native_backend import align_native
    if i32:
        monkeypatch.setenv("ABPOA_TPU_NATIVE_I32", "1")
    fields = dict(MODES[mode], **GAPS[gap], inc_path_score=ps)
    fa = "rcmix.fa" if mode == "extend" else "seq.fa"
    recs = _reads(fa, 7)
    jp = _params(jparams, "native", fields)
    pp = _params(pparams, "native", fields)
    jg = _graph(jpipe, jp, recs[:6])
    pg = _graph(ppipe, pp, recs[:6])
    assert jg.node_n == pg.node_n
    q = pp.char_to_code[np.frombuffer(recs[6].seq.encode(), dtype=np.uint8)
                        ].astype(np.uint8)
    want = align_sequence_to_subgraph_native(jg, jp, C.SRC_NODE_ID,
                                             C.SINK_NODE_ID, q)
    got = align_native(pg, pp, C.SRC_NODE_ID, C.SINK_NODE_ID, q)
    assert _fields(got) == _fields(want)
    assert got.cigar


def _port_cli(args):
    from abpoa_tpu_torch import cli
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    ns = cli.build_parser().parse_args(args)
    buf = io.StringIO()
    msa_from_file(Abpoa(), cli.args_to_params(ns).finalize(), ns.input, buf)
    return buf.getvalue()


def _jax_cli(args):
    from abpoa_tpu.cli import args_to_params, build_parser
    from abpoa_tpu.pipeline import Abpoa, msa_from_file
    ns = build_parser().parse_args(args)
    buf = io.StringIO()
    msa_from_file(Abpoa(), args_to_params(ns).finalize(), ns.input, buf)
    return buf.getvalue()


def _path(fn):
    return os.path.join(DATA_DIR, fn)


@pytest.mark.parametrize("fa,flags,golden", [
    ("seq.fa", [], "ref_consensus.txt"),
    ("seq.fa", ["-O", "4"], "seq_affine.txt"),
    ("seq.fa", ["-O", "0"], "seq_linear.txt"),
    ("seq.fa", ["-m", "1"], "seq_m1.txt"),
    ("seq.fa", ["-m", "2"], "seq_m2.txt"),
    ("seq.fa", ["-r", "2"], "seq_r2.txt"),
    ("seq.fa", ["-r", "4"], "seq_r4.txt"),
    ("seq.fa", ["-b", "-1"], "seq_noband.txt"),
    ("heter.fa", ["-d", "2", "-r", "2"], "heter_d2r2.txt"),
    ("3alleles.fa", ["-d", "3"], "3alleles_d3.txt"),
    ("heter.fq", ["-d", "2", "-Q"], "heterq_d2Q.txt"),
    ("seq.fa", ["-S", "-p"], "seq_Sp.txt"),
    ("rcmix.fa", ["-s", "-S", "-n", "200"], "rcmix_sS.txt"),
    ("aa.fa", ["-c"], "aa_cons.txt"),
    ("seq4.fa", ["-i", _path("seq10.gfa")], "incr_gfa.txt"),
])
def test_native_device_reproduces_golden(fa, flags, golden):
    out = _port_cli([_path(fa), *flags, "--device", "native"])
    with open(os.path.join(GOLDEN_DIR, golden)) as fp:
        assert out == fp.read()


@pytest.mark.parametrize("fa,flags", [
    ("seq.fa", ["-G"]),
    ("heter.fa", ["-G", "-m", "1"]),
    ("rcmix.fa", ["-m", "2", "-z", "20", "-O", "0"]),
    ("rcmix.fa", ["-s", "-r", "1"]),
])
def test_native_device_equals_jax_cli(fa, flags):
    args = [_path(fa), *flags, "--device", "native"]
    assert _port_cli(args) == _jax_cli(args)


def test_native_device_takes_no_fused_route(monkeypatch):
    """On native no kernel wrapper and no fused loop is reached: the reads
    go to the C++ DP one by one."""
    from abpoa_tpu_torch.align import fused_loop
    from abpoa_tpu_torch.align import native_backend
    calls = []
    real = native_backend.align_native
    monkeypatch.setattr(fused_loop, "progressive_poa_fused",
                        lambda *a, **k: pytest.fail("fused route on native"))
    monkeypatch.setattr(native_backend, "align_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = _port_cli([_path("seq.fa"), "--device", "native"])
    with open(os.path.join(GOLDEN_DIR, "ref_consensus.txt")) as fp:
        assert out == fp.read()
    assert len(calls) == len(_reads("seq.fa", 100)) - 1
