"""The port's native host graph (`abpoa_tpu_torch/native/`) against the JAX
package's `NativePOAGraph`, tolerance 0.

Both graphs take the same alignments: the first reads of
tests/data/sim2k.fa, and the qv-weighted diploid reads of
tests/data/heter.fq with `-d 2 -Q` (per-read qv weights and read ids), each
read fused with the cigar the JAX package's aligner gives against its own
graph. Then the export (`convert.graph_to_numpy`) matches field by field,
the DP's tables (`build_tables`) array by array on the whole graph and on
windows inside it, as do the heaviest-bundling consensus and the subgraph
closure; the row tables derived from the C++ tables equal those of the
port's Python graph; a graph carried across with `native_graph_from_numpy`
(from either package) exports and grows as the original; a missing
compiler raises; and the routes pick the graph engine the JAX package picks.
"""
import io
import os

import numpy as np
import pytest

from conftest import DATA_DIR

from abpoa_tpu import cli as jcli
from abpoa_tpu.align import align_sequence_to_graph as jax_align
from abpoa_tpu.io.fastx import read_fastx
from abpoa_tpu.native.graph import NativePOAGraph as JaxNativeGraph
from abpoa_tpu_torch import cli as tcli
from abpoa_tpu_torch import convert
from abpoa_tpu_torch import native
from abpoa_tpu_torch import pipeline
from abpoa_tpu_torch.align.tables import build_row_tables, native_row_tables
from abpoa_tpu_torch.cons.consensus import generate_consensus
from abpoa_tpu_torch.native.graph import NativePOAGraph

CASES = {"sim2k": ("sim2k.fa", [], 6), "qv_d2": ("heter.fq", ["-d", "2", "-Q"], 10)}
_BUILT = {}


def _params(case: str):
    fn, flags, _ = CASES[case]
    args = [os.path.join(DATA_DIR, fn), *flags]
    jabpt = jcli.args_to_params(
        jcli.build_parser().parse_args(args + ["--device", "native"])).finalize()
    tabpt = tcli.args_to_params(
        tcli.build_parser().parse_args(args + ["--device", "cpu"])).finalize()
    return jabpt, tabpt


def _reads(case: str, jabpt):
    fn, _, n = CASES[case]
    out = []
    for rec in read_fastx(os.path.join(DATA_DIR, fn))[:n]:
        seq = jabpt.char_to_code[np.frombuffer(rec.seq.encode(), np.uint8)
                                 ].astype(np.uint8)
        if jabpt.use_qv and rec.qual:
            w = np.frombuffer(rec.qual.encode(), np.uint8).astype(np.int64) - 32
        else:
            w = np.ones(len(seq), dtype=np.int64)
        out.append((seq, w))
    return out


def _grow(jg, tgs, jabpt, tabpt, reads, first_id: int) -> None:
    """Fuse `reads` into the JAX graph jg and each port graph of `tgs`
    with the cigar JAX's aligner gives against jg."""
    tot = first_id + len(reads)
    for k, (seq, w) in enumerate(reads):
        cigar = jax_align(jg, jabpt, seq).cigar if jg.node_n > 2 else []
        jg.add_alignment(jabpt, seq, w, None, cigar, first_id + k, tot, True)
        for tg in tgs:
            tg.add_alignment(tabpt, seq, w, cigar, True, first_id + k)


def _fresh(case: str):
    """(JAX Params, port Params, JAX native graph, port native graph, the
    case's last read) after all but the last read."""
    jabpt, tabpt = _params(case)
    reads = _reads(case, jabpt)
    jg, tg = JaxNativeGraph(), NativePOAGraph()
    _grow(jg, [tg], jabpt, tabpt, reads[:-1], 0)
    return jabpt, tabpt, jg, tg, reads[-1]


def _built(case: str):
    """`_fresh(case)`, built once a module; the tests that read it leave
    both graphs' band state as they find it or change both alike."""
    if case not in _BUILT:
        _BUILT[case] = _fresh(case)
    return _BUILT[case]


def _export_equal(a: dict, b: dict, skip=()) -> None:
    assert set(a) == set(b)
    for k in a:
        if k not in skip:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_export(jg, jabpt) -> dict:
    """JAX's native graph through its `to_python` (which carries no band
    arrays: mpl/mpr are compared through the tables instead)."""
    return convert.graph_to_numpy(jg.to_python(jabpt))


def _windows(g):
    """The whole graph and three windows inside it, as (beg id, end id)."""
    i2n = g.index_to_node_id
    n = g.node_n
    return [(0, 1), (int(i2n[n // 4]), int(i2n[n // 2])),
            (int(i2n[1]), int(i2n[n // 3])), (int(i2n[n // 2]), 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_jax(case):
    jabpt, _, jg, tg, _ = _built(case)
    assert tg.node_n == jg.node_n > 2
    got, want = convert.graph_to_numpy(tg), _jax_export(jg, jabpt)
    _export_equal(got, want, skip=("mpl", "mpr"))
    if case == "qv_d2":
        assert len(got["read_weight_ids"]) and got["out_read_ids"].any()


@pytest.mark.parametrize("case", list(CASES))
def test_build_tables_equal_jax(case):
    jabpt, _, jg, tg, _ = _built(case)
    keys = {"base": "base", "row_active": "row_active", "pre_idx": "pre_idx",
            "pre_msk": "pre_msk", "out_idx": "out_idx", "out_msk": "out_msk",
            "remain": "remain_rows", "mpl0": "mpl0", "mpr0": "mpr0",
            "gn": "gn", "beg_index": "beg_index", "remain_end": "remain_end"}
    for beg, end in _windows(tg):
        want = jg.build_tables(beg, end, True, lambda r: r, lambda x: x)
        got = tg.build_tables(beg, end)
        for k, jk in keys.items():
            np.testing.assert_array_equal(got[k], want[jk], err_msg=(beg, end, k))


@pytest.mark.parametrize("case", list(CASES))
def test_row_tables_equal_the_python_graphs(case):
    """`native_row_tables` (from C++'s tables, numpy only) == the Python
    graph's `build_row_tables`, the band seeding of both graphs included."""
    _, _, _, tg, _ = _built(case)
    for beg, end in _windows(tg):
        pg = convert.graph_from_numpy(convert.graph_to_numpy(tg))
        got, want = native_row_tables(tg, beg, end), build_row_tables(pg, beg, end)
        for k in ("gn", "R", "beg_index", "remain_end", "nids", "base",
                  "pre_idx", "pre_cnt", "out_idx", "out_cnt", "remain", "mpl0",
                  "mpr0"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=(beg, end, k))
        _export_equal(convert.graph_to_numpy(tg), convert.graph_to_numpy(pg))


@pytest.mark.parametrize("case", list(CASES))
def test_consensus_hb_equals_jax(case):
    jabpt, tabpt, jg, tg, _ = _built(case)
    for got, want in zip(tg.consensus_hb(), jg.consensus_hb()):
        np.testing.assert_array_equal(got, want)
    if tabpt.max_n_cons == 1:  # the Python heaviest bundling agrees
        abc = generate_consensus(tg.to_python(), tabpt, 5)
        assert abc.cons_base == [tg.consensus_hb()[1].tolist()]


@pytest.mark.parametrize("case", list(CASES))
def test_subgraph_nodes_equal_jax(case):
    jabpt, tabpt, jg, tg, _ = _built(case)
    for beg, end in _windows(tg)[1:]:
        assert tg.subgraph_nodes(tabpt, beg, end) == jg.subgraph_nodes(
            jabpt, beg, end)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("source", ["port", "jax"])
def test_native_graph_from_numpy_round_trip(case, source):
    """A graph carried across exports as the original, and grows with the
    case's last read as the JAX graph does."""
    jabpt, tabpt, jg, tg, last = _fresh(case)
    a = convert.graph_to_numpy(tg) if source == "port" else _jax_export(jg, jabpt)
    g2 = convert.native_graph_from_numpy(a)
    # JAX's export has no band arrays; the carried graph's are zero
    _export_equal(convert.graph_to_numpy(g2), a,
                  skip=("mpl", "mpr") if source == "jax" else ())
    for got, want in zip(g2.consensus_hb(), tg.consensus_hb()):
        np.testing.assert_array_equal(got, want)
    _grow(jg, [tg, g2], jabpt, tabpt, [last], CASES[case][2] - 1)
    _export_equal(convert.graph_to_numpy(g2), convert.graph_to_numpy(tg))
    _export_equal(convert.graph_to_numpy(tg), _jax_export(jg, jabpt),
                  skip=("mpl", "mpr"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: loading the library, making a native graph and a run of
    the per-read route all raise; nothing falls back to the Python graph."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-abpoa")
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.load()
    with pytest.raises(RuntimeError, match="cannot be built"):
        NativePOAGraph()
    _, tabpt = _params("qv_d2")
    with pytest.raises(RuntimeError, match="cannot be built"):
        pipeline.msa(pipeline.Abpoa(), tabpt,
                     read_fastx(os.path.join(DATA_DIR, "heter.fq"))[:3],
                     io.StringIO())
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("fn,flags,engine", [
    ("seq.fa", ["-S"], "native"),                    # the seeded route
    ("seq.fa", ["-p"], "native"),
    ("heter.fq", ["-d", "2", "-Q"], "native"),       # the per-read route
    ("seq4.fa", ["-i", "seq10.gfa", "-r", "1"], "native"),
    ("seq.fa", [], "python"),                        # the fused route
    ("seq4.fa", ["-i", "seq10.gfa"], "python"),
    ("seq.fa", ["-S", "-m", "1"], "python"),
])
def test_routes_pick_the_graph_engine(fn, flags, engine):
    flags = [os.path.join(DATA_DIR, f) if "." in f else f for f in flags]
    abpt = tcli.args_to_params(tcli.build_parser().parse_args(
        [os.path.join(DATA_DIR, fn), *flags, "--device", "cpu"])).finalize()
    ab = pipeline.Abpoa()
    pipeline.msa(ab, abpt, read_fastx(os.path.join(DATA_DIR, fn)), io.StringIO())
    assert getattr(ab.graph, "is_native", False) == (engine == "native")
    assert ab.graph.node_n > 2
