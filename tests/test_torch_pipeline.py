"""The PyTorch port's per-read alignment and CLI against the JAX package.

(b) on a graph built by `abpoa_tpu` and carried across with
    `convert.graph_from_numpy`, the port's per-read alignment on the CPU has
    the same best score and cigar as `abpoa_tpu`'s Pallas backend (interpret
    mode) and numpy oracle, and leaves the same band state in the graph; a
    first launch with W below the band relaunches to the same result.
(c) the port's CLI on the CPU reproduces the golden consensus and
    `abpoa_tpu`'s CLI (`--device numpy`) byte for byte.
"""
import io
import os

import numpy as np
import pytest

from conftest import DATA_DIR, GOLDEN_DIR

from abpoa_tpu.align.oracle import align_sequence_to_subgraph_numpy
from abpoa_tpu.align.pallas_backend import align_sequence_to_subgraph_pallas
from abpoa_tpu.graph import POAGraph as JaxGraph
from abpoa_tpu.params import Params as JaxParams
from abpoa_tpu_torch import cli as torch_cli
from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.params import Params


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _jax_graph(fa, n_graph):
    """abpoa_tpu's graph of the first n_graph reads (numpy oracle) and the
    encoded reads."""
    abpt = JaxParams()
    abpt.device = "numpy"
    abpt.finalize()
    recs = read_fastx(os.path.join(DATA_DIR, fa))
    seqs = [abpt.char_to_code[np.frombuffer(r.seq.encode(), dtype=np.uint8)].astype(np.uint8)
            for r in recs]
    g = JaxGraph()
    for i in range(n_graph):
        cigar = []
        if g.node_n > 2:
            cigar = align_sequence_to_subgraph_numpy(g, abpt, 0, 1, seqs[i]).cigar
        g.add_alignment(abpt, seqs[i], np.ones(len(seqs[i]), dtype=np.int64),
                        None, cigar, i, len(seqs), True)
    return abpt, g, seqs


@pytest.mark.parametrize("fa,n_graph,force_w", [
    ("seq.fa", 6, None),
    ("sim2k.fa", 3, None),
    ("sim2k.fa", 3, 32),   # W below the band: relaunched until it fits
])
def test_per_read_align_matches_jax_package(fa, n_graph, force_w):
    jabpt, jg, seqs = _jax_graph(fa, n_graph)
    query = seqs[n_graph]
    arrays = convert.graph_to_numpy(jg)
    tg = convert.graph_from_numpy(arrays)
    abpt = Params(device="cpu").finalize()

    jg.topological_sort(jabpt)
    want_np = align_sequence_to_subgraph_numpy(jg, jabpt, 0, 1, query)
    jg.topological_sort(jabpt)
    want = align_sequence_to_subgraph_pallas(jg, jabpt, 0, 1, query)

    tg.topological_sort(abpt)
    retries = banded.retries
    got = banded.align_sequence_to_subgraph(tg, abpt, 0, 1, query,
                                            band_width=force_w)
    assert (banded.retries > retries) == bool(force_w)
    assert got.best_score == want.best_score == want_np.best_score
    assert got.cigar == want.cigar == want_np.cigar
    assert (got.node_s, got.node_e, got.query_s, got.query_e) == \
        (want.node_s, want.node_e, want.query_s, want.query_e)
    n = jg.node_n
    np.testing.assert_array_equal(tg.node_id_to_max_pos_left[:n],
                                  jg.node_id_to_max_pos_left[:n])
    np.testing.assert_array_equal(tg.node_id_to_max_pos_right[:n],
                                  jg.node_id_to_max_pos_right[:n])


def test_graph_round_trips_through_numpy():
    _, jg, _ = _jax_graph("seq.fa", 5)
    a = convert.graph_to_numpy(jg)
    b = convert.graph_to_numpy(convert.graph_from_numpy(a))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port_cli(args):
    buf = io.StringIO()
    ns = torch_cli.build_parser().parse_args(args)
    abpt = torch_cli.args_to_params(ns).finalize()
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    msa_from_file(Abpoa(), abpt, ns.input, buf)
    return buf.getvalue()


def _jax_cli(args):
    from abpoa_tpu.cli import args_to_params, build_parser
    from abpoa_tpu.pipeline import Abpoa, msa_from_file
    buf = io.StringIO()
    ns = build_parser().parse_args(args + ["--device", "numpy"])
    abpt = args_to_params(ns).finalize()
    msa_from_file(Abpoa(), abpt, ns.input, buf)
    return buf.getvalue()


def test_cli_cpu_reproduces_golden_consensus(capsys):
    rc = torch_cli.main([os.path.join(DATA_DIR, "seq.fa"), "--device", "cpu"])
    assert rc == 0
    with open(os.path.join(GOLDEN_DIR, "ref_consensus.txt")) as fp:
        assert capsys.readouterr().out == fp.read()


def _first_reads(tmp_path, fa, n):
    recs = read_fastx(os.path.join(DATA_DIR, fa))[:n]
    path = tmp_path / f"first{n}_{fa}"
    path.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    return str(path)


def test_cli_cpu_matches_jax_cli_on_sim2k(tmp_path):
    path = _first_reads(tmp_path, "sim2k.fa", 6)
    got = _port_cli([path, "--device", "cpu"])
    assert got == _jax_cli([path])
    assert got.startswith(">Consensus_sequence\n") and len(got) > 1900


@pytest.mark.parametrize("fa,flags", [
    ("heter.fa", []),
    ("rcmix.fa", ["-s"]),
    ("heter.fq", ["-Q", "-r", "5"]),
    ("aa.fa", ["-c"]),
    ("seq.fa", ["-R", "-J", "-L"]),
])
def test_cli_cpu_matches_jax_cli_on_fixtures(fa, flags):
    path = os.path.join(DATA_DIR, fa)
    assert _port_cli([path, "--device", "cpu", *flags]) == _jax_cli([path, *flags])


def test_per_read_route_with_s_matches_jax_on_rcmix():
    """`-s` on the per-read route (pipeline.poa, kernel B2's plain version
    on the CPU): the reverse-complement retries run on re-seeded tables,
    and the consensus equals the JAX package's per-read route."""
    from abpoa_tpu_torch.pipeline import Abpoa, _ingest_records, output, poa
    path = os.path.join(DATA_DIR, "rcmix.fa")
    ns = torch_cli.build_parser().parse_args([path, "--device", "cpu", "-s"])
    abpt = torch_cli.args_to_params(ns).finalize()
    ab = Abpoa()
    seqs, weights = _ingest_records(ab, abpt, read_fastx(path))
    reads = banded.stats["reads"]
    poa(ab, abpt, seqs, weights, 0)
    assert banded.stats["reads"] - reads > len(seqs) - 1  # retries ran
    assert any(ab.is_rc)
    buf = io.StringIO()
    output(ab, abpt, buf)
    assert buf.getvalue() == _jax_cli([path, "-s"])
