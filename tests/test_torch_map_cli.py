"""The map route on the CPU, the cases beside the parity grid
(test_torch_map.py):
- a read off the query rung is skipped, alone: None from the driver, one
  warning and rc 1 from the CLI, the other reads mapped;
- restore -> map -> restore gives the same graph (mapping changes none);
- the static tables are built once a run, the graph half uploaded once per
  K, every round of k <= K reads on the pack's first k lanes;
- the GAF of a read does not depend on the reads before it (read order,
  each read alone);
- `python -m abpoa_tpu_torch map` equals the JAX package's `map` CLI, in
  default scoring, with -s and -K 4, and with -O/-E and -b/-f.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from abpoa_tpu_torch import cli
from abpoa_tpu_torch.align import buckets, dp_chunk
from abpoa_tpu_torch.io.output import generate_gfa
from abpoa_tpu_torch.parallel import map_driver

from test_torch_map import (encode, port_gaf, port_params, revcomp,  # noqa: F401
                            sim_graph)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_off_rung_read_is_skipped(sim_graph, tmp_path, monkeypatch):
    gfa, reads = sim_graph
    abpt = port_params()
    _ab, static = map_driver.load_static_graph(gfa, abpt)
    queries = [encode(abpt, s) for _, s in reads]
    long_q = np.zeros(4000, dtype=np.uint8)
    out = map_driver.map_reads_split(static, [long_q] + queries, abpt,
                                     k_cap=4, Qp=256)
    assert out[0] is None and all(r is not None for r in out[1:])
    fa = tmp_path / "reads.fa"
    fa.write_text(">long\n" + "A" * 400 + "\n"
                  + "".join(f">{n}\n{s}\n" for n, s in reads))
    monkeypatch.setattr(buckets, "qp_rung", lambda qmax: 256)
    rc, out, err = _run(cli.main, ["map", "-g", gfa, str(fa), "--device",
                                   "cpu"])
    assert rc == 1 and "'long' (400 bp) exceeds the planned query rung" in err
    assert out == port_gaf(gfa, reads, port_params(), 8)


def _export(ab) -> str:
    out = port_params(out_cons=False, out_gfa=True)
    g = ab.graph.to_python() if getattr(ab.graph, "is_native", False) else ab.graph
    buf = io.StringIO()
    generate_gfa(g, out, ab.names, ab.is_rc, lambda: None, buf)
    return buf.getvalue()


def test_restore_map_restore_roundtrip(sim_graph):
    gfa, reads = sim_graph
    abpt = port_params()
    ab, static = map_driver.load_static_graph(gfa, abpt)
    before = _export(ab)
    queries = [encode(abpt, s) for _, s in reads]
    first = map_driver.map_reads_split(static, queries, abpt, k_cap=4)
    assert _export(ab) == before
    assert _export(map_driver.load_static_graph(gfa, port_params())[0]) == before
    again = map_driver.map_reads_split(static, queries, abpt, k_cap=3)
    assert [(r.cigar, s) for r, s in first] == [(r.cigar, s) for r, s in again]


def test_static_tables_built_once_uploaded_once_per_k(sim_graph):
    gfa, reads = sim_graph
    abpt = port_params()
    builds = dp_chunk.stats["static_builds"]
    _ab, static = map_driver.load_static_graph(gfa, abpt)
    uploads = dp_chunk.stats["static_uploads"]
    queries = [encode(abpt, s) for _, s in reads] * 2   # 16 reads
    map_driver.map_reads_split(static, queries, abpt, k_cap=5)   # 5 5 5 1
    assert dp_chunk.stats["static_builds"] - builds == 1
    assert dp_chunk.stats["static_uploads"] - uploads == 1
    assert static.lanes(5)[0].shape[0] == 5 * static.n_rows


def test_gaf_does_not_depend_on_read_order(sim_graph):
    """Reversed order, and each read alone (`map_read_host`, the serial
    baseline), give each read's record of the batched run."""
    from abpoa_tpu_torch.io.gaf import gaf_record
    gfa, reads = sim_graph
    reads = [(n, s if i % 3 else revcomp(s)) for i, (n, s) in enumerate(reads)]
    abpt = port_params(amb=True)
    fwd = port_gaf(gfa, reads, abpt, 3).splitlines()
    back = port_gaf(gfa, reads[::-1], port_params(amb=True), 3).splitlines()
    assert fwd == back[::-1]
    _ab, static = map_driver.load_static_graph(gfa, abpt)
    for (n, s), line in zip(reads, fwd):
        q = encode(abpt, s)
        res, strand = map_driver.map_read_host(static, abpt, q)
        assert gaf_record(n, q, res, static.base_by_nid, strand) == line


@pytest.mark.parametrize("flags", [[], ["-s", "-K", "4"],
                                   ["-O", "4", "-E", "2", "-b", "5", "-f",
                                    "0.02"]], ids=["default", "s-K4", "OEbf"])
def test_map_cli_equals_jax_cli(sim_graph, tmp_path, flags):
    from abpoa_tpu.cli import main as jax_main
    gfa, reads = sim_graph
    reads = [(n, s if i % 2 == 0 else revcomp(s))
             for i, (n, s) in enumerate(reads)]
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">{n} c{i}\n{s}\n"
                          for i, (n, s) in enumerate(reads)))
    rc, out, _ = _run(cli.main, ["map", "-g", gfa, str(fa), *flags,
                                 "--device", "cpu"])
    jrc, jout, _ = _run(jax_main, ["map", "-g", gfa, str(fa), *flags,
                                   "--device", "jax"])
    assert (rc, out) == (jrc, jout) and rc == 0
    assert out.count("\n") == len(reads) and "co:Z:c1" in out
