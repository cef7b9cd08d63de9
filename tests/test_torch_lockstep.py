"""The split lockstep driver (`abpoa_tpu_torch/parallel/lockstep.py`) on the
CPU, twins of tests/test_lockstep_split.py's parity cases: K read sets
advancing one read a round through one K-lane launch of B2's and X1w's
plain versions, each set's output byte-identical to the JAX package's
split driver and to the port's set-by-set route (the fused route a set of
two or more reads takes with `--lockstep off`):
- the parity grid in convex gaps, K = 1, 2, 4, sets of divergent sizes
  (they drain at different rounds); affine and linear gaps are in
  test_torch_lockstep_gaps.py;
- the data files seq.fa, test.fa and heter.fa as one group.
"""
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch.io.fastx import SeqRecord, read_fastx
from abpoa_tpu_torch.parallel import lockstep
from abpoa_tpu_torch.pipeline import Abpoa, _ingest_records, msa, output

from test_torch_dp_chunk import jax_params, port_params, random_sets

torch.set_num_threads(1)

GAPS = {"convex": {}, "affine": {"gap_open2": 0},
        "linear": {"gap_open1": 0, "gap_open2": 0}}


def jax_split(seq_sets, weight_sets, **kw):
    """Each set's consensus text from the JAX package's split driver (and
    the driver's raw results)."""
    from abpoa_tpu.cons.consensus import generate_consensus
    from abpoa_tpu.io.output import output_fx_consensus
    from abpoa_tpu.parallel.lockstep import progressive_poa_split_batch
    abpt = jax_params("jax", **kw)
    texts = []
    outs = progressive_poa_split_batch(seq_sets, weight_sets, abpt)
    for reads, res in zip(seq_sets, outs):
        assert res is not None
        buf = io.StringIO()
        output_fx_consensus(generate_consensus(res[0], abpt, len(reads)),
                            abpt, buf)
        texts.append(buf.getvalue())
    return texts, outs


def port_text(abpt, graph, reads, is_rc=None) -> str:
    """The port's output of a set whose graph `graph` holds `reads`."""
    ab = Abpoa()
    for r in reads:
        ab.append_read(seq="x" * len(r))
    ab.graph = graph
    if is_rc is not None:
        ab.is_rc = list(is_rc)
    buf = io.StringIO()
    output(ab, abpt, buf)
    return buf.getvalue()


def port_split(seq_sets, weight_sets, churn=None, **kw):
    """Each initial set's output text from the port's split driver (and the
    driver's raw results)."""
    abpt = port_params(**kw)
    outs = lockstep.progressive_poa_split_batch(seq_sets, weight_sets, abpt,
                                                churn=churn)
    texts = [None if o is None else port_text(abpt, o[0], reads, o[1])
             for reads, o in zip(seq_sets, outs)]
    return texts, outs


def set_by_set(reads, **kw) -> str:
    """The port's output of one set on its single-set route."""
    abpt = port_params(**kw)
    records = [SeqRecord(f"r{i}", "", "".join("ACGT"[b] for b in r))
               for i, r in enumerate(reads)]
    buf = io.StringIO()
    msa(Abpoa(), abpt, records, buf)
    return buf.getvalue()


def grid_case(gap, k):
    rng = np.random.default_rng(123 + k)
    seq_sets, weight_sets = random_sets(rng, [3, 6, 2, 5][:k])
    want, _ = jax_split(seq_sets, weight_sets, **GAPS[gap])
    rounds = lockstep.stats["rounds"]
    got, _ = port_split(seq_sets, weight_sets, **GAPS[gap])
    assert lockstep.stats["rounds"] - rounds == max(len(s) for s in seq_sets)
    for i, reads in enumerate(seq_sets):
        assert got[i] == want[i], f"set {i} (K={k}, {gap})"
        assert got[i] == set_by_set(reads, **GAPS[gap])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_split_lockstep_parity_grid_convex(k):
    grid_case("convex", k)


def data_sets(abpt, names):
    seq_sets, weight_sets = [], []
    for fn in names:
        seqs, weights = _ingest_records(
            Abpoa(), abpt, read_fastx(os.path.join(DATA_DIR, fn)))
        seq_sets.append(seqs)
        weight_sets.append(weights)
    return seq_sets, weight_sets


def test_split_lockstep_data_files():
    """seq.fa, test.fa and heter.fa as one group of three lanes."""
    seq_sets, weight_sets = data_sets(port_params(),
                                      ("seq.fa", "test.fa", "heter.fa"))
    want, _ = jax_split(seq_sets, weight_sets)
    got, _ = port_split(seq_sets, weight_sets)
    for i, fn in enumerate(("seq.fa", "test.fa", "heter.fa")):
        assert got[i] == want[i], fn
    with open(os.path.join(DATA_DIR, "..", "golden", "ref_consensus.txt")) as fp:
        assert got[0] == fp.read()
