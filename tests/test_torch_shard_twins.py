"""The sharded route on the card, with the one card listed twice as the
mesh, (cuda:0, cuda:0): the twins of test_torch_shard.py's order and
round tests. They catch what the CPU cannot show: on the card each slot's
X1w output comes back through the page-locked staging buffer
(`banded._to_host`), so two slots' copies in one round must land in parts
of it that no other copy overwrites before their results are read.
- one sharded round of the split driver's chunk queues B2 on both slots
  before its first host sync, and each lane's result == the unsharded
  round's on the card == the CPU's;
- the split driver, the device lockstep and the map route over the mesh
  == their unsharded runs on the card and on the CPU (every graph array,
  the strand flags, the GAF); the device lockstep queues both groups' B1
  lane launches before its first sync; the map graph's half is uploaded
  once to the one card.
This file imports no JAX, so the card machine collects it; without a card
every test skips.

    pytest -m cuda tests/test_torch_shard_twins.py    # on the card
"""
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import convert
from abpoa_tpu_torch.align import banded, dp_chunk
from abpoa_tpu_torch.align import fused_lanes as fla
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.io.fastx import read_fastx
from abpoa_tpu_torch.parallel import lockstep, map_driver
from abpoa_tpu_torch.params import Params

FILES = ("seq.fa", "test.fa", "heter.fa", "rcmix.fa", "seq4.fa")


@pytest.fixture(scope="module", autouse=True)
def _card_present():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _mesh():
    return (torch.device("cuda", 0),) * 2


def _params(device, **kw):
    return Params(device=device, **kw).finalize()


def _sets(abpt, n_reads=6):
    out = []
    for f in FILES:
        recs = read_fastx(os.path.join(DATA_DIR, f))[:n_reads]
        s = [abpt.char_to_code[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
             .astype(np.uint8) for r in recs]
        out.append((s, [np.ones(len(x), dtype=np.int64) for x in s]))
    return out


def _same_graphs(got, want):
    for (a, ra), (b, rb) in zip(got, want):
        x, y = convert.graph_to_numpy(a), convert.graph_to_numpy(b)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert ra == rb


def _graphs_and_queries(abpt):
    """Each set's graph of its reads but the last (the split driver on
    the CPU), and its last read."""
    cpu = _params("cpu")
    sets = _sets(cpu)
    outs = lockstep.progressive_poa_split_batch(
        [s[:-1] for s, _ in sets], [w[:-1] for _, w in sets], cpu)
    return [g for g, _ in outs], [s[-1] for s, _ in sets]


@pytest.mark.cuda
def test_sharded_round_on_one_card_queues_both_slots(monkeypatch):
    import copy
    abpt = _params("cuda")
    graphs, queries = _graphs_and_queries(abpt)
    log = []
    real_b2, real_ok = banded.banded_dp, banded.check_ok

    def b2(*a, **k):
        log.append(("B2", int(a[0].shape[0]), str(a[0].device)))
        return real_b2(*a, **k)

    def ok(t):
        log.append(("sync",))
        return real_ok(t)

    monkeypatch.setattr(banded, "banded_dp", b2)
    monkeypatch.setattr(banded, "check_ok", ok)
    got = dp_chunk.run_dp_chunk(copy.deepcopy(graphs), abpt, queries,
                                mesh=_mesh())
    assert log[:3] == [("B2", 3, "cuda:0"), ("B2", 2, "cuda:0"), ("sync",)]
    want = dp_chunk.run_dp_chunk(copy.deepcopy(graphs), abpt, queries)
    cpu = dp_chunk.run_dp_chunk(copy.deepcopy(graphs), _params("cpu"),
                                queries)
    for a, b, c in zip(got, want, cpu):
        assert a.cigar == b.cigar == c.cigar
        assert a.best_score == b.best_score == c.best_score


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, {"out_msa": True, "amb_strand": True}],
                         ids=["cons", "r2-s"])
def test_split_driver_on_one_card_mesh(flags):
    sets = _sets(_params("cpu", **flags))
    args = ([s for s, _ in sets], [w for _, w in sets])
    got = lockstep.progressive_poa_split_batch(*args, _params("cuda", **flags),
                                               mesh=_mesh())
    want = lockstep.progressive_poa_split_batch(*args, _params("cpu", **flags))
    _same_graphs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, {"out_msa": True, "amb_strand": True}],
                         ids=["cons", "r2-s"])
def test_device_lockstep_on_one_card_mesh(flags, monkeypatch):
    sets = _sets(_params("cpu", **flags))
    args = ([s for s, _ in sets], [w for _, w in sets])
    log = []
    real_b1, real_sync = fla.fused_dp_lanes, tfl._sync_read

    def b1(*a, **k):
        log.append(("B1", int(a[0].shape[0])))
        return real_b1(*a, **k)

    def sync(t):
        log.append(("sync",))
        return real_sync(t)

    monkeypatch.setattr(fla, "fused_dp_lanes", b1)
    monkeypatch.setattr(tfl, "_sync_read", sync)
    got = fla.progressive_poa_fused_batch(*args, _params("cuda", **flags),
                                          mesh=_mesh())
    assert log[:3] == [("B1", 3), ("B1", 2), ("sync",)]
    want = fla.progressive_poa_fused_batch(*args, _params("cpu", **flags))
    _same_graphs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k_cap", [3, 10])
def test_map_on_one_card_mesh(k_cap):
    from abpoa_tpu_torch.io.gaf import gaf_record
    texts = []
    for device, mesh in (("cuda", _mesh()), ("cuda", None), ("cpu", None)):
        abpt = _params(device, amb_strand=True)
        _ab, static = map_driver.load_static_graph(
            os.path.join(DATA_DIR, "seq10.gfa"), abpt)
        recs = read_fastx(os.path.join(DATA_DIR, "seq.fa"))
        qs = [abpt.char_to_code[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
              .astype(np.uint8) for r in recs]
        uploads = dp_chunk.stats["static_uploads"]
        out = map_driver.map_reads_split(static, qs, abpt, k_cap=k_cap,
                                         mesh=mesh)
        if mesh is not None:
            assert dp_chunk.stats["static_uploads"] - uploads == 1
        texts.append("".join(gaf_record(r.name, q, res, static.base_by_nid,
                                        strand) + "\n"
                             for r, q, (res, strand) in zip(recs, qs, out)))
    assert texts[0] == texts[1] == texts[2] and texts[0].count("\n") == 10
