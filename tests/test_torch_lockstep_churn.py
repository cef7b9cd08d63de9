"""The split lockstep driver's lane churn and the scheduler, twins of
tests/test_lockstep_split.py's churn and scheduler cases, on the CPU:
- a joiner boarding at the first, a middle and the last round, an
  amb-strand joiner, an eviction, an off-rung joiner and a duplicate lane:
  every result equals its set's own run on the port's set-by-set route and
  the JAX package's host loop, and a short lane retires the round its last
  read fuses;
- the query and lane rungs and the grouping by query rung (== JAX's);
- the routes of `plan_route` (lockstep on cuda by default, on cpu when
  asked for; serial otherwise, Z-drop included; map on either device),
  K from ABPOA_TPU_LOCKSTEP_K, and the live lanes of the rounds of a group
  whose sets drain at different rounds.
"""
import io

import numpy as np
import pytest
import torch

from abpoa_tpu_torch.align.buckets import qp_rung
from abpoa_tpu_torch.parallel import lockstep, scheduler
from abpoa_tpu_torch.parallel.runner import _lockstep_ok

from test_torch_dp_chunk import jax_params, port_params, random_sets
from test_torch_lockstep import data_sets, port_split, port_text, set_by_set

torch.set_num_threads(1)


def jax_host(reads, **kw) -> str:
    """The JAX package's host loop on one set (its CLI's route on the CPU)."""
    from abpoa_tpu.cons.consensus import generate_consensus
    from abpoa_tpu.io.output import output_fx_consensus
    from abpoa_tpu.pipeline import Abpoa, poa
    abpt = jax_params("numpy", **kw)
    ab = Abpoa()
    for r in reads:
        ab.append_read(seq="x" * len(r))
    poa(ab, abpt, reads, [np.ones(len(r), np.int64) for r in reads], 0)
    buf = io.StringIO()
    output_fx_consensus(generate_consensus(ab.graph, abpt, len(reads)),
                        abpt, buf)
    return buf.getvalue()


class ScriptedChurn(lockstep.ChurnHook):
    """Boards scripted joiners and evicts lanes at fixed rounds, and
    records each retire as (result, round)."""

    def __init__(self, joins=None, evict_at=None):
        self.joins = dict(joins or {})
        self.evict_at = dict(evict_at or {})
        self.retired = {}

    def on_round(self, round_i, live_sids):
        return (self.evict_at.pop(round_i, set()),
                self.joins.pop(round_i, []))

    def on_retire(self, sid, result, round_i):
        assert sid not in self.retired, f"double retire for lane {sid}"
        self.retired[sid] = (result, round_i)


@pytest.mark.parametrize("join_round", [1, 4, 8], ids=["first", "mid", "last"])
def test_churn_joiner_parity(join_round):
    rng = np.random.default_rng(2026)
    seq_sets, weight_sets = random_sets(rng, [3, 8])
    j_sets, j_wsets = random_sets(rng, [4], qlen_hi=120)
    hook = ScriptedChurn(joins={join_round: [(100, j_sets[0], j_wsets[0])]})
    texts, _ = port_split(seq_sets, weight_sets, churn=hook)
    for i in (0, 1):
        assert texts[i] == set_by_set(seq_sets[i]) == jax_host(seq_sets[i])
    assert hook.retired[0][1] == 3 and hook.retired[1][1] == 8
    res, r = hook.retired[100]
    assert r == join_round + 3
    got = port_text(port_params(), res[0], j_sets[0])
    assert got == set_by_set(j_sets[0]) == jax_host(j_sets[0])


def test_churn_amb_strand_joiner():
    seq_sets, weight_sets = data_sets(port_params(amb_strand=True),
                                      ("rcmix.fa",))
    hook = ScriptedChurn(joins={2: [(7, seq_sets[0], weight_sets[0])]})
    texts, outs = port_split(seq_sets, weight_sets, churn=hook,
                             amb_strand=True)
    (graph, is_rc), _ = hook.retired[7]
    assert any(is_rc) and is_rc == outs[0][1]
    want = set_by_set(seq_sets[0], amb_strand=True)
    assert texts[0] == want
    assert port_text(port_params(amb_strand=True), graph, seq_sets[0],
                     is_rc) == want


def test_churn_evict_off_rung_and_duplicate():
    rng = np.random.default_rng(5)
    seq_sets, weight_sets = random_sets(rng, [3, 5])
    Qp = qp_rung(max(len(s) for ss in seq_sets for s in ss))
    long_read = rng.integers(0, 4, Qp + 10).astype(np.uint8)
    hook = ScriptedChurn(joins={2: [(50, [long_read],
                                     [np.ones(len(long_read), np.int64)])]},
                         evict_at={2: {0}})
    texts, outs = port_split(seq_sets, weight_sets, churn=hook)
    assert outs[0] is None and 0 not in hook.retired
    assert hook.retired[50] == (None, 2)
    assert texts[1] == set_by_set(seq_sets[1]) == jax_host(seq_sets[1])
    hook2 = ScriptedChurn(joins={1: [(0, seq_sets[0], weight_sets[0])]})
    with pytest.raises(ValueError, match="duplicate"):
        port_split(seq_sets, weight_sets, churn=hook2)


# ---- the scheduler ---------------------------------------------------------------

def test_rungs_and_grouping_match_jax():
    """`qp_rung`, `k_rung` and `partition_by_length_bucket` (the lockstep
    groups: one query rung each) equal the JAX package's."""
    from abpoa_tpu.align.fused_loop import partition_by_length_bucket as jax_part
    from abpoa_tpu.compile.ladder import k_rung as jax_k, qp_rung as jax_qp
    from abpoa_tpu_torch.align.buckets import k_rung, partition_by_length_bucket
    for k in range(1, 70):
        assert k_rung(k) == jax_k(k)
    for q in (1, 126, 127, 500, 1500, 9855, 9856, 10000, 20000):
        assert qp_rung(q) == jax_qp(q)
    rng = np.random.default_rng(3)
    entries = [(i, [np.zeros(int(n), np.uint8) for n in rng.integers(50, 3000, 3)])
               for i in range(12)]
    assert [[e[0] for e in g] for g in partition_by_length_bucket(entries)] == \
        [[e[0] for e in g] for g in jax_part(entries)]


def test_plan_route_kinds():
    cpu = port_params()
    assert cpu.lockstep == "auto" and not _lockstep_ok(cpu)
    assert scheduler.plan_route(cpu, 4).kind == "serial"
    on = port_params(lockstep="on")
    r = scheduler.plan_route(on, 4)
    assert (r.kind, r.k_cap, r.code) == ("lockstep", 8, "eligible")
    for kw in ({"lockstep": "off"}, {"lockstep": "on", "wb": -1},
               {"lockstep": "on", "inc_path_score": True},
               {"lockstep": "on", "incr_fn": "x.gfa"},
               {"lockstep": "on", "disable_seeding": False},
               {"lockstep": "on", "align_mode": 2, "zdrop": 100}):
        assert scheduler.plan_route(port_params(**kw), 4).kind == "serial", kw
    assert scheduler.plan_route(on, 0).code == "empty"
    m = scheduler.plan_route(cpu, 8, workload="map")
    assert (m.kind, m.k_cap) == ("map", 8)


@pytest.mark.parametrize("dev, kw, env, want", [
    ("cpu", {}, "", "split"),
    ("cuda", {}, "", "device"),
    ("cuda", {"align_mode": 2, "zdrop": 100}, "", "device"),
    ("cuda", {"align_mode": 1}, "", "split"),
    ("cpu", {}, "device", "device"),
    ("cuda", {}, "split", "split")],
    ids=["cpu", "card", "card-extend", "card-local", "cpu-env", "card-env"])
def test_lockstep_impl(dev, kw, env, want, monkeypatch):
    """The implementation by device and mode (the card: the device
    lockstep but in local mode), ABPOA_TPU_LOCKSTEP_IMPL over both; the
    route's reason names it."""
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", env)
    abpt = port_params(lockstep="on", **kw)
    abpt.torch_device = torch.device(dev)   # only the type is read
    assert scheduler.lockstep_impl(abpt) == want
    r = scheduler.plan_route(abpt, 4)
    assert r.kind == "lockstep" and r.reason == f"{want} k=8"


def test_lockstep_auto_is_on_for_the_card(monkeypatch):
    from abpoa_tpu_torch.parallel.runner import lockstep_enabled
    abpt = port_params()
    assert not lockstep_enabled(abpt)
    abpt.torch_device = torch.device("cuda", 0)   # only the type is read
    assert lockstep_enabled(abpt)
    abpt.lockstep = "off"
    assert not lockstep_enabled(abpt)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_K", "4")
    abpt = port_params(lockstep="on")
    assert scheduler.plan_route(abpt, 9).k_cap == 4
    assert scheduler.plan_route(abpt, 9, workload="map").k_cap == 4


def test_drain_rounds_feed_occupancy():
    """A group whose sets drain at different rounds has fewer live lanes
    in its last rounds (`lockstep.stats`)."""
    rng = np.random.default_rng(9)
    seq_sets, weight_sets = random_sets(rng, [2, 6])
    before = dict(lockstep.stats)
    port_split(seq_sets, weight_sets)
    rounds = lockstep.stats["rounds"] - before["rounds"]
    live = lockstep.stats["live_lanes"] - before["live_lanes"]
    assert (rounds, live) == (6, 2 * 2 + 4 * 1)
