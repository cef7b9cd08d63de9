"""The port's server on its batched routes, on the CPU: coalesced groups
on the device lockstep, the late join on the split driver (continuous
batching), `/map` against a restored graph, `--mesh 2`, and the
scheduler's feedback the server reads; every answer held to the CLI's
bytes (and `/map`'s to the JAX server's).

    JAX_PLATFORMS=cpu pytest tests/test_torch_serve_routes.py
"""
import json
import os
import threading
import time

import pytest

from conftest import DATA_DIR
from torch_serve_helpers import (TEST_FA, base_of, fasta_bytes, get_json,
                                 get_text, port_bytes, port_params,
                                 port_server, post, slow_single)

SEQ_FA = os.path.join(DATA_DIR, "seq.fa")
SEQ4_FA = os.path.join(DATA_DIR, "seq4.fa")
ALLELES_FA = os.path.join(DATA_DIR, "3alleles.fa")
GRAPH = os.path.join(DATA_DIR, "seq10.gfa")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    monkeypatch.delenv("ABPOA_TPU_MESH", raising=False)
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.parallel import scheduler
    obs.metrics.reset_registry()
    rz.inject.reset()
    rz.breaker().reset()
    scheduler.reset()
    yield
    rz.inject.reset()
    rz.breaker().reset()
    scheduler.reset()
    obs.start_run()


def _sets():
    """Four sets of one query rung (128)."""
    from abpoa_tpu_torch.io.fastx import read_fastx
    return [fasta_bytes(read_fastx(p)[:n]) for p, n in
            ((TEST_FA, 4), (SEQ_FA, 10), (ALLELES_FA, 12), (SEQ4_FA, 2))]


def _want(body):
    from abpoa_tpu_torch.io.fastx import read_fastx_text
    return port_bytes(read_fastx_text(body.decode()))


def _post_all(base, bodies, stagger=0.0, **kw):
    res = [None] * len(bodies)

    def send(i):
        res[i] = post(base, bodies[i], **kw)

    threads = []
    for i in range(len(bodies)):
        t = threading.Thread(target=send, args=(i,))
        t.start()
        threads.append(t)
        time.sleep(stagger)
    for t in threads:
        t.join(120)
    return res


def test_coalesced_group_runs_the_device_lockstep(monkeypatch):
    """A busy worker lets three same-rung sets queue; they run as one
    group on the device lockstep (plain versions on the CPU), each answer
    the CLI's bytes."""
    from abpoa_tpu_torch.align import fused_loop as fl
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "device")
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_MIN_QLEN", "0")
    slow_single(monkeypatch, 0.5)
    fl.reset_stats()
    srv = port_server(port_params(lockstep="on"), workers=1)
    base = base_of(srv)
    bodies = _sets()
    try:
        assert srv._lockstep and srv._lockstep_impl == "device"
        assert not srv._churn
        first = threading.Thread(target=lambda: post(base, bodies[0]))
        first.start()
        time.sleep(0.15)                 # the worker sleeps in set 0
        res = _post_all(base, bodies[1:])
        first.join(60)
        samples = get_text(base, "/metrics")
    finally:
        srv.stop()
    for body, (code, out, headers) in zip(bodies[1:], res):
        assert code == 200 and out == _want(body)
    assert fl.stats["rounds"] > 0       # the lanes' rounds ran
    assert "abpoa_lockstep_groups_total 1" in samples
    assert "abpoa_lockstep_noop_fraction" in samples


def _slow_rounds(monkeypatch, delay):
    """Each round of the split driver takes at least `delay` s, so that
    a request can arrive while a group is in flight."""
    from abpoa_tpu_torch.align import dp_chunk
    real = dp_chunk.run_dp_chunk

    def slow(*a, **kw):
        time.sleep(delay)
        return real(*a, **kw)
    monkeypatch.setattr(dp_chunk, "run_dp_chunk", slow)


def test_late_join_is_byte_identical_to_the_static_group(monkeypatch,
                                                          tmp_path):
    """One worker and slow rounds: A opens a group on the split driver, B
    arrives while A is in flight and boards at a round boundary. Both
    answers equal the CLI's bytes and the static group's (churn off, the
    same two requests coalesced at pickup); B's archive record names its
    join round; /healthz shows the open group while A runs."""
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "split")
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_MIN_QLEN", "0")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path))
    _slow_rounds(monkeypatch, 0.2)
    a, b = _sets()[1], _sets()[0]
    srv = port_server(port_params(lockstep="on"), workers=1)
    base = base_of(srv)
    out = {}
    try:
        assert srv._churn
        ta = threading.Thread(target=lambda: out.update(a=post(base, a)))
        ta.start()
        time.sleep(0.5)                 # A mid-flight: 10 reads x 0.2 s
        groups = get_json(base, "/healthz")[1].get("open_groups", [])
        tb = threading.Thread(target=lambda: out.update(b=post(base, b)))
        tb.start()
        ta.join(120)
        tb.join(120)
        expo = get_text(base, "/metrics")
    finally:
        srv.stop()
    assert groups and groups[0]["rung"] == 128
    assert out["a"][0] == 200 and out["a"][1] == _want(a)
    assert out["b"][0] == 200 and out["b"][1] == _want(b)
    from abpoa_tpu_torch.obs import metrics as M
    samples, _ = M.parse_exposition(expo)
    assert M.sample_value(samples, "abpoa_lockstep_joins_total") >= 1
    occ = M.sample_value(samples, "abpoa_lockstep_lane_occupancy")
    assert occ is not None and 0.0 < occ <= 1.0
    with open(tmp_path / "reports.jsonl") as fp:
        recs = [json.loads(ln) for ln in fp]
    joined = [r for r in recs if r.get("join_round") is not None]
    assert len(joined) == 1 and joined[0]["join_round"] >= 2

    # the static group: churn off, both requests queued behind a busy
    # worker and coalesced at pickup
    monkeypatch.setenv("ABPOA_TPU_SERVE_CHURN", "0")
    slow_single(monkeypatch, 0.4)
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    _slow_rounds(monkeypatch, 0.0)
    srv = port_server(port_params(lockstep="on"), workers=1)
    base = base_of(srv)
    try:
        assert not srv._churn
        busy = threading.Thread(target=lambda: post(base, _sets()[3]))
        busy.start()
        time.sleep(0.1)
        static = _post_all(base, [a, b])
        busy.join(60)
    finally:
        srv.stop()
    assert [r[1] for r in static] == [out["a"][1], out["b"][1]]


def _jax_map_server():
    from abpoa_tpu.params import Params
    from abpoa_tpu.serve import AlignServer
    abpt = Params()
    abpt.device = "numpy"
    srv = AlignServer(abpt, port=0, workers=1, map_graph=GRAPH)
    srv.start(warm="off")
    return srv


def test_map_equals_the_map_cli_and_the_jax_server(capsys):
    """POST /map of seq.fa's reads in three requests: the GAF lines equal
    `python -m abpoa_tpu_torch map -g seq10.gfa -K 8` on the same reads,
    and the JAX server's answers."""
    from abpoa_tpu_torch.cli import main
    from abpoa_tpu_torch.io.fastx import read_fastx
    recs = read_fastx(SEQ_FA)
    bodies = [fasta_bytes(recs[i:i + 4]) for i in range(0, len(recs), 4)]
    got = {}
    for tag, make in (("port", lambda: port_server(workers=2,
                                                   map_graph=GRAPH)),
                      ("jax", _jax_map_server)):
        srv = make()
        try:
            assert srv._map_static is not None
            got[tag] = _post_all(base_of(srv), bodies, path="/map")
            health = get_json(base_of(srv), "/healthz")[1]
        finally:
            srv.stop()
        assert health["map_graph"]["path"] == GRAPH
    assert main(["map", "-g", GRAPH, SEQ_FA, "-K", "8",
                 "--device", "cpu"]) == 0
    want = capsys.readouterr().out
    port = [r for r in got["port"]]
    assert all(code == 200 for code, _b, _h in port)
    assert b"".join(b for _c, b, _h in port).decode() == want
    assert [r[1] for r in port] == [r[1] for r in got["jax"]]
    assert [r[2]["X-Abpoa-Reads"] for r in port] == ["4", "4", "2"]


def test_map_graph_leaves_align_untouched():
    """The restore that loads --map-graph does not turn /align requests
    into incremental runs onto that graph: /align answers the CLI's
    bytes."""
    srv = port_server(workers=1, map_graph=GRAPH)
    try:
        code, out, _ = post(base_of(srv), open(TEST_FA, "rb").read())
    finally:
        srv.stop()
    assert code == 200 and out == port_bytes(TEST_FA)
    assert not srv.abpt.incr_fn


@pytest.mark.parametrize("impl", ["split", "device"])
def test_mesh_2_on_the_cpu_equals_no_mesh(monkeypatch, impl):
    """--mesh 2 (two CPU slots): a coalesced group splits its rounds
    over the mesh and each answer equals the unsharded bytes."""
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_MIN_QLEN", "0")
    monkeypatch.setenv("ABPOA_TPU_SERVE_CHURN", "0")
    slow_single(monkeypatch, 0.4)
    srv = port_server(port_params(lockstep="on"), workers=1, mesh=2)
    base = base_of(srv)
    bodies = _sets()
    try:
        assert len(srv._mesh) == 2
        health = get_json(base, "/healthz")[1]
        first = threading.Thread(target=lambda: post(base, bodies[3]))
        first.start()
        time.sleep(0.1)
        res = _post_all(base, bodies[:3])
        first.join(60)
    finally:
        srv.stop()
    assert health["mesh"] == {"devices": 2, "platform": "cpu", "axis": "set"}
    for body, (code, out, _h) in zip(bodies[:3], res):
        assert code == 200 and out == _want(body)


# --------------------------------------------------------------------- #
# the scheduler's feedback (the server's K cap)                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("samples", [
    [0.0, 0.5, 0.75], [0.3], [1.0, 1.0, 0.0], [0.2, 0.2, 0.9, 0.1]])
def test_noop_k_cap_and_ewmas_equal_jax(samples):
    from abpoa_tpu.parallel import scheduler as jsched
    from abpoa_tpu_torch.parallel import scheduler as sched
    for s in (sched, jsched):
        s.reset()
        for f in samples:
            s.observe_lane_occupancy(1.0 - f, route="map")
            s.observe_noop_fraction(f)
    for route in ("lockstep", "map", "sharded"):
        assert sched.noop_ewma(route) == jsched.noop_ewma(route)
        assert sched.occupancy_ewma(route) == jsched.occupancy_ewma(route)
        assert sched.noop_k_cap(8, route=route) == jsched.noop_k_cap(
            8, route=route)
    assert sched._OCC == jsched._OCC
    assert sched.lockstep_min_qlen() == jsched.lockstep_min_qlen() == 1500
    for s in (sched, jsched):
        s.reset()


def test_plan_route_serve_caps_k_by_the_idle_lanes(monkeypatch):
    from abpoa_tpu_torch.parallel import scheduler as sched
    abpt = port_params(lockstep="on").finalize()
    assert sched.plan_route(abpt, 8, serve=True).k_cap == 8
    sched.observe_noop_fraction(0.5)
    assert sched.plan_route(abpt, 8, serve=True).k_cap == 2
    # the -l runner keeps its fixed K
    assert sched.plan_route(abpt, 8).k_cap == 8
    route = sched.plan_route(abpt, 8, serve=True, mesh=2)
    assert route.kind == "sharded" and route.k_cap == 16


def test_drivers_feed_the_ewmas():
    """The split driver's lane table and map's rounds feed the occupancy
    EWMA, the device lockstep the idle-lane EWMA (JAX fused_loop.py:2079,
    lockstep.py:202, map_driver.py:203)."""
    import numpy as np
    from abpoa_tpu_torch.align.fused_lanes import progressive_poa_fused_batch
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.parallel import lockstep, scheduler
    abpt = port_params().finalize()
    sets = []
    for p, n in ((TEST_FA, 4), (SEQ_FA, 6)):
        s = [abpt.char_to_code[np.frombuffer(r.seq.encode(), np.uint8)]
             .astype(np.uint8) for r in read_fastx(p)[:n]]
        sets.append((s, [np.ones(len(x), np.int64) for x in s]))
    lockstep.progressive_poa_split_batch([s for s, _ in sets],
                                         [w for _, w in sets], abpt)
    occ = scheduler._OCC["lockstep"]
    assert occ["n"] > 0 and occ["sum"] < occ["n"]     # a drain tail
    scheduler.reset()
    progressive_poa_fused_batch([s for s, _ in sets], [w for _, w in sets],
                                abpt)
    assert scheduler._NOOP["lockstep"]["seen"]
    assert scheduler.noop_ewma("lockstep") > 0.0
