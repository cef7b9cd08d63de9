"""The sharded route (`abpoa_tpu_torch/parallel/shard.py`) on the CPU, a
mesh of n x cpu standing in for n cards:
- the mesh request grammar (tests/test_shard.py's cases), discovery (None
  for 0 and 1, n x cpu on the CPU, a RuntimeError naming both counts for
  cards that are not there) and the balanced contiguous split;
- the scheduler: `sharded` K = 16 over a mesh of 2 for consensus (split
  and device lockstep) and map, JAX's reason strings, and a mesh of 0 off;
- the sharded round itself: `shard_dp_round` on tests/test_shard.py's map
  fixture, each lane's AlignResult == JAX's `shard_dp_round` lane on its
  virtual CPU mesh; with overflowed lanes relaunched on their own slot;
  `shard_dp_batch`'s H planes == the one-device step's;
- uneven splits: 3 sets over meshes of 2 and 4 (a slot left empty) and 5
  over 4, in the split driver and the device lockstep, == the unsharded
  run; the device lockstep with tiny capacities over a mesh of 2, growth
  in one group only, == each set's single-set run;
- `-l --lockstep on` over five sets with `--mesh 2` and `--mesh 4`
  (uneven slices) == the unsharded run, and `--mesh 1` plans no mesh;
  `map -s` on eight reads with `-K 3 --mesh 2` and `--mesh 4` == the
  unsharded GAF, the graph half uploaded once a device;
- a seeded read's windows split over (cpu, cpu) and (cpu, cpu, cpu) ==
  the unsplit run, overflow relaunches included, and the seeded route end
  to end with its windows split;
- the order of launches and syncs: in one sharded round B2 is queued on
  every slot before the first host sync, and in the device lockstep each
  group's B1 lane launch before any group's sync, with at most one sync a
  group a round beyond `-s` and Kahn.
The CLI's `--mesh` runs against the JAX CLI are in test_torch_shard_cli.py.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import constants as C
from abpoa_tpu_torch.align import banded, dp_chunk, dispatch
from abpoa_tpu_torch.align import fused_lanes as fla
from abpoa_tpu_torch.align import fused_loop as tfl
from abpoa_tpu_torch.params import Params
from abpoa_tpu_torch import cli
from abpoa_tpu_torch.parallel import lockstep, runner, scheduler, shard

from test_torch_dp_chunk import jax_graphs, port_graphs, random_sets, same
from test_torch_fused_batch import assert_same_graph, sim_set
from test_torch_map import sim_graph  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")


def mesh(n):
    return (CPU,) * n


def port_params(**kw):
    abpt = Params(device="cpu")
    for k, v in kw.items():
        setattr(abpt, k, v)
    return abpt.finalize()


# ---- the mesh: grammar, discovery, split ---------------------------------

def test_requested_mesh_size_parsing(monkeypatch):
    monkeypatch.delenv("ABPOA_TPU_MESH", raising=False)
    assert shard.requested_mesh_size() == 0
    monkeypatch.setenv("ABPOA_TPU_MESH", "8")
    assert shard.requested_mesh_size() == 8
    monkeypatch.setenv("ABPOA_TPU_MESH", "0")
    assert shard.requested_mesh_size() == 0
    monkeypatch.setenv("ABPOA_TPU_MESH", "garbage")
    assert shard.requested_mesh_size() == 0
    monkeypatch.setenv("ABPOA_TPU_MESH", "-3")
    assert shard.requested_mesh_size() == 0
    # an explicit CLI value wins over the env var
    assert shard.requested_mesh_size(cli=4) == 4
    assert shard.requested_mesh_size(cli=0) == 0


def test_discover_mesh(monkeypatch):
    monkeypatch.delenv("ABPOA_TPU_MESH", raising=False)
    assert shard.discover_mesh(0, "cpu") is None
    assert shard.discover_mesh(1, "cpu") is None
    assert shard.discover_mesh(None, "cpu") is None
    assert shard.discover_mesh(3, "cpu") == mesh(3)
    monkeypatch.setenv("ABPOA_TPU_MESH", "2")
    assert shard.discover_mesh(None, CPU) == mesh(2)
    assert shard.mesh_size(None) == 1 and shard.mesh_size(mesh(3)) == 3


def test_discover_mesh_raises_without_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have + 1 if have >= 1 else 2
    with pytest.raises(RuntimeError,
                       match=f"mesh of {n} devices requested but {have} "):
        shard.discover_mesh(n, "cuda")


@pytest.mark.parametrize("k,n,want", [
    (8, 2, [(0, 4), (4, 8)]), (5, 4, [(0, 2), (2, 3), (3, 4), (4, 5)]),
    (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]), (0, 2, [(0, 0), (0, 0)])])
def test_split_lanes(k, n, want):
    assert shard.split_lanes(k, n) == want
    parts = shard.mesh_parts(k, mesh(n), CPU)
    assert [ids for _, ids in parts] == [list(range(a, b)) for a, b in want
                                         if b > a]


# ---- the scheduler ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["split", "device"])
def test_plan_route_sharded_consensus(monkeypatch, impl):
    monkeypatch.delenv("ABPOA_TPU_MESH", raising=False)
    monkeypatch.delenv("ABPOA_TPU_LOCKSTEP_K", raising=False)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    abpt = port_params(lockstep="on")
    r = scheduler.plan_route(abpt, 5, mesh=2)
    assert (r.kind, r.k_cap, r.workers, r.code) == ("sharded", 16, 2, "mesh")
    assert r.reason == "sharded K=16 over mesh=2 (2 x per-chip k_cap 8)"
    assert scheduler.plan_route(abpt, 5, mesh=0).kind == "lockstep"
    assert scheduler.plan_route(abpt, 5, mesh=1).kind == "lockstep"
    monkeypatch.setenv("ABPOA_TPU_MESH", "2")
    assert scheduler.plan_route(abpt, 5).kind == "sharded"
    assert scheduler.plan_route(abpt, 5, mesh=0).kind == "lockstep"
    # an ineligible configuration stays serial with a mesh
    assert scheduler.plan_route(port_params(lockstep="off"), 5,
                                mesh=2).kind == "serial"


def test_plan_route_sharded_map_and_jax_reasons(monkeypatch):
    from abpoa_tpu.parallel import scheduler as jsched
    from test_torch_dp_chunk import jax_params
    monkeypatch.delenv("ABPOA_TPU_MESH", raising=False)
    monkeypatch.delenv("ABPOA_TPU_LOCKSTEP_K", raising=False)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "split")
    r = scheduler.plan_route(port_params(), 10, workload="map", mesh=2)
    assert (r.kind, r.k_cap, r.workers) == ("sharded", 16, 2)
    assert scheduler.plan_route(port_params(), 10, workload="map",
                                mesh=0).kind == "map"
    jp = jax_params("jax")
    jp.lockstep = "on"
    jsched.reset()
    jmap = jsched.plan_route(jp, 10, workload="map", mesh=2)
    jcons = jsched.plan_route(jp, 5, mesh=2)
    assert r.reason == jmap.reason
    assert scheduler.plan_route(port_params(lockstep="on"), 5,
                                mesh=2).reason == jcons.reason
    assert (jmap.kind, jcons.kind) == ("sharded", "sharded")


# ---- the sharded round ------------------------------------------------------

def test_shard_dp_round_equals_jax_shard_dp_round():
    """tests/test_shard.py's phase-4 fixture: one static graph, four reads;
    JAX's shard_dp_round over its virtual mesh of 2 and the port's over
    (cpu, cpu) give each lane the same AlignResult."""
    from abpoa_tpu.align.dp_chunk import chunk_plane16, result_from_chunk
    from abpoa_tpu.compile.ladder import plan_chunk_buckets, qp_rung
    from abpoa_tpu.parallel.shard import discover_mesh as jax_mesh
    from abpoa_tpu.parallel.shard import shard_dp_round as jax_round
    from test_shard import _static_graph_and_reads
    jabpt, jg, jstatic, reads = _static_graph_and_reads()
    Qp = qp_rung(max(len(q) for q in reads))
    _qp, W, _local = plan_chunk_buckets(jabpt, Qp - 2)
    stamped = [jstatic.tables_for(q, Qp) for q in reads]
    packed = jax_round(jabpt, stamped, 4, jstatic.R, jstatic.P, Qp, W,
                       chunk_plane16(jabpt, Qp - 2, jstatic.n_rows),
                       jax_mesh(2))
    want = [result_from_chunk(jabpt, packed[k], stamped[k],
                              jstatic.idx2nid)[0] for k in range(len(reads))]
    abpt = port_params()
    static = dp_chunk.StaticGraphTables(port_graphs([jg])[0], abpt)
    uploads = dp_chunk.stats["static_uploads"]
    got = shard.shard_dp_round(None, abpt, reads, mesh(2), static=static)
    assert dp_chunk.stats["static_uploads"] - uploads == 1  # one a device
    for res, w in zip(got, want):
        same(res, w)
    # the same lanes as a K-lane chunk of graphs, one graph a lane
    got = shard.shard_dp_round(port_graphs([jg] * 4), abpt, reads, mesh(3))
    for res, w in zip(got, want):
        same(res, w)


def test_shard_dp_batch_planes_equal_unsharded():
    """`shard_dp_batch` (JAX's runner.shard_dp_batch): B2 once a slot over
    its slice of five sets' stacked tables, each set's H plane == the
    one-device step's."""
    from abpoa_tpu_torch.align.tables import build_row_tables
    rng = np.random.default_rng(9)
    sets, _ = random_sets(rng, [3, 2, 4, 3, 2])
    jg, queries = jax_graphs(sets)
    abpt = port_params()
    graphs = port_graphs(jg)
    for g in graphs:
        g.topological_sort(abpt)
    tabs = [build_row_tables(g, C.SRC_NODE_ID, C.SINK_NODE_ID, abpt)
            for g in graphs]
    mesh2, step2 = shard.shard_dp_batch(2, "cpu")
    mesh1, step1 = shard.shard_dp_batch(1, "cpu")
    assert (mesh2, mesh1) == (mesh(2), None)
    got, want = step2(abpt, tabs, queries, 256), step1(abpt, tabs, queries,
                                                       256)
    assert [tuple(h.shape) for h in got] == [(t.gn, 256) for t in tabs]
    for h, w, t in zip(got, want, tabs):  # rows 0..gn-2 are computed
        assert torch.equal(h[:t.gn - 1], w[:t.gn - 1])


def test_sharded_chunk_relaunches_on_its_slot(monkeypatch):
    """A first W of 24: each slot relaunches its own overflowed lanes at a
    doubled W; every lane still equals the unsharded chunk's."""
    rng = np.random.default_rng(3)
    sets, _ = random_sets(rng, [3, 2, 4, 3, 2], qlen_lo=40, qlen_hi=400)
    jg, queries = jax_graphs(sets)
    abpt = port_params()
    windows = [(C.SRC_NODE_ID, C.SINK_NODE_ID, q) for q in queries]
    want = banded.align_windows_banded(port_graphs(jg), abpt, windows,
                                       band_width=24)
    sizes = []
    real = banded.run_windows

    def count(abpt_, tabs, queries_, W, graph_half=None, dev=None,
              events=None):
        sizes.append((len(tabs), W))
        return real(abpt_, tabs, queries_, W, graph_half, dev, events)

    monkeypatch.setattr(banded, "run_windows", count)
    retries = banded.retries
    got = banded.align_windows_banded(port_graphs(jg), abpt, windows,
                                      band_width=24, mesh=mesh(2))
    assert banded.retries > retries
    assert sizes[:2] == [(3, 24), (2, 24)]
    assert all(W > 24 for _, W in sizes[2:]) and len(sizes) > 2
    for res, w in zip(got, want):
        same(res, w)


# ---- uneven splits and growth ------------------------------------------------

def _sets(tp, n):
    return [sim_set(tp, 40 + i, 3 + i % 3, length=90 + 25 * i)
            for i in range(n)]


@pytest.mark.parametrize("n,size", [(3, 2), (3, 4), (5, 4)],
                         ids=["3-over-2", "3-over-4", "5-over-4"])
def test_uneven_splits_equal_unsharded(n, size):
    tp = port_params()
    sets = _sets(tp, n)
    seqs, wgts = [s for s, _ in sets], [w for _, w in sets]
    for drive in (lockstep.progressive_poa_split_batch,
                  fla.progressive_poa_fused_batch):
        want = drive(seqs, wgts, tp)
        got = drive(seqs, wgts, tp, mesh=mesh(size))
        for (pg, rc), (wpg, wrc) in zip(got, want):
            assert_same_graph(pg, wpg, f"{drive.__name__} mesh {size}")
            assert rc == wrc


def test_device_lockstep_growth_in_one_group(monkeypatch):
    """Tiny capacities that the short sets of group 0 never outgrow and the
    long sets of group 1 do: group 1 grows alone, and every set's graph
    equals its single-set run."""
    tp = port_params()
    sets = [sim_set(tp, 60, 3, length=20), sim_set(tp, 61, 4, length=24),
            sim_set(tp, 62, 4, length=120), sim_set(tp, 63, 3, length=140)]
    want = [tfl.progressive_poa_fused(s, w, tp) for s, w in sets]
    outs = {}
    real = fla._drive_groups

    def drive(groups, devs):
        res = real(groups, devs)
        outs["caps"] = [c for _, c in res]
        return res

    monkeypatch.setattr(fla, "_drive_groups", drive)
    caps = (64, 4, 2, 32)
    got = fla.progressive_poa_fused_batch([s for s, _ in sets],
                                          [w for _, w in sets], tp,
                                          init_caps=caps, mesh=mesh(2))
    g0, g1 = outs["caps"]
    assert (g0["N"], g0["E"], g0["A"], g0["W"]) == caps
    assert g1["N"] > caps[0]
    for (pg, rc), (wpg, _, wrc) in zip(got, want):
        assert_same_graph(pg, wpg, "growth in one group")
        assert rc == wrc


# ---- through the CLI: uneven meshes ------------------------------------------

@pytest.fixture
def meshes(monkeypatch):
    """The meshes the `-l` groups ran over; ABPOA_TPU_MESH, which the CLI
    writes, undone after the test (setenv, since delenv records nothing
    for an unset variable)."""
    monkeypatch.setenv("ABPOA_TPU_MESH", "0")
    seen = []
    real = runner.flush_lockstep_group

    def flush(group, abpt, mesh=None):
        seen.append(mesh)
        return real(group, abpt, mesh)

    monkeypatch.setattr(runner, "flush_lockstep_group", flush)
    return seen


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    os.environ.pop("ABPOA_TPU_MESH", None)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("impl", ["split", "device"])
def test_list_uneven_meshes_equal_unsharded(tmp_path, monkeypatch, meshes,
                                            impl):
    from abpoa_tpu_torch.io.fastx import read_fastx
    recs = read_fastx(os.path.join(DATA_DIR, "seq.fa"))
    files = [os.path.join(DATA_DIR, f) for f in ("seq.fa", "test.fa",
                                                   "seq4.fa")]
    for n in (5, 3):  # two more sets: seq.fa's first reads
        files.append(str(tmp_path / f"seq_{n}.fa"))
        with open(files[-1], "w") as fp:
            fp.write("".join(f">{r.name}\n{r.seq}\n" for r in recs[:n]))
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f + "\n" for f in files))
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    argv = [str(lst), "-l", "-r", "1", "--device", "cpu", "--lockstep", "on"]
    want = _run(cli.main, argv)
    assert want[0] == 0 and want[1]
    for n in ("2", "4"):
        meshes.clear()
        assert _run(cli.main, argv + ["--mesh", n])[:2] == want[:2]
        assert meshes and all(m == (CPU,) * int(n) for m in meshes)
    for n in ("1",):
        meshes.clear()
        assert _run(cli.main, argv + ["--mesh", n])[:2] == want[:2]
        assert meshes and all(m is None for m in meshes)


def test_map_uneven_meshes_equal_unsharded(sim_graph, tmp_path, meshes):  # noqa: F811
    gfa, reads = sim_graph
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    argv = ["map", "-g", gfa, str(fa), "--device", "cpu", "-s"]
    want = _run(cli.main, argv)
    assert want[0] == 0 and len(want[1].splitlines()) == len(reads)
    for extra in (["-K", "3", "--mesh", "2"], ["--mesh", "4"]):
        dp_chunk.reset_stats()
        assert _run(cli.main, argv + extra)[:2] == want[:2]
        assert dp_chunk.stats["static_builds"] == 1
        assert dp_chunk.stats["static_uploads"] == 1  # one device: the CPU


# ---- a seeded read's windows -------------------------------------------------

def _sim2k_file(tmp_path, n):
    from abpoa_tpu_torch.io.fastx import read_fastx
    recs = read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))[:n]
    fa = tmp_path / f"sim2k_{n}.fa"
    fa.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    return str(fa)


SEEDED = ["--device", "cpu", "-S", "-k", "11", "-w", "5", "-n", "50"]


def test_seeded_windows_split_equal_unsplit(monkeypatch, tmp_path, capsys):
    """sim2k's 4th read's windows (-S -k 11 -w 5 -n 50) on the graph of the
    first three: split over 2 and 3 slots, from the first W and from W =
    32 (overflow relaunches on each slot), == the unsplit launches."""
    import copy
    from abpoa_tpu_torch import cli
    calls = []
    real = dispatch.align_windows

    def record(g, abpt, windows, mesh=None):
        calls.append((copy.deepcopy(g), abpt, list(windows)))
        return real(g, abpt, windows, mesh)

    monkeypatch.setattr(dispatch, "align_windows", record)
    assert cli.main([_sim2k_file(tmp_path, 4), *SEEDED]) == 0
    capsys.readouterr()
    g, abpt, windows = calls[-1]
    assert len(windows) >= 4
    for W in (None, 32):
        want = banded.align_windows_banded(copy.deepcopy(g), abpt, windows, W)
        for n in (2, 3):
            got = banded.align_windows_banded(copy.deepcopy(g), abpt,
                                              windows, W, mesh=mesh(n))
            for res, w in zip(got, want):
                same(res, w)


def test_seeded_route_with_split_windows(monkeypatch, tmp_path, capsys):
    """The seeded route end to end (-S -k 11 -w 5 -n 50 -r 2 on sim2k's
    first 5 reads) with every read's windows split over (cpu, cpu): the
    output equals the unsplit run's."""
    from abpoa_tpu_torch import cli
    argv = [_sim2k_file(tmp_path, 5), *SEEDED, "-r", "2"]
    assert cli.main(argv) == 0
    want = capsys.readouterr().out
    real = dispatch.align_windows
    split = []

    def split_windows(g, abpt, windows, mesh_=None):
        split.append(len(windows))
        return real(g, abpt, windows, mesh(2))

    monkeypatch.setattr(dispatch, "align_windows", split_windows)
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == want
    assert split and max(split) >= 2


def test_window_mesh_is_off_on_the_cpu():
    assert dispatch.window_mesh(port_params(), 8) is None


# ---- the order of launches and syncs -----------------------------------------

def test_sharded_round_queues_b2_on_every_slot_before_a_sync(monkeypatch):
    rng = np.random.default_rng(5)
    sets, _ = random_sets(rng, [3, 2, 4, 3, 2])
    jg, queries = jax_graphs(sets)
    abpt = port_params()
    log = []
    real_b2, real_ok = banded.banded_dp, banded.check_ok

    def b2(*a, **k):
        log.append(("B2", int(a[0].shape[0])))
        return real_b2(*a, **k)

    def ok(t):
        log.append(("sync",))
        return real_ok(t)

    monkeypatch.setattr(banded, "banded_dp", b2)
    monkeypatch.setattr(banded, "check_ok", ok)
    got = dp_chunk.run_dp_chunk(port_graphs(jg), abpt, queries, mesh=mesh(3))
    assert log[:4] == [("B2", 2), ("B2", 2), ("B2", 1), ("sync",)]
    log.clear()
    want = dp_chunk.run_dp_chunk(port_graphs(jg), abpt, queries)
    assert log[:2] == [("B2", 5), ("sync",)]
    for res, w in zip(got, want):
        same(res, w)


@pytest.mark.parametrize("amb", [False, True], ids=["cons", "s"])
def test_device_lockstep_queues_every_group_before_a_sync(monkeypatch, amb):
    tp = port_params(amb_strand=amb)
    sets = _sets(tp, 5)
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
    tfl.reset_stats()
    got = fla.progressive_poa_fused_batch([s for s, _ in sets],
                                          [w for _, w in sets], tp,
                                          mesh=mesh(2))
    assert log[:3] == [("B1", 3), ("B1", 2), ("sync",)]
    # one sync a group a round (its flags), one more with `-s` (its
    # scores) and one with a Kahn repair; rounds are summed over the groups
    s = tfl.stats
    assert s["syncs"] <= s["rounds"] * (1 + amb) + s["kahn_rounds"]
    log.clear()
    want = fla.progressive_poa_fused_batch([s for s, _ in sets],
                                           [w for _, w in sets], tp)
    assert log[:2] == [("B1", 5), ("sync",)]
    for (pg, rc), (wpg, wrc) in zip(got, want):
        assert_same_graph(pg, wpg, "ordering")
        assert rc == wrc
