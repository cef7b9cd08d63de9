"""The port's telemetry flags and subcommands (`abpoa_tpu_torch/cli.py`)
on the CPU, against the JAX CLI and against the same runs without them.

- `--report` on tests/data/seq.fa: the phase names of the JAX CLI's fused
  route (`--device jax`, as tests/test_obs.py runs it), and equal
  `reads.count`, `dp.cells`, `dp.cell_ops` (exact); the counters only one
  side emits are listed with their reason;
- `--report`/`--trace`/`--metrics` leave the output bytes, the fused loop's
  host syncs and the per-read and lockstep launch tallies unchanged on the
  fused, split, device-lockstep and map routes; the rounds timeline's
  samples equal each route's round counter;
- `--profile-dir` writes a torch.profiler trace holding `fused_loop`;
- `report` and `report --diff` render; `warm` without a card is one line
  and rc 1.
Every report, trace, metrics, archive and ledger path lies in tmp_path.
"""
import importlib
import json
import os

import pytest
import torch

from conftest import DATA_DIR

from abpoa_tpu_torch import cli
from abpoa_tpu_torch.align import banded
from abpoa_tpu_torch.align import fused_loop as fl
from abpoa_tpu_torch.obs import metrics as pm
from abpoa_tpu_torch.obs import rounds as prounds
from abpoa_tpu_torch.parallel import lockstep, map_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = os.path.join(DATA_DIR, "seq.fa")

# counters of the JAX fused route the port does not emit, with the reason
JAX_ONLY = {
    "compile.misses": "the XLA compile of run_fused_chunk; the port "
                      "compiles nothing at run time and on the CPU loads "
                      "no kernel library",
    "compile.hits": "as compile.misses, on a warm jit cache",
    "fused.dispatch.xla": "which jitted variant (XLA scan or Pallas) ran a "
                          "chunk; the port has one loop, its kernels or "
                          "their plain versions by the tensors' device",
}
# counters of the port's fused route the JAX route does not emit
PORT_ONLY: dict = {}


@pytest.fixture(autouse=True)
def _pinned(tmp_path, monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    monkeypatch.setenv("ABPOA_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.chdir(ROOT)   # list.txt names its files from the root
    yield
    pm.stop_textfile_exporter(final_write=False)


def _run(argv, capsys) -> str:
    assert cli.main(argv) == 0
    return capsys.readouterr().out


def test_report_matches_jax_fused_route(tmp_path, capsys):
    from abpoa_tpu.cli import main as jmain
    jr, pr = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jout, pout = str(tmp_path / "j.fa"), str(tmp_path / "p.fa")
    assert jmain([SEQ, "--device", "jax", "--report", jr, "-o", jout]) == 0
    assert cli.main([SEQ, "--device", "cpu", "--report", pr,
                     "-o", pout]) == 0
    capsys.readouterr()
    with open(jout) as a, open(pout) as b:
        assert a.read() == b.read()
    with open(jr) as fp:
        j = json.load(fp)
    with open(pr) as fp:
        p = json.load(fp)
    assert tuple(p) == tuple(j)
    assert (p["schema"], p["schema_version"]) == (j["schema"],
                                                  j["schema_version"])
    assert set(p["phases"]) == set(j["phases"]) == {
        "fastx_parse", "backend_init", "align_fused", "consensus", "output"}
    assert p["reads"]["count"] == j["reads"]["count"] == 10
    assert p["reads"]["amortized"] == j["reads"]["amortized"] == 10
    for k in ("dp.cells", "dp.cell_ops", "dp.dispatches", "fused.chunks",
              "fused.kahn_resorts", "fused.collisions"):
        assert p["counters"][k] == j["counters"][k], k
    assert p["values"] == j["values"]
    assert set(j["counters"]) - set(p["counters"]) <= set(JAX_ONLY)
    assert set(p["counters"]) - set(j["counters"]) == set(PORT_ONLY)
    assert p["device"] == {"backend": "torch", "platform": "cpu",
                           "kind": "cpu"}
    assert p["mfu"]["mfu"] is None
    assert p["mfu"]["dp_cells"] == j["mfu"]["dp_cells"]
    assert p["compiles"] is None
    assert not torch.cuda.is_initialized()


def _telemetry(tmp_path, tag: str) -> list:
    return ["--report", str(tmp_path / f"{tag}.json"),
            "--trace", str(tmp_path / f"{tag}.trace.json"),
            "--metrics", str(tmp_path / f"{tag}.prom")]


def _tallies() -> dict:
    return dict(syncs=fl.stats["syncs"], rounds=fl.stats["rounds"],
                b2=banded.stats["launches"], windows=banded.stats["windows"],
                split_rounds=lockstep.stats["rounds"],
                map_rounds=map_driver.stats["rounds"])


def _reset() -> None:
    fl.reset_stats()
    banded.reset_stats()
    lockstep.reset_stats()
    map_driver.reset_stats()
    prounds.reset()


@pytest.mark.parametrize("route,argv,env", [
    ("fused", [SEQ], {}),
    ("per_read", [SEQ, "-b", "-1"], {}),
    ("seeded", [os.path.join(DATA_DIR, "rcmix.fa"), "-S", "-s"], {}),
    ("split", ["-l", os.path.join("tests", "data", "list.txt"),
               "--lockstep", "on"], {"ABPOA_TPU_LOCKSTEP_IMPL": "split"}),
    ("device", ["-l", os.path.join("tests", "data", "list.txt"),
                "--lockstep", "on"], {"ABPOA_TPU_LOCKSTEP_IMPL": "device"}),
])
def test_telemetry_leaves_the_run_unchanged(route, argv, env, tmp_path,
                                            capsys, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = argv + ["--device", "cpu"]
    _reset()
    off = _run(argv, capsys)
    t_off = _tallies()
    _reset()
    on = _run(argv + _telemetry(tmp_path, route), capsys)
    t_on = _tallies()
    assert on == off
    assert t_on == t_off
    with open(tmp_path / f"{route}.json") as fp:
        rep = json.load(fp)
    samples = prounds.snapshot()
    if route == "split":
        assert t_on["split_rounds"] > 0
        assert len(samples) == t_on["split_rounds"]
        assert {"align", "fusion"} <= set(rep["phases"])
        assert rep["counters"]["lockstep.chunks"] == t_on["split_rounds"]
    elif route == "device":
        assert t_on["rounds"] > 0
        assert len(samples) == t_on["rounds"]
        assert "align_fused" in rep["phases"]
        assert rep["counters"]["lockstep.chunks"] == t_on["rounds"]
    else:
        assert samples == []
    if route in ("split", "device"):
        # one group of the two sets, in two length buckets of one set each
        assert rep["counters"]["lockstep.groups"] == 1
        assert rep["values"]["lockstep.group_size"]["max"] == 2
        assert rep["values"]["lockstep.k"] == {"count": 2, "sum": 2,
                                               "min": 1, "max": 1}
        assert rep["counters"]["scheduler.lockstep.eligible"] == 1
    if route in ("per_read", "seeded"):
        assert rep["counters"]["dispatch.cpu"] == t_on["windows"]
        assert {"align", "fusion"} <= set(rep["phases"])
    assert rep["reads"]["count"] > 0 and rep["counters"]["dp.cells"] > 0
    with open(tmp_path / f"{route}.trace.json") as fp:
        names = {e["name"] for e in json.load(fp)["traceEvents"]}
    assert set(rep["phases"]) <= names
    want = {"fused": "fused_chunk", "per_read": "read:1", "seeded": "read:1",
            "split": "dp_chunk", "device": "lockstep_group"}[route]
    assert want in names
    with open(tmp_path / f"{route}.prom") as fp:
        samples, types = pm.parse_exposition(fp.read())
    assert types["abpoa_reads_total"] == "counter"


def test_metrics_exposition_counts_the_runs_reads(tmp_path, capsys):
    pm.reset_registry()
    prom = str(tmp_path / "m.prom")
    _run([SEQ, "--device", "cpu", "--metrics", prom], capsys)
    from abpoa_tpu_torch.obs import top
    with open(prom) as fp:
        samples, _ = top.M.parse_exposition(fp.read())
    assert top.M.sample_value(samples, "abpoa_reads_total",
                              backend="cpu") == 10
    assert top.M.sample_value(samples, "abpoa_runs_total") == 1
    pm.reset_registry()


def test_map_telemetry(tmp_path, capsys):
    gfa = os.path.join(DATA_DIR, "seq10.gfa")
    reads = os.path.join(DATA_DIR, "seq4.fa")
    argv = ["map", "-g", gfa, reads, "-K", "2", "--device", "cpu"]
    _reset()
    off = _run(argv, capsys)
    rounds = map_driver.stats["rounds"]
    _reset()
    on = _run(argv + _telemetry(tmp_path, "map"), capsys)
    assert on == off
    assert map_driver.stats["rounds"] == rounds > 0
    assert len(prounds.snapshot()) == rounds
    with open(tmp_path / "map.json") as fp:
        rep = json.load(fp)
    assert rep["counters"]["map.rounds"] == rounds
    with open(reads) as fp:
        n_reads = fp.read().count(">")
    assert rep["counters"]["map.reads"] == rep["reads"]["count"] == n_reads
    assert {"graph_restore", "fastx_parse", "align"} <= set(rep["phases"])


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    d = tmp_path / "prof"
    _run([os.path.join(DATA_DIR, "seq4.fa"), "--device", "cpu",
          "--profile-dir", str(d)], capsys)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("fused_loop.")
    with open(d / files[0]) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    assert "fused_loop" in names
    capture = importlib.import_module("abpoa_tpu_torch.obs.capture")
    assert capture.profile_dir() is None


def test_report_subcommand(tmp_path, capsys):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _run([SEQ, "--device", "cpu", "--report", a], capsys)
    _run([SEQ, "--device", "cpu", "--report", b, "-b", "-1"], capsys)
    out = _run(["report", a], capsys)
    assert out.startswith("run report (schema v4)")
    assert "align_fused" in out and "dp cells 83,520" in out
    diff = _run(["report", "--diff", a, b], capsys)
    assert diff.startswith("report diff: A=")
    assert "phase.align_fused_s" in diff


def test_report_dash_goes_to_stderr(capsys):
    assert cli.main([SEQ, "--device", "cpu", "--report", "-"]) == 0
    cap = capsys.readouterr()
    assert cap.out.startswith(">Consensus_sequence\n")
    assert json.loads(cap.err[cap.err.index("{"):])["reads"]["count"] == 10


def test_warm_without_card_is_one_line(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card contract is moot")
    assert cli.main(["warm", "--ladder", "quick"]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert len(cap.err.splitlines()) == 1
    assert cap.err.startswith("Error: warm needs a CUDA card")
    assert not os.path.exists(tmp_path / "ledger")
    assert not torch.cuda.is_initialized()


def test_warm_steps_on_the_cpu():
    """`warm`'s steps (the tiers' anchors at a small length) run on the CPU
    through the wrappers' plain versions; `warm_ladder` itself refuses a
    device other than the card."""
    from abpoa_tpu_torch.kernels import warm
    from abpoa_tpu_torch.params import Params
    abpt = Params(device="cpu").finalize()
    anchor = warm.WarmAnchor("small", 300, warm.FULL_TIER[-1].steps, W=256)
    reads = warm.synthetic_reads(anchor.qmax, 4)
    assert [len(r) for r in reads] == [len(r) for r in
                                       warm.synthetic_reads(300, 4)]
    before = warm.launch_counts()
    for step in anchor.steps:
        warm._STEPS[step](abpt, reads, anchor)
    assert warm.launch_counts() == before   # plain versions launch nothing
    assert set(warm.launch_counts()) == {
        "abpoa_fused_dp", "abpoa_backtrack", "abpoa_fuse_alignment",
        "abpoa_finish_fusion", "abpoa_topo_sort", "abpoa_banded_dp",
        "abpoa_unbanded_dp", "abpoa_backtrack_windows"}
    with pytest.raises(RuntimeError, match="CUDA card"):
        warm.warm_ladder("quick", abpt)
