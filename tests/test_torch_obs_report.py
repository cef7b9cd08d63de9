"""The port's run report (`abpoa_tpu_torch/obs/report.py`, `mfu.py`,
`compile_log.py`, `archive.py`, `ledger.py`) against the JAX package's.

- the schema: SCHEMA, SCHEMA_VERSION, SCHEMA_KEYS and the cell model
  CELL_INT_OPS are equal;
- the same seeded operations (phases, counters, values, DP cells, reads,
  faults) give equal report dicts, and `render_report` and
  `render_report_diff` give the same text on the same dicts (exact);
- the `device` block and the MFU peak: the H100's 16.727e12 int32 ops/s,
  no MFU on the CPU, CUDA never initialised by a CPU run's report;
- the build and load log's `compiles` block;
- `quarantine_set` writes JAX's fault record, and `msa_aligner.last_report`
  has JAX's fields on the same call;
- the archive's record equals JAX's summary of the same report, and the
  ledger's file is the port's own, pinned to tmp_path.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from abpoa_tpu.obs import archive as jarchive
from abpoa_tpu.obs import ledger as jledger
from abpoa_tpu.obs import mfu as jmfu

from abpoa_tpu_torch.obs import archive as parchive
from abpoa_tpu_torch.obs import compile_log as pclog
from abpoa_tpu_torch.obs import ledger as pledger
from abpoa_tpu_torch.obs import mfu as pmfu

# the modules (each package's obs exports a function named `report`)
jrep = importlib.import_module("abpoa_tpu.obs.report")
prep = importlib.import_module("abpoa_tpu_torch.obs.report")

# the report's fields that depend on when and where it was rendered
_VOLATILE = ("created", "total_wall_s", "device", "mfu")


@pytest.fixture(autouse=True)
def _no_run_archive(monkeypatch):
    """The CLI appends no record to the user's run archive, whatever
    another test in this process did to the environment."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")


def test_schema_equals_jax():
    assert prep.SCHEMA == jrep.SCHEMA == "abpoa-tpu-run-report"
    assert prep.SCHEMA_VERSION == jrep.SCHEMA_VERSION == 4
    assert prep.SCHEMA_KEYS == jrep.SCHEMA_KEYS
    assert pmfu.CELL_INT_OPS == jmfu.CELL_INT_OPS
    assert (prep.READS_CAP, prep.FAULTS_CAP) == (jrep.READS_CAP,
                                                  jrep.FAULTS_CAP)


def _drive(rep, seed: int) -> None:
    """The same seeded operations on a RunReport of either package."""
    rng = np.random.default_rng(seed)
    for name in ("fastx_parse", "align", "fusion", "consensus", "output"):
        for _ in range(int(rng.integers(1, 4))):
            rep.merge_phase(name, float(rng.random()) * 0.1)
    for name in ("fused.chunks", "lockstep.chunks", "map.rounds",
                 "scheduler.lockstep.eligible"):
        rep.count(name, int(rng.integers(1, 50)))
    for _ in range(20):
        rep.observe("lockstep.noop_set_fraction", float(rng.random()))
    for _ in range(int(rng.integers(5, 40))):
        rep.record_dp(int(rng.integers(3, 20000)), int(rng.integers(1, 600)),
                      int(rng.integers(0, 3)))
    backends = ("cuda", "cpu")
    for i in range(int(rng.integers(10, 200))):
        rep.record_read(float(rng.lognormal(-5, 1)),
                        int(rng.integers(100, 12000)),
                        int(rng.integers(50, 600)),
                        backends[i % 2], amortized=bool(i % 3))
    if seed % 2:
        rep.record_fault("poisoned_set", set_index=int(rng.integers(0, 9)),
                         detail="PoisonedSetError: empty sequence",
                         action="quarantined")


def _fresh(mod):
    r = mod.RunReport()
    r.reset()
    return r


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_report_dict_and_render_equal_jax(seed):
    a, b = _fresh(jrep), _fresh(prep)
    _drive(a, seed)
    _drive(b, seed)
    da, db = a.as_dict(), b.as_dict()
    assert tuple(db) == prep.SCHEMA_KEYS
    for k in prep.SCHEMA_KEYS:
        if k in _VOLATILE:
            continue
        if k == "faults" and da[k] is not None:
            # t_s is the wall since the report's start: its own clock
            for r in da[k]["records"] + db[k]["records"]:
                r["t_s"] = 0.0
        assert da[k] == db[k], k
    # the same dicts render to the same text in both packages
    for d in (da, db):
        assert prep.render_report(d) == jrep.render_report(d)
    assert (prep.render_report_diff(da, db, "a.json", "b.json")
            == jrep.render_report_diff(da, db, "a.json", "b.json"))
    assert (prep.summary(db).keys() == jrep.summary(da).keys())


def test_render_of_jax_compiles_block_unchanged():
    """A JAX report's `compiles` block (xla_compile_s) renders as JAX
    renders it; the port's (nvcc_build_s) names nvcc."""
    rep = _fresh(jrep).as_dict()
    rep["compiles"] = {"count": 3, "dropped": 0, "misses": 2, "hits": 1,
                       "xla_compile_s": 1.5, "records": []}
    assert prep.render_report(rep) == jrep.render_report(rep)
    rep["compiles"] = {"count": 1, "dropped": 0, "misses": 1, "hits": 0,
                       "nvcc_build_s": 42.25, "records": []}
    assert "1 compiled / 0 cache hits, 42.250s in nvcc" in \
        prep.render_report(rep)


def test_device_block_and_mfu_peak():
    assert pmfu.peak_ops_for_kind("NVIDIA H100 80GB HBM3") == \
        pytest.approx(16.727e12, rel=1e-4)
    assert pmfu.peak_ops_for_kind("cpu") is None
    assert prep._device_info(None) is None
    assert prep._device_info(torch.device("cpu")) == {
        "backend": "torch", "platform": "cpu", "kind": "cpu"}
    r = _fresh(prep)
    r.merge_phase("align_fused", 2.0)
    r.count("dp.cells", 1000)
    r.count("dp.cell_ops", 26000)
    gpu = {"backend": "torch", "platform": "gpu",
           "kind": "NVIDIA H100 80GB HBM3"}
    blk = pmfu.mfu_block(r, gpu)
    assert blk["peak_ops_per_sec"] == pytest.approx(16.727e12, rel=1e-4)
    assert blk["mfu"] == pytest.approx(13000 / 16.727e12, rel=1e-4)
    assert blk["cell_updates_per_sec"] == 500.0
    cpu = pmfu.mfu_block(r, prep._device_info(torch.device("cpu")))
    assert cpu["mfu"] is None and cpu["peak_ops_per_sec"] is None
    # the same cell model as JAX's on the same report
    assert {k: v for k, v in cpu.items()} == jmfu.mfu_block(r, None)


def test_cpu_report_never_initialises_cuda():
    prep.start_run()
    prep.note_device(torch.device("cpu"))
    prep.count("dp.cells", 5)
    rep = prep.finalize_report()
    assert rep["device"]["platform"] == "cpu"
    assert not torch.cuda.is_initialized()


def test_build_and_load_log_block():
    prep.start_run()
    t0 = 0.0
    pclog.record_load("kernels", "/x/libabpoa_kernels_ab.so", True, 12.5, t0)
    pclog.record_load("kernels", "/x/libabpoa_kernels_ab.so", False, 0.0, t0)
    rep = prep.finalize_report()
    comp = rep["compiles"]
    assert (comp["count"], comp["misses"], comp["hits"]) == (2, 1, 1)
    assert comp["nvcc_build_s"] == 12.5
    assert set(comp) == {"count", "dropped", "misses", "hits",
                         "nvcc_build_s", "records"}
    assert comp["records"][0]["bucket"] == {
        "library": "libabpoa_kernels_ab.so"}
    assert rep["counters"]["compile.misses"] == 1
    assert rep["counters"]["compile.hits"] == 1
    prep.start_run()
    assert prep.finalize_report()["compiles"] is None


@pytest.mark.parametrize("exc", [
    ValueError("record 3 (r3): empty sequence"),
    OSError("No such file or directory"),
])
def test_quarantine_fault_record_equals_jax(exc, capsys):
    from abpoa_tpu.resilience.quarantine import quarantine_set as jq
    jr = jrep

    from abpoa_tpu_torch.resilience.quarantine import quarantine_set as pq
    jr.start_run()
    prep.start_run()
    jq(4, "bad.fa", exc)
    pq(4, "bad.fa", exc)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1]
    ja, pa = jr.finalize_report(), prep.finalize_report()
    for r in ja["faults"]["records"] + pa["faults"]["records"]:
        r["t_s"] = 0.0
    assert pa["faults"] == ja["faults"]
    assert pa["counters"]["quarantine.sets"] == \
        ja["counters"]["quarantine.sets"] == 1
    assert "quarantined sets: 1" in prep.render_report(pa)


_SEQS = ["ACGTACGTAACCGGTTACGT", "ACGTACGTACCGGTTACG", "ACGTTCGTAACCGGTAACGT",
         "ACGTACGTAACCGTTACGTA"]


def test_pyapi_last_report_fields_equal_jax():
    from abpoa_tpu.pyapi import msa_aligner as jaligner

    from abpoa_tpu_torch.pyapi import msa_aligner as paligner
    ja, pa = jaligner(device="numpy"), paligner(device="cpu")
    assert pa.last_report is None
    jres = ja.msa(_SEQS, True, False)
    pres = pa.msa(_SEQS, True, False)
    assert pres.cons_seq == jres.cons_seq
    jr, pr = ja.last_report, pa.last_report
    assert tuple(pr) == tuple(jr) == prep.SCHEMA_KEYS
    assert pr["reads"]["count"] == jr["reads"]["count"] == len(_SEQS)
    assert pr["counters"]["dp.cells"] == jr["counters"]["dp.cells"]
    assert pr["counters"]["dp.cell_ops"] == jr["counters"]["dp.cell_ops"]
    assert {"align", "fusion", "consensus"} <= set(pr["phases"])
    assert set(pr["phases"]) == set(jr["phases"])
    assert pr["faults"] is None and pr["degraded"] is None
    assert pr["device"] == {"backend": "torch", "platform": "cpu",
                            "kind": "cpu"}
    # msa_batch reports the whole batch; a poisoned set is its fault
    jb = ja.msa_batch([_SEQS, ["", "ACGT"]], True, False)
    pb = pa.msa_batch([_SEQS, ["", "ACGT"]], True, False)
    assert pb[1] is None and jb[1] is None
    jr, pr = ja.last_report, pa.last_report
    assert pr["reads"]["count"] == jr["reads"]["count"]
    assert pr["faults"]["kinds"] == jr["faults"]["kinds"] == \
        {"poisoned_set": 1}
    # msa_align / msa_add / msa_output: one report over the three calls
    pa.msa_align(_SEQS[:2], True, False)
    pa.msa_add(_SEQS[2:])
    pa.msa_output()
    assert pa.last_report["reads"]["count"] == len(_SEQS)


def test_archive_record_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path))
    r = _fresh(prep)
    _drive(r, 3)
    rep = r.as_dict()
    path = parchive.append_report(rep, label="x.fa", device="cuda")
    assert path == str(tmp_path / "reports.jsonl")
    assert parchive.read_window(0) == [
        jarchive.summarize_report(rep, label="x.fa", device="cuda")]
    monkeypatch.delenv("ABPOA_TPU_ARCHIVE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert parchive.archive_dir() == str(tmp_path / "cache" /
                                         "abpoa_tpu_torch" / "reports")


def test_ledger_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_LEDGER_DIR", str(tmp_path))
    assert pledger.LEDGER_FILE != "PERF_LEDGER.jsonl"
    assert pledger.LEDGER_FILE != jledger.LEDGER_FILE
    rec = pledger.make_record("warm", workload="ladder:quick",
                              device=pledger.device_label("cpu"),
                              compile_misses=0, ts="2026-01-01T00:00:00Z",
                              key="k1")
    jrec = jledger.make_record("warm", workload="ladder:quick", device="cpu",
                               compile_misses=0, ts="2026-01-01T00:00:00Z",
                               key="k1")
    assert rec.keys() == jrec.keys()
    assert pledger.lint_record(rec) == []
    assert rec["device"] == "cpu"
    assert pledger.append_record(rec) == str(tmp_path / pledger.LEDGER_FILE)
    assert pledger.read_window(0) == [rec]
    assert os.listdir(tmp_path) == [pledger.LEDGER_FILE]
