"""The port's metric registry, tracer, rounds timeline, ledger gate and SLO
evaluator (`abpoa_tpu_torch/obs/`) against the JAX package's.

Exact equality throughout, on seeded numpy inputs:
- `LogSketch` quantiles on the same samples;
- the Prometheus exposition text of the same registry operations, and
  `top`'s reader on it;
- the HTTP exporter (bound to an ephemeral port) serves the registry's
  text;
- `perf --gate` and `slo` give the same rc and verdict lines on the same
  ledger and archive records (each directory pinned to tmp_path);
- the rounds timeline's skew summary and the Chrome trace export.
"""
import importlib
import json
import os
import urllib.request

import numpy as np
import pytest

from abpoa_tpu.obs import ledger as jledger
from abpoa_tpu.obs import metrics as jm
from abpoa_tpu.obs import perf as jperf
from abpoa_tpu.obs import rounds as jrounds
from abpoa_tpu.obs import slo as jslo
from abpoa_tpu.obs import top as jtop
from abpoa_tpu.obs import trace as jtrace

from abpoa_tpu_torch.obs import ledger as pledger
from abpoa_tpu_torch.obs import metrics as pm
from abpoa_tpu_torch.obs import perf as pperf
from abpoa_tpu_torch.obs import rounds as prounds
from abpoa_tpu_torch.obs import slo as pslo
from abpoa_tpu_torch.obs import top as ptop
from abpoa_tpu_torch.obs import trace as ptrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def own_families(monkeypatch):
    """Renders hold only the registry's own families: each package's
    process-wide render-time collectors (the device gauges; in the JAX
    package also those its other modules register on import, such as the
    watchdog's) are set aside for the test."""
    monkeypatch.setattr(jm, "_GLOBAL_COLLECTORS", [])
    monkeypatch.setattr(pm, "_GLOBAL_COLLECTORS", [])


@pytest.mark.parametrize("seed", range(6))
def test_log_sketch_quantiles_equal_jax(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(-6 + seed, 1.5, 2000),
                           rng.uniform(1e-7, 5e4, 50)])
    a, b = jm.LogSketch(), pm.LogSketch()
    for v in vals:
        a.observe(float(v))
        b.observe(float(v))
    assert pm.LogSketch.RELATIVE_ERROR == jm.LogSketch.RELATIVE_ERROR
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert b.quantile(q) == a.quantile(q)
    assert (b.count, b.sum, b.min, b.max) == (a.count, a.sum, a.min, a.max)
    m_a, m_b = jm.LogSketch(), pm.LogSketch()
    m_a.merge(a)
    m_b.merge(b)
    assert m_b.counts == m_a.counts


# gauges the registry sets at render time from counter deltas over the
# render's own clock (MetricsRegistry._update_rate_gauges): their values
# differ between two renders, their presence and help text do not
_RATES = ("abpoa_reads_per_second", "abpoa_map_reads_per_second",
          "abpoa_cell_updates_per_second", "abpoa_mfu_ratio")


def _clockless(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if ln.startswith("#") or ln.split(" ")[0] not in _RATES)


def _ops(mod, seed: int) -> str:
    """The same seeded registry operations; returns the exposition."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("abpoa_reads_total", "Reads aligned")
    g = reg.gauge("abpoa_lane_occupancy", "Live lanes over K")
    h = reg.histogram("abpoa_read_wall_seconds", "Per-read wall")
    for i in range(int(rng.integers(50, 300))):
        c.inc(int(rng.integers(1, 5)), backend=("cuda", "cpu")[i % 2])
        g.set(float(rng.random()))
        h.observe(float(rng.lognormal(-4, 1)))
    return reg.render()


@pytest.mark.parametrize("seed", range(4))
def test_exposition_equals_jax(seed, own_families):
    text = _ops(pm, seed)
    assert _clockless(text) == _clockless(_ops(jm, seed))
    assert pm.lint_exposition(text) == jm.lint_exposition(text) == []
    assert pm.parse_exposition(text) == jm.parse_exposition(text)


def test_report_counters_publish_jax_families(own_families):
    """A report counter lands in the same curated family in both."""
    jreg, preg = jm.reset_registry(), pm.reset_registry()
    try:
        for mod in (jm, pm):
            mod.publish_counter("lockstep.chunks", 7)
            mod.publish_counter("dp.cells", 1234)
            mod.publish_counter("map.reads", 50)
            mod.publish_read(0.01, "cuda", None)
            mod.publish_phase("align_fused", 0.5)
        sj, _ = jm.parse_exposition(jreg.render())
        sp, _ = pm.parse_exposition(preg.render())
        for name in ("abpoa_lockstep_chunks_total", "abpoa_dp_cells_total",
                     "abpoa_map_reads_total"):
            assert pm.sample_value(sp, name) == jm.sample_value(sj, name)
        assert pm.sample_value(sp, "abpoa_reads_total", backend="cuda") == 1
        assert ({k for k, _ in sp if k.startswith("abpoa_")}
                == {k for k, _ in sj if k.startswith("abpoa_")})
    finally:
        jm.reset_registry()
        pm.reset_registry()


def test_http_exporter_serves_the_registry():
    reg = pm.reset_registry()
    reg.counter("abpoa_reads_total", "Reads aligned").inc(3, backend="cuda")
    srv = pm.start_http_exporter(0)   # an ephemeral port
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        samples, _ = ptop.M.parse_exposition(body)
        assert pm.sample_value(samples, "abpoa_reads_total",
                               backend="cuda") == 3
    finally:
        srv.shutdown()
        srv.server_close()
        pm.reset_registry()


def test_textfile_exporter_and_top_frame(tmp_path):
    reg = pm.reset_registry()
    try:
        reg.counter("abpoa_reads_total", "Reads aligned").inc(
            5, backend="cuda")
        path = str(tmp_path / "m.prom")
        pm.start_textfile_exporter(path, interval_s=60)
        pm.stop_textfile_exporter()
        with open(path) as fp:
            text = fp.read()
        assert text == reg.render()
        samples, types = pm.parse_exposition(text)
        assert ptop.render_frame(samples, types, path, 0.0) == \
            jtop.render_frame(samples, types, path, 0.0)
    finally:
        pm.reset_registry()


def _ledger_records(seed: int, mod) -> list:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(12):
        for src in ("warm", "chip_smoke"):
            rps = float(rng.uniform(50, 100))
            if i == 11 and seed % 2 and src == "chip_smoke":
                rps *= 0.3  # the newest run regresses
            recs.append(mod.make_record(
                src, workload="c12", device="cpu", reads_per_sec=rps,
                cell_updates_per_sec=rps * 1e6, ts=f"2026-01-01T00:00:{i:02d}Z",
                key=f"{src}{i}"))
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_perf_gate_equals_jax(seed, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ABPOA_TPU_LEDGER_DIR", str(tmp_path))
    path = str(tmp_path / "ledger.jsonl")
    with open(path, "w") as fp:
        for rec in _ledger_records(seed, jledger):
            fp.write(json.dumps(rec) + "\n")
    out = {}
    for name, main in (("jax", jperf.perf_main), ("port", pperf.perf_main)):
        rc = main(["--ledger", path, "--gate"])
        cap = capsys.readouterr()
        out[name] = (rc, cap.err)
        assert main(["--ledger", path]) == 0
        table = capsys.readouterr().out
        out[name] += (table.split("\n", 1)[1],)  # past the path line
    assert out["port"] == out["jax"]
    assert out["port"][0] == (1 if seed % 2 else 0)
    assert pperf.perf_main(["--ledger", path, "--gate",
                            "--inject-slowdown", "10"]) == 1
    capsys.readouterr()
    assert pledger.drift_check(pledger.read_window(0, path)) == \
        jledger.drift_check(jledger.read_window(0, path))


def _archive(seed: int, d) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "reports.jsonl"), "w") as fp:
        for i in range(40):
            p99 = float(rng.lognormal(4 + seed, 1))
            fp.write(json.dumps({
                "ts": f"2026-01-01T00:00:{i:02d}Z", "schema_version": 4,
                "label": "x.fa", "device": "cuda", "total_wall_s": 1.0,
                "reads": 50, "reads_per_sec": 50.0,
                "read_wall_ms": {"p50": p99 / 3, "p95": p99 / 1.5,
                                 "p99": p99},
                "fallback_reads": int(rng.integers(0, 3)),
                "compile_hits": 1, "compile_misses": 0, "faults": 0,
                "quarantined": 0, "degraded": [], "dp_cells": 10,
                "cell_updates_per_sec": 1.0, "mfu": None}) + "\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_equals_jax(seed, tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "arch")
    _archive(seed, d)
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", d)
    obj = os.path.join(ROOT, "tools", "slo_objectives.json")
    res = {}
    for name, main in (("jax", jslo.slo_main), ("port", pslo.slo_main)):
        rc = main(["--objectives", obj, "--archive-dir", d, "--json", "-"])
        res[name] = (rc, capsys.readouterr().out)
    assert res["port"] == res["jax"]
    assert pslo.default_objectives_path() == obj


def test_rounds_skew_summary_equals_jax():
    rng = np.random.default_rng(5)
    for mod in (jrounds, prounds):
        mod.reset()
    try:
        for _ in range(30):
            live = [int(x) for x in rng.integers(0, 9, 4)]
            wall, dp = float(rng.random()), float(rng.random()) * 0.5
            for mod in (jrounds, prounds):
                mod.begin_round()
                mod.note_dispatch(dp, shard_live=live)
                mod.record_round("sharded", sum(live), 32, wall, mesh=4)
        assert prounds.skew_summary() == jrounds.skew_summary()
        strip = [{k: v for k, v in s.items() if k != "t_start"}
                 for s in prounds.snapshot()]
        assert strip == [{k: v for k, v in s.items() if k != "t_start"}
                         for s in jrounds.snapshot()]
        assert len(strip) == 30
    finally:
        for mod in (jrounds, prounds):
            mod.reset()


def test_chrome_trace_export(tmp_path):
    ptrace.enable()
    try:
        with ptrace.span("fused_chunk", "fused", args={"chunk": 0}):
            ptrace.instant("route", "sched", args={"kind": "lockstep"})
        ptrace.add_span("read:0", "read", 0.0, 0.001)
        path = str(tmp_path / "t.json")
        ptrace.export_chrome_trace(path, extra_meta={"input": "x.fa"})
    finally:
        ptrace.disable()
    with open(path) as fp:
        doc = json.load(fp)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"fused_chunk", "route", "read:0"} <= names
    # the same export shape as the JAX tracer's
    jtrace.enable()
    try:
        with jtrace.span("fused_chunk", "fused", args={"chunk": 0}):
            pass
        jpath = str(tmp_path / "j.json")
        jtrace.export_chrome_trace(jpath, extra_meta={"input": "x.fa"})
    finally:
        jtrace.disable()
    with open(jpath) as fp:
        jdoc = json.load(fp)
    assert set(doc) == set(jdoc)
    assert importlib.import_module("abpoa_tpu_torch.obs").trace is ptrace
