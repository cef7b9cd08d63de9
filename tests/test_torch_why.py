"""Per-request tracing, the flight recorder and `why` in the port
(`abpoa_tpu_torch/obs/trace.py`, `flight.py`, `why.py`), held against
the JAX package: the same text from `why` on the same dump, trace and
archive record, and the server's request id and trace end to end.

    JAX_PLATFORMS=cpu pytest tests/test_torch_why.py
"""
import json
import os

import pytest

from conftest import DATA_DIR
from torch_serve_helpers import TEST_FA, base_of, port_server, post

GOLDEN_DUMP = os.path.join(DATA_DIR, "flight_dump.json")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    from abpoa_tpu_torch import obs
    obs.trace_disable()
    yield
    obs.trace_disable()
    obs.flight.uninstall()
    obs.tracer().index_requests = False
    obs.start_run()


def _why_both(capsys, argv):
    """(rc, text) of the port's `why` and the JAX package's on argv."""
    from abpoa_tpu.obs.why import why_main as jax_why
    from abpoa_tpu_torch.obs.why import why_main
    out = []
    for fn in (why_main, jax_why):
        rc = fn(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


# --------------------------------------------------------------------- #
# the tracer's request parts                                             #
# --------------------------------------------------------------------- #

def test_request_ctx_tags_and_filters():
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch.obs import trace
    obs.trace_enable()
    rid_a, rid_b = obs.new_request_id(), obs.new_request_id()
    assert rid_a != rid_b and len(rid_a) == 12
    with obs.request_ctx(rid_a, 1):
        with obs.span("dp:cuda", "dp", args={"W": 512}):
            pass
    with obs.request_ctx(rid_b):
        obs.instant("mark", "t")
    with obs.span("untagged", "t"):
        pass
    evs_a = trace.tracer().events_for(rid_a)
    assert [e[1] for e in evs_a] == ["dp:cuda"]
    assert evs_a[0][7] == (rid_a, 1)
    assert [e[1] for e in trace.tracer().events_for(rid_b)] == ["mark"]
    ev = trace.to_chrome_trace(events=evs_a)["traceEvents"][-1]
    assert ev["args"] == {"W": 512, "rid": rid_a, "attempt": 1}
    assert [e[1] for e in trace.tracer().tail(2)] == ["mark", "untagged"]


def test_request_index_keeps_a_registered_request_apart():
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch.obs import trace
    obs.trace_enable()
    t = trace.tracer()
    t.index_requests = True
    t.begin_request("aa")
    with obs.request_ctx("aa"):
        with obs.span("execute", "serve"):
            pass
    with obs.request_ctx("bb"):      # never registered
        obs.instant("x", "t")
    evs, dropped = t.take_request("aa")
    assert [e[1] for e in evs] == ["execute"] and dropped == 0
    assert t.take_request("aa") is None and t.take_request("bb") is None


def test_request_trace_export_bounded(tmp_path):
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch.obs import trace
    obs.trace_enable()
    d = str(tmp_path / "traces")
    paths = []
    for _ in range(6):
        rid = obs.new_request_id()
        with obs.request_ctx(rid):
            with obs.span("execute", "serve"):
                pass
        p = trace.export_request_trace(d, rid, max_files=4)
        assert p and os.path.exists(p)
        paths.append(p)
    kept = [p for p in paths if os.path.exists(p)]
    assert len(kept) == 4 and kept == paths[-4:]
    with open(paths[-1]) as fp:
        doc = json.load(fp)
    meta = next(e for e in doc["traceEvents"] if e["name"] == "trace_meta")
    assert meta["args"]["request_id"] in paths[-1]
    assert trace.export_request_trace(d, "nothing-recorded") is None


@pytest.mark.parametrize("rate", ["0", "1", "0.5", "0.25", "junk"])
def test_sampling_equals_jax(monkeypatch, rate):
    from abpoa_tpu.obs import trace as jtrace
    from abpoa_tpu_torch.obs import trace
    monkeypatch.setenv("ABPOA_TPU_TRACE_SAMPLE", rate)
    rids = ["00000000abcd", "ffffffffffff", "0123456789ab", "c0ffee123abc",
            "not-hex", ""]
    assert [trace.sampled(r) for r in rids] == [jtrace.sampled(r)
                                               for r in rids]
    assert trace.sample_rate() == jtrace.sample_rate()


# --------------------------------------------------------------------- #
# the flight recorder                                                    #
# --------------------------------------------------------------------- #

def test_flight_recorder_dump_and_harvest(tmp_path):
    """The recorder names the open span and the last dispatch, and a
    harvested dump is one `why` renders with the JAX text."""
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch.obs import flight
    obs.trace_enable()
    d = str(tmp_path / "flight")
    rec = flight.install(label="worker", path=flight.worker_dump_path(
        os.getpid(), d))
    flight.begin_job("c0ffee000001", 1, "records", label="req-3")
    with obs.span("dp:cuda", "dp", args={"Qp": 2048, "W": 256}):
        pass
    with obs.span("fused_chunk", "fused", args={"K": 4}):
        rec.beat(1_500_000_000)
        snap = rec.snapshot()
    assert snap["schema"] == flight.SCHEMA == "abpoa-tpu-flight"
    assert [s["name"] for s in snap["open_spans"]] == ["fused_chunk"]
    assert snap["last_dispatch"]["name"] == "dp:cuda"
    assert snap["job"]["rid"] == "c0ffee000001"
    path = flight.harvest(os.getpid(), "killed_deadline",
                          rid="c0ffee000001", attempt=1, dirpath=d)
    assert path and os.path.basename(path).startswith("dump-c0ffee000001")
    with open(path) as fp:
        dump = json.load(fp)
    assert dump["job"]["status"] == "died:killed_deadline"
    from abpoa_tpu.obs.why import render_why as jax_render
    from abpoa_tpu_torch.obs.why import render_why
    assert render_why(None, None, dump) == jax_render(None, None, dump)
    assert "open span at death: `fused_chunk`" in render_why(None, None, dump)


# --------------------------------------------------------------------- #
# why, against the JAX package's                                         #
# --------------------------------------------------------------------- #

def test_why_golden_dump(capsys):
    (rc, out), (jrc, jout) = _why_both(capsys, [GOLDEN_DUMP])
    assert rc == jrc == 0 and out == jout
    assert "why c0ffee123abc" in out and "verdict:" in out
    assert "hard-killed at the job deadline" in out
    assert "mid `dp:jax`" in out and "Qp=2048/W=256" in out
    assert "open span at death: `dp:jax`" in out and "1612 MB" in out


def test_why_request_id_archive_lookup(tmp_path, capsys, monkeypatch):
    from abpoa_tpu_torch.obs import archive
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path / "reports"))
    archive.append_record({
        "ts": "2026-08-04T12:00:44Z", "kind": "serve_request",
        "label": "req-17", "request_id": "c0ffee123abc",
        "device": "cuda", "status": "timeout", "total_wall_s": 30.04,
        "deadline_s": 30.0, "reads": 0, "faults": 1, "quarantined": 0,
        "dump_file": GOLDEN_DUMP,
    })
    assert archive.find_request("c0ffee123abc")["label"] == "req-17"
    assert archive.find_request("req-17")["request_id"] == "c0ffee123abc"
    (rc, out), (jrc, jout) = _why_both(capsys, ["c0ffee123abc"])
    assert rc == jrc == 0 and out == jout
    assert "status=timeout" in out and "504:" in out
    assert f"dump: {GOLDEN_DUMP}" in out
    (rc, _), (jrc, _) = _why_both(capsys, ["ffffffffffff"])
    assert rc == jrc == 2


def test_why_trace_attribution(tmp_path, capsys, monkeypatch):
    from abpoa_tpu_torch.obs import archive
    doc = {"traceEvents": [
        {"name": "admission_wait", "cat": "serve", "ph": "X", "ts": 0.0,
         "dur": 28.1e6, "pid": 1, "tid": 1,
         "args": {"rid": "aa00aa00aa00", "coalesced_k": 8, "rung": 2048}},
        {"name": "execute", "cat": "serve", "ph": "X", "ts": 28.1e6,
         "dur": 1.9e6, "pid": 1, "tid": 2, "args": {"rid": "aa00aa00aa00"}},
    ]}
    tp = str(tmp_path / "t.trace.json")
    with open(tp, "w") as fp:
        json.dump(doc, fp)
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path / "arch"))
    archive.append_record({
        "kind": "serve_request", "request_id": "aa00aa00aa00",
        "status": "timeout", "total_wall_s": 30.0, "deadline_s": 30.0})
    (rc, out), (jrc, jout) = _why_both(capsys, [tp])
    assert rc == jrc == 0 and out == jout
    assert ("504: 28.1 s of 30 s budget spent in admission wait behind "
            "a coalesced K=8 group") in out


@pytest.mark.parametrize("case", ["ok", "timeout", "from_span"])
def test_why_join_round_verdict(case):
    from abpoa_tpu.obs.why import verdict as jax_verdict
    from abpoa_tpu_torch.obs.why import verdict
    span = {"name": "admission_wait", "cat": "serve", "ph": "X", "ts": 0.0,
            "dur": 29e6, "pid": 1, "tid": 1,
            "args": {"rid": "bb", "coalesced_k": 8}}
    rec, doc, want = {
        "ok": ({"status": "ok", "total_wall_s": 1.2, "join_round": 4,
                "join_group": 7}, None, "joined group 7 at round 4"),
        "timeout": ({"status": "timeout", "total_wall_s": 30.0,
                     "deadline_s": 30.0, "join_round": 2, "join_group": 3},
                    {"traceEvents": [span]}, "joined group 3 at round 2"),
        "from_span": ({"status": "timeout", "total_wall_s": 30.0,
                       "deadline_s": 30.0},
                      {"traceEvents": [dict(span, args={
                          "rid": "cc", "coalesced_k": 2, "join_round": 5,
                          "join_group": 1})]}, "joined group 1 at round 5"),
    }[case]
    got = verdict(rec, doc, None)
    assert got == jax_verdict(rec, doc, None) and want in got
    assert "K=8" not in got


def test_slo_prints_budget_burner_ids():
    from abpoa_tpu.obs.slo import evaluate as jax_eval
    from abpoa_tpu.obs.slo import format_table as jax_table
    from abpoa_tpu_torch.obs.slo import evaluate, format_table
    objectives = {"objectives": [
        {"name": "req-wall", "metric": "total_wall_s", "max": 1.0,
         "error_budget": 0.1}]}
    records = [{"total_wall_s": 0.1, "request_id": "fast00000000"}
               for _ in range(8)]
    records += [{"total_wall_s": 30.0, "request_id": "slowaaaaaaaa"},
                {"total_wall_s": 12.0, "label": "req-99"}]
    res = evaluate(objectives, records)
    assert res == jax_eval(objectives, records)
    assert [o["id"] for o in res["objectives"][0]["offenders"]] == [
        "slowaaaaaaaa", "req-99"]
    assert format_table(res) == jax_table(res)
    assert "burned by: slowaaaaaaaa(30)  req-99(12)" in format_table(res)


# --------------------------------------------------------------------- #
# the server's request id and trace, end to end                          #
# --------------------------------------------------------------------- #

def test_serve_request_id_header_trace_and_why(tmp_path, monkeypatch,
                                               capsys):
    """With --trace-dir every answer carries X-Abpoa-Request-Id; the
    archive record carries the id and its trace file; the trace brackets
    admission_wait -> execute -> request under one id; `why <id>` renders
    the same text in both packages and names the trace."""
    import urllib.error
    import urllib.request
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path / "reports"))
    srv = port_server(workers=1, trace_dir=str(tmp_path / "traces"))
    try:
        base = base_of(srv)
        code, _body, headers = post(base, open(TEST_FA, "rb").read())
        assert code == 200
        rid = headers.get("X-Abpoa-Request-Id")
        assert rid and len(rid) == 12
        code, _body, headers = post(base, b"@x\nACGT\n+\nII\n")
        assert code == 400 and headers.get("X-Abpoa-Request-Id")
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "abpoa_serve_traces_total 1" in r.read().decode()
    finally:
        srv.stop()
    with open(tmp_path / "reports" / "reports.jsonl") as fp:
        recs = [json.loads(ln) for ln in fp]
    served = [r for r in recs if r.get("kind") == "serve_request"]
    assert len(served) == 1 and served[0]["request_id"] == rid
    tf = served[0]["trace_file"]
    with open(tf) as fp:
        doc = json.load(fp)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {"admission_wait", "execute", "request"} <= {e["name"]
                                                        for e in spans}
    assert all(e["args"]["rid"] == rid for e in spans)
    assert next(e for e in spans
                if e["name"] == "request")["args"]["status"] == "ok"
    (rc, out), (jrc, jout) = _why_both(capsys, [rid])
    assert rc == jrc == 0 and out == jout
    assert f"trace: {tf}" in out and "verdict: ok: served in" in out
