"""The port's server (`abpoa_tpu_torch/serve/`) on the CPU: admission,
the status contract, the drain, SIGTERM, a lost card, the parser and
`top`'s serve panel, held against the JAX server where both answer.

In-process servers run with `--device cpu` (the plain versions of the
kernels) on the small data files; the SIGTERM and lost-card tests run a
child process, since exit status and signals are the contract there.

    JAX_PLATFORMS=cpu pytest tests/test_torch_serve.py
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from conftest import DATA_DIR
from torch_serve_helpers import (POISON_FQ, REPO, TEST_FA, base_of,
                                 get_json, get_text, port_bytes, port_params,
                                 port_server, post, slow_single,
                                 start_serve_process, wait_ready)

SEQ_FA = os.path.join(DATA_DIR, "seq.fa")
HETER_FA = os.path.join(DATA_DIR, "heter.fa")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No archive outside tmp_path, and the injection and the breaker of
    both packages reset around each test."""
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    obs.metrics.reset_registry()   # the serve counts of this test alone
    for r in (rz, jrz):
        r.inject.reset()
        r.breaker().reset()
    yield
    for r in (rz, jrz):
        r.inject.reset()
        r.breaker().reset()
    obs.start_run()


def _oracle(path=TEST_FA):
    return port_bytes(path)


# --------------------------------------------------------------------- #
# admission                                                              #
# --------------------------------------------------------------------- #

def _job(rung=128, est=1000, eligible=True, deadline=30.0, kind="consensus"):
    from abpoa_tpu_torch.serve.admission import Job
    return Job(records=[], rung=rung, est_bytes=est, eligible=eligible,
               deadline_s=deadline, kind=kind)


def test_admission_depth_bound():
    from abpoa_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(port_params(), max_depth=2)
    assert adm.budget is None
    assert adm.try_admit(_job())[0]
    assert adm.try_admit(_job())[0]
    ok, reason, retry = adm.try_admit(_job())
    assert not ok and reason == "queue_full" and retry >= 1.0
    adm.close_intake()
    assert adm.try_admit(_job())[1] == "draining"


def test_admission_memory_bound_never_starves_solo_request():
    from abpoa_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(port_params(), max_depth=10, budget_bytes=1000)
    big = _job(est=5000)
    assert adm.try_admit(big)[0]          # alone: always admissible
    ok, reason, _ = adm.try_admit(_job(est=10))
    assert not ok and reason == "memory"
    assert adm.next_group() == [big]
    adm.mark_done(big)
    adm.mark_done(big)                    # idempotent
    assert adm.snapshot() == (0, 0)
    assert adm.try_admit(_job(est=10))[0]


@pytest.mark.parametrize("pkg", ["abpoa_tpu", "abpoa_tpu_torch"])
def test_admission_coalesces_same_rung_and_kind_only(pkg):
    """Both packages' controllers: the head's rung and kind, eligible jobs
    only, FIFO within the group; a head below the crossover runs alone."""
    import importlib
    adm_mod = importlib.import_module(f"{pkg}.serve.admission")

    def job(rung=128, eligible=True, kind="consensus", qmax=0):
        return adm_mod.Job(records=[], rung=rung, est_bytes=10,
                           eligible=eligible, deadline_s=30.0, kind=kind,
                           qmax=qmax)

    adm = adm_mod.AdmissionController(None, max_depth=10, budget_bytes=0)
    a, b, c, d, e = (job(128), job(256), job(128), job(128, eligible=False),
                     job(128, kind="map"))
    for j in (a, b, c, d, e):
        assert adm.try_admit(j)[0]
    assert adm.next_group(max_k=4, coalesce=True) == [a, c]
    assert adm.next_group(max_k=4, coalesce=True) == [b]
    assert adm.next_group(max_k=4, coalesce=True) == [d]
    assert adm.next_group(max_k=4, coalesce=True) == [e]
    short, other = job(128, qmax=900), job(128, qmax=900)
    assert adm.try_admit(short)[0] and adm.try_admit(other)[0]
    assert adm.next_group(max_k=4, coalesce=True, min_qlen=1500) == [short]
    for j in (a, b, c, d, e, short):
        adm.mark_done(j)
    assert adm.next_group(max_k=4, coalesce=True) == [other]
    adm.mark_done(other)
    assert adm.drained()


def test_claim_joiners_prices_the_live_group():
    from abpoa_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(port_params(), max_depth=10, budget_bytes=200)
    fits, too_big, other_rung = _job(est=40), _job(est=90), _job(256, est=1)
    for j in (too_big, fits, other_rung):
        assert adm.try_admit(j)[0]
    got = adm.claim_joiners(128, 4, live_bytes=120)
    assert got == [fits] and fits.t_pickup is not None
    assert adm.snapshot()[1] == 1


def test_drop_queued_releases_bytes():
    from abpoa_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(port_params(), max_depth=10, budget_bytes=100)
    a, b = _job(est=60), _job(est=30)
    assert adm.try_admit(a)[0] and adm.try_admit(b)[0]
    assert adm.drop_queued() == [a, b]
    adm.mark_done(a)                       # a dropped job stays released
    assert adm.snapshot() == (0, 0) and adm.drained()
    assert adm.try_admit(_job(est=100))[0]


def test_abandoned_bytes_stay_on_the_gate_until_release():
    """A call the deadline abandoned keeps its jobs' bytes on the gate
    after their mark_done, until its thread returns; no request is lone
    meanwhile. A call that returned before the abandon holds nothing."""
    from abpoa_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(port_params(), max_depth=10, budget_bytes=100)
    a = _job(est=70)
    assert adm.try_admit(a)[0] and adm.next_group() == [a]
    hold = adm.hold([a])
    adm.abandon(hold)
    adm.mark_done(a)
    assert adm.snapshot() == (0, 0) and adm._abandoned == 70
    ok, reason, _ = adm.try_admit(_job(est=40))
    assert not ok and reason == "memory"
    assert adm.try_admit(_job(est=30))[0]
    adm.release(hold)
    adm.release(hold)                      # idempotent
    assert adm._abandoned == 0
    assert adm.try_admit(_job(est=70))[0]
    late = adm.hold([_job(est=500)])
    adm.release(late)                      # returned first: nothing held
    adm.abandon(late)
    assert adm._abandoned == 0


def test_request_caps_agree_with_fused_planner():
    """The byte gate keys through the fused planner: the caps are its,
    and a set's bytes are the fused estimate (the per-read route's for a
    set that route takes)."""
    from abpoa_tpu_torch.align.fused_loop import plan_dispatch_footprint
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.resilience import memory
    from abpoa_tpu_torch.serve.admission import (request_bytes,
                                                 request_caps)
    abpt = port_params().finalize()
    for path in (TEST_FA, SEQ_FA, os.path.join(DATA_DIR, "sim2k.fa")):
        records = read_fastx(path)
        caps = request_caps(abpt, records)
        plan = plan_dispatch_footprint(abpt, [[r.seq for r in records]])
        assert caps == plan
        assert request_bytes(abpt, records) == memory.estimate_bytes(plan)
    one = read_fastx(SEQ_FA)[:1]
    assert request_bytes(abpt, one) == memory.per_read_bytes(
        request_caps(abpt, one))


def test_map_request_bytes_is_b2_planes_per_read():
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.resilience import memory
    from abpoa_tpu_torch.serve.admission import (map_request_bytes,
                                                 request_caps)
    abpt = port_params().finalize()
    records = read_fastx(os.path.join(DATA_DIR, "seq4.fa"))
    caps = request_caps(abpt, records)
    per_read = (5 * 300 * caps["W2"] * 4 + 2 * 300 * 4
                + 4 * caps["Qp"] * (2 + abpt.m) + 4 * abpt.m * abpt.m)
    assert map_request_bytes(abpt, records, 300) == len(records) * per_read
    assert memory.plane_bytes(300, caps["W2"], False) == 5 * 300 * caps["W2"] * 4


def test_serve_budget_knob(monkeypatch):
    """ABPOA_TPU_SERVE_MEM_BUDGET_MB keeps its JAX meaning (0: no gate);
    unset, the budget is the card's (none on the CPU), set once at start."""
    import torch
    from abpoa_tpu_torch.serve.admission import serve_budget_bytes
    monkeypatch.delenv("ABPOA_TPU_SERVE_MEM_BUDGET_MB", raising=False)
    monkeypatch.delenv("ABPOA_TPU_MEM_BUDGET_MB", raising=False)
    assert serve_budget_bytes(torch.device("cpu")) is None
    monkeypatch.setenv("ABPOA_TPU_SERVE_MEM_BUDGET_MB", "0")
    assert serve_budget_bytes(torch.device("cpu")) is None
    monkeypatch.setenv("ABPOA_TPU_SERVE_MEM_BUDGET_MB", "5")
    assert serve_budget_bytes(torch.device("cpu")) == 5_000_000
    srv = port_server(workers=1)
    try:
        assert srv.admission.budget == 5_000_000
    finally:
        srv.stop()


# --------------------------------------------------------------------- #
# the same request sequence through the JAX and the port's server        #
# --------------------------------------------------------------------- #

def _jax_server(**kw):
    from abpoa_tpu.params import Params
    from abpoa_tpu.serve import AlignServer
    abpt = Params()
    abpt.device = "numpy"
    srv = AlignServer(abpt, port=0, **kw)
    srv.start(warm="off")
    return srv


def _families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_same_sequence_as_the_jax_server(tmp_path, monkeypatch):
    """One request sequence (three sets, sim2k's first reads, a poisoned
    FASTQ, an empty and an undecodable body, an oversized one) through
    the JAX server (numpy device) and the port's (cpu): the same status
    codes, byte-identical bodies, the same X-Abpoa-Reads, /healthz keys,
    serve metric families and archive record keys."""
    from abpoa_tpu_torch.io.fastx import read_fastx
    from torch_serve_helpers import fasta_bytes
    monkeypatch.setenv("ABPOA_TPU_SERVE_MAX_BODY_MB", "0.05")
    sim = fasta_bytes(read_fastx(os.path.join(DATA_DIR, "sim2k.fa"))[:3])
    bodies = [open(p, "rb").read() for p in (TEST_FA, SEQ_FA, HETER_FA)]
    bodies += [sim, POISON_FQ, b"", b"\x00\xff garbage \x9c", b"A" * 60_000]
    got = {}
    for pkg, make in (("jax", _jax_server),
                      ("port", lambda **kw: port_server(**kw))):
        monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "1")
        monkeypatch.setenv("ABPOA_TPU_ARCHIVE_DIR", str(tmp_path / pkg))
        srv = make(workers=1)
        base = base_of(srv)
        try:
            answers = []
            for body in bodies:
                code, out, headers = post(base, body)
                answers.append((code, out, headers.get("X-Abpoa-Reads"),
                                "X-Abpoa-Request-Id" in headers))
            health = get_json(base, "/healthz")
            expo = get_text(base, "/metrics")
        finally:
            assert srv.stop()
        with open(tmp_path / pkg / "reports.jsonl") as fp:
            recs = [json.loads(ln) for ln in fp]
        got[pkg] = (answers, health, expo, recs)
    (ja, jh, je, jr), (pa, ph, pe, pr) = got["jax"], got["port"]
    assert [a[0] for a in pa] == [200, 200, 200, 200, 400, 400, 400, 413]
    assert pa == ja
    assert pa[0][1] == _oracle() and pa[1][1] == _oracle(SEQ_FA)
    assert ph[0] == jh[0] == 200 and set(ph[1]) == set(jh[1])
    assert ph[1]["served"] == jh[1]["served"]
    serve_fams = {f for f in _families(je) if f.startswith("abpoa_serve_")}
    assert serve_fams and serve_fams <= _families(pe)
    assert [sorted(r) for r in pr] == [sorted(r) for r in jr]
    assert [r["status"] for r in pr] == [r["status"] for r in jr]


# --------------------------------------------------------------------- #
# the status contract in process                                         #
# --------------------------------------------------------------------- #

def test_poisoned_request_is_400_worker_survives():
    from abpoa_tpu_torch import obs
    srv = port_server(workers=1)
    base = base_of(srv)
    try:
        code, body, _ = post(base, POISON_FQ)
        assert code == 400 and b"quality length" in body
        assert post(base, b"")[0] == 400
        code, body, _ = post(base, open(TEST_FA, "rb").read())
        assert code == 200 and body == _oracle()
        assert obs.report().counters.get("faults.poisoned_set", 0) >= 1
        assert get_json(base, "/nope")[0] == 404
        assert post(base, b"x", path="/map")[0] == 400  # no map graph
    finally:
        srv.stop()


def test_queue_overflow_sheds_429_with_retry_after(monkeypatch):
    slow_single(monkeypatch, 0.4)
    srv = port_server(workers=1, queue_depth=1)
    base = base_of(srv)
    payload = open(TEST_FA, "rb").read()
    codes = []
    try:
        threads = [threading.Thread(target=lambda: codes.append(
            post(base, payload))) for _ in range(5)]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join()
        got = [c for c, _b, _h in codes]
        assert got.count(200) >= 1
        shed = [h for c, _b, h in codes if c == 429]
        assert shed, got
        assert all(int(h["Retry-After"]) >= 1 for h in shed)
        assert all(b == _oracle() for c, b, _h in codes if c == 200)
        samples = _samples(base)
        from abpoa_tpu_torch.obs import metrics as M
        assert M.sample_value(samples, "abpoa_serve_requests_total",
                              status="rejected") == got.count(429)
        assert M.sample_value(samples, "abpoa_serve_requests_total",
                              status="ok") == got.count(200)
    finally:
        srv.stop()


def _samples(base):
    from abpoa_tpu_torch.obs import metrics as M
    return M.parse_exposition(get_text(base, "/metrics"))[0]


def test_request_deadline_expires_as_504(monkeypatch):
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    delay = slow_single(monkeypatch, 0.5)
    srv = port_server(workers=1)
    base = base_of(srv)
    try:
        t0 = time.perf_counter()
        code, _body, _ = post(base, open(TEST_FA, "rb").read(),
                              headers={"X-Abpoa-Deadline-S": "0.05"})
        assert code == 504 and time.perf_counter() - t0 < 5.0
        assert obs.report().counters.get("faults.request_timeout", 0) >= 1
        assert not rz.breaker().lost            # a deadline is no lost card
        delay["s"] = 0.0
        code, body, _ = post(base, open(TEST_FA, "rb").read())
        assert code == 200 and body == _oracle()
    finally:
        srv.stop()


def test_abandoned_request_holds_its_bytes_until_its_thread_ends(
        monkeypatch):
    """A 504 answers at once, but the abandoned thread goes on running:
    a second request that fits the budget only without the first one's
    bytes is shed (429, memory) until that thread ends, then served."""
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.serve import server as S
    from abpoa_tpu_torch.serve.admission import request_bytes
    est = request_bytes(port_params().finalize(), read_fastx(TEST_FA))
    monkeypatch.setenv("ABPOA_TPU_SERVE_MEM_BUDGET_MB", str(1.5 * est / 1e6))
    gate = threading.Event()
    run = S.AlignServer._run_single
    calls = []

    def held(self, job, abpt):
        calls.append(job.rid)
        if len(calls) == 1:
            gate.wait(30)
        return run(self, job, abpt)
    monkeypatch.setattr(S.AlignServer, "_run_single", held)
    srv = port_server(workers=1)
    base = base_of(srv)
    payload = open(TEST_FA, "rb").read()
    try:
        assert post(base, payload,
                    headers={"X-Abpoa-Deadline-S": "0.2"})[0] == 504
        assert srv.admission._abandoned == est
        code, body, headers = post(base, payload)
        assert code == 429 and b"memory" in body and "Retry-After" in headers
        gate.set()
        deadline = time.time() + 30
        while srv.admission._abandoned and time.time() < deadline:
            time.sleep(0.02)
        assert srv.admission._abandoned == 0
        code, body, _ = post(base, payload)
        assert code == 200 and body == _oracle()
        assert len(calls) == 2
    finally:
        gate.set()
        srv.stop()


def test_oversized_body_is_413(monkeypatch):
    monkeypatch.setenv("ABPOA_TPU_SERVE_MAX_BODY_MB", "0.0001")
    srv = port_server(workers=1)
    base = base_of(srv)
    try:
        assert post(base, open(SEQ_FA, "rb").read())[0] == 413
        monkeypatch.setenv("ABPOA_TPU_SERVE_MAX_BODY_MB", "32")
        code, body, _ = post(base, open(TEST_FA, "rb").read())
        assert code == 200 and body == _oracle()
        assert srv.stats() == {"oversized": 1, "ok": 1}
    finally:
        srv.stop()


def test_metrics_endpoint_lints_with_serve_families():
    from abpoa_tpu_torch.obs import metrics as M
    srv = port_server(workers=1)
    base = base_of(srv)
    try:
        post(base, open(TEST_FA, "rb").read())
        post(base, POISON_FQ)
        text = get_text(base, "/metrics")
        assert M.lint_exposition(text) == []
        samples, types = M.parse_exposition(text)
        assert M.sample_value(samples, "abpoa_serve_requests_total",
                              status="ok") >= 1
        assert M.sample_value(samples, "abpoa_serve_requests_total",
                              status="poisoned") >= 1
        assert M.sample_value(samples, "abpoa_serve_admitted_total") >= 1
        assert ("abpoa_serve_queue_depth", frozenset()) in samples
        assert ("abpoa_serve_inflight", frozenset()) in samples
        assert types.get("abpoa_serve_request_seconds") == "histogram"
        assert M.sample_value(samples, "abpoa_serve_request_seconds_quantile",
                              quantile="0.99") is not None
    finally:
        srv.stop()


def test_drain_in_process_rejects_new_finishes_inflight(monkeypatch):
    slow_single(monkeypatch, 0.6)
    srv = port_server(workers=1)
    base = base_of(srv)
    res = {}

    def send(key):
        res[key] = post(base, open(TEST_FA, "rb").read())

    t = threading.Thread(target=send, args=("inflight",))
    t.start()
    time.sleep(0.2)
    srv.begin_drain()
    code, h = get_json(base, "/readyz")
    assert code == 503 and h["status"] == "draining"
    assert get_json(base, "/healthz")[1]["status"] == "draining"
    send("after")
    t.join()
    assert res["after"][0] == 503 and res["after"][2]["Retry-After"] == "30"
    assert res["inflight"][0] == 200 and res["inflight"][1] == _oracle()
    assert srv.drain(timeout=10)
    srv.shutdown_http()


# --------------------------------------------------------------------- #
# a lost card                                                            #
# --------------------------------------------------------------------- #

def test_lost_card_answers_500_then_drains(monkeypatch):
    """A CardFailure that marks the card lost: that request 500 with its
    fault, /readyz 503, /healthz degraded naming the card, the queued
    request 503 with Retry-After and never run, later requests 503."""
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.serve import server as srv_mod
    runs = []
    real = srv_mod.AlignServer._run_single

    def run_single(self, job, abpt):
        runs.append(job.label)
        if len(runs) == 1:
            time.sleep(0.3)          # the second request queues meanwhile
            rz.breaker().mark_lost("cpu", "hang")
            raise rz.CardFailure("hang", "injected: the card stopped")
        return real(self, job, abpt)

    monkeypatch.setattr(srv_mod.AlignServer, "_run_single", run_single)
    srv = port_server(workers=1)
    base = base_of(srv)
    res = {}
    body = open(TEST_FA, "rb").read()
    try:
        t1 = threading.Thread(target=lambda: res.update(a=post(base, body)))
        t1.start()
        time.sleep(0.1)
        t2 = threading.Thread(target=lambda: res.update(b=post(base, body)))
        t2.start()
        t1.join()
        t2.join()
        assert res["a"][0] == 500 and b"CardFailure" in res["a"][1]
        assert res["b"][0] == 503 and res["b"][2]["Retry-After"] == "30"
        assert len(runs) == 1      # the queued request never ran
        assert srv.stop_requested.is_set()
        assert srv.lost_card == {"cpu": "hang"}
        code, ready = get_json(base, "/readyz")
        assert code == 503 and ready["lost"] == {"cpu": "hang"}
        health = get_json(base, "/healthz")[1]
        assert health["status"] == "degraded"
        assert health["degraded"] == {"cpu": "lost"}
        assert health["lost"]["card"] == "cpu"
        assert post(base, body)[0] == 503
        assert len(runs) == 1
    finally:
        srv.drain(timeout=10)
        srv.shutdown_http()


_LOST_CHILD = r"""
import sys, time
from abpoa_tpu_torch import resilience as rz
from abpoa_tpu_torch.serve import server as srv_mod

def run_single(self, job, abpt):
    rz.breaker().mark_lost("cpu", "dispatch_error")
    raise rz.CardFailure("dispatch_error", "injected: illegal address")

srv_mod.AlignServer._run_single = run_single
from abpoa_tpu_torch.cli import main
sys.exit(main(["serve", "--port", "0", "--device", "cpu", "--workers", "1"]))
"""


def test_lost_card_ends_the_process_with_rc_1(tmp_path):
    """In a child: the request the card failed gets 500; for the drain's
    grace /readyz answers 503 and a new request 503; then rc 1."""
    env = dict(os.environ, ABPOA_TPU_ARCHIVE="0", ABPOA_TPU_SERVE_DRAIN_S="3")
    proc = subprocess.Popen([sys.executable, "-c", _LOST_CHILD], cwd=REPO,
                            env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.time() + 60
        while time.time() < deadline and port is None:
            line = proc.stderr.readline()
            if "listening on http://" in line:
                port = int(line.split("listening on http://")[1]
                           .split()[0].rsplit(":", 1)[1])
        assert port
        base = f"http://127.0.0.1:{port}"
        assert wait_ready(base)
        code, body, _ = post(base, open(TEST_FA, "rb").read())
        assert code == 500 and b"illegal address" in body
        assert get_json(base, "/readyz")[0] == 503
        code, _body, headers = post(base, open(TEST_FA, "rb").read())
        assert code == 503 and headers["Retry-After"] == "30"
        rc = proc.wait(timeout=60)
        err = proc.stderr.read()
        assert rc == 1, err[-2000:]
        assert "the card was lost" in err and "Traceback" not in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_no_card_is_a_startup_error():
    """`serve` on cuda with no card: rc 1 with one error line, no server."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from abpoa_tpu_torch.cli import main
    assert main(["serve", "--port", "0"]) == 1


# --------------------------------------------------------------------- #
# SIGTERM: the full-process contract                                     #
# --------------------------------------------------------------------- #

def test_sigterm_drains_flushes_and_exits_zero(tmp_path):
    """SIGTERM mid-request: the request in flight completes with the
    CLI's bytes, a later one gets 503, the process exits 0 with its
    metrics flushed and its archive records written."""
    from abpoa_tpu_torch.obs import metrics as M
    metrics_path = str(tmp_path / "metrics.prom")
    archive_dir = str(tmp_path / "reports")
    env = dict(os.environ, ABPOA_TPU_ARCHIVE="1",
               ABPOA_TPU_ARCHIVE_DIR=archive_dir)
    proc, port = start_serve_process(
        ["--device", "cpu", "--workers", "1", "--metrics", metrics_path], env,
        delay_s=1.2)
    try:
        assert port, "the server printed no listening line"
        base = f"http://127.0.0.1:{port}"
        assert wait_ready(base)
        res = {}

        def send(key):
            res[key] = post(base, open(TEST_FA, "rb").read())

        t = threading.Thread(target=send, args=("inflight",))
        t.start()
        time.sleep(0.4)
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        send("after")
        t.join(30)
        rc = proc.wait(timeout=60)
        rest = proc.stderr.read()
        assert rc == 0, rest[-2000:]
        assert res["inflight"][0] == 200 and res["inflight"][1] == _oracle()
        assert res["after"][0] == 503
        assert "drained clean" in rest and "Traceback" not in rest
        with open(metrics_path) as fp:
            final = fp.read()
        assert M.lint_exposition(final) == []
        assert M.sample_value(M.parse_exposition(final)[0],
                              "abpoa_serve_requests_total", status="ok") == 1
        with open(os.path.join(archive_dir, "reports.jsonl")) as fp:
            recs = [json.loads(ln) for ln in fp]
        assert [r.get("kind") for r in recs].count("serve_request") == 1
        assert any(r.get("label") == "serve" for r in recs)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# --------------------------------------------------------------------- #
# the parser and top                                                     #
# --------------------------------------------------------------------- #

def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_is_the_jax_servers_less_the_pool_and_the_fleet():
    from abpoa_tpu.serve.server import _build_parser as jax_parser
    from abpoa_tpu_torch.serve.server import _build_parser
    assert _options(jax_parser()) - _options(_build_parser()) == {
        "--pool-workers", "--replicas"}
    assert _options(_build_parser()) <= _options(jax_parser())
    assert _build_parser().parse_args([]).device == "cuda"


def test_top_renders_serve_panel_from_the_ports_exposition():
    from abpoa_tpu_torch.obs import metrics as M
    from abpoa_tpu_torch.obs.top import render_frame
    srv = port_server(workers=1)
    base = base_of(srv)
    try:
        post(base, open(TEST_FA, "rb").read())
        post(base, POISON_FQ)
        text = get_text(base, "/metrics")
    finally:
        srv.stop()
    samples, types = M.parse_exposition(text)
    frame = render_frame(samples, types, "live", 0.0)
    assert "serve    queue 0  inflight 0" in frame
    assert "ok=1" in frame and "poisoned=1" in frame
    assert "req ms  p50" in frame


def test_top_serve_panel_matches_jax():
    from abpoa_tpu.obs import metrics as JM
    from abpoa_tpu.obs.top import render_frame as jax_frame
    from abpoa_tpu_torch.obs import metrics as M
    from abpoa_tpu_torch.obs.top import render_frame
    expo = "\n".join([
        "# TYPE abpoa_serve_requests_total counter",
        'abpoa_serve_requests_total{status="ok"} 182',
        'abpoa_serve_requests_total{status="rejected"} 24',
        "# TYPE abpoa_serve_queue_depth gauge",
        "abpoa_serve_queue_depth 3",
        "# TYPE abpoa_serve_inflight gauge",
        "abpoa_serve_inflight 2",
        "# TYPE abpoa_serve_request_seconds_quantile gauge",
        'abpoa_serve_request_seconds_quantile{quantile="0.5"} 0.038',
        'abpoa_serve_request_seconds_quantile{quantile="0.95"} 0.081',
        'abpoa_serve_request_seconds_quantile{quantile="0.99"} 0.13',
        "# TYPE abpoa_serve_traces_total counter",
        "abpoa_serve_traces_total 7",
        "# TYPE abpoa_runs_total counter",
        "abpoa_runs_total 1",
    ]) + "\n"
    frame = render_frame(*M.parse_exposition(expo), "x.prom", 0.5)
    want = jax_frame(*JM.parse_exposition(expo), "x.prom", 0.5)
    serve = [ln for ln in frame.splitlines()
             if ln.startswith(("serve", "tracing", "         req"))]
    assert serve == [ln for ln in want.splitlines()
                     if ln.startswith(("serve", "tracing", "         req"))]
    assert "queue 3" in frame and "p99 130.00" in frame
    assert "request traces 7" in frame


def test_serve_metric_families_equal_jax():
    """The serve, join-wait, idle-lane, occupancy and read-aggregate
    families render as the JAX package's, letter for letter."""
    from abpoa_tpu.obs import metrics as JM
    from abpoa_tpu_torch.obs import metrics as M
    texts = []
    for mod in (M, JM):
        mod.reset_registry()
        mod.publish_serve_request("ok", 0.125)
        mod.publish_serve_request("rejected", 0.001)
        mod.publish_serve_admitted()
        mod.publish_serve_state(2, 1)
        mod.publish_join_wait(0.5)
        mod.publish_noop_fraction(0.25)
        mod.publish_lane_occupancy(0.75)
        sk = mod.LogSketch()
        for v in (0.01, 0.02, 0.04):
            sk.observe(v)
        mod.publish_read_aggregate({"cuda": 3}, {"host_rerun": 1}, sk)
        texts.append(mod.registry().render())
        mod.reset_registry()
    fams = ("abpoa_serve_", "abpoa_lockstep_", "abpoa_reads_total",
            "abpoa_read_fallbacks_total", "abpoa_read_wall_seconds")
    port, jax = ([ln for ln in t.splitlines()
                  if any(f in ln for f in fams)] for t in texts)
    assert port and port == jax


def test_tally_adds_are_not_lost_across_threads():
    """The routes' counters under the server's threads: 16 threads add at
    a shortened switch interval; a lost read-modify-write would leave the
    totals short."""
    from abpoa_tpu_torch.obs.tally import Tally
    t = Tally(lambda: {"n": 0, "s": 0.0, "by": {}})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                t.add("n")
                t.add("s", 0.5)
                t.add_in("by", "k")
                t.high("n", -1)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t["n"] == 32000 and t["s"] == 16000.0 and t["by"] == {"k": 32000}
    t.reset()
    assert t == {"n": 0, "s": 0.0, "by": {}}


def test_launch_counts_are_not_lost_across_threads():
    """The kernel wrappers' launch counters under two server threads:
    `count_launch` is one locked add, so none is lost at a shortened
    switch interval."""
    from abpoa_tpu_torch.obs.tally import count_launch

    def wrapper():
        pass
    wrapper.launches = wrapper.local_launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                count_launch(wrapper)
                count_launch(wrapper, "local_launches")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 32000 and wrapper.local_launches == 32000


def test_staging_buffers_are_reused_across_threads(monkeypatch):
    """X1w's page-locked staging buffers: a call holds its own until it
    gives it back, a later call on another thread reuses it, and a
    buffer too small is dropped for a larger one (the free list never
    grows past the calls that ran at once). Page-locked memory needs a
    card, so the buffers here are plain."""
    import torch
    from abpoa_tpu_torch.align import banded
    empty = torch.empty
    monkeypatch.setattr(banded.torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    monkeypatch.setattr(banded, "_free_staging", [])
    a = banded._take_staging(100)
    b = banded._take_staging(100)
    assert a is not b and a.numel() >= 100 and b.numel() >= 100
    banded._give_staging(a)
    banded._give_staging(b)
    got = []
    th = threading.Thread(target=lambda: got.append(
        banded._take_staging(80)))
    th.start()
    th.join(10)
    assert got[0] is a or got[0] is b
    banded._give_staging(got[0])
    big = banded._take_staging(10_000)
    assert big.numel() >= 10_000 and len(banded._free_staging) == 1
    banded._give_staging(big)
    assert len(banded._free_staging) == 2
    assert banded._take_staging(5_000) is big
    banded._give_staging(None)             # the CPU path hands back none
    assert len(banded._free_staging) == 1
