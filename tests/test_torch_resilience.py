"""The port's resilience package (`abpoa_tpu_torch/resilience/`) against the
JAX package's (`abpoa_tpu/resilience/`), unit by unit, on the CPU:

- the injection grammar and its errors;
- the circuit breaker's transitions on the event sequences of
  tests/test_resilience.py:76-201, driven through both breakers side by
  side (the port's `cpu` where JAX has `jax`, `native` and `plain` for
  `native` and `numpy`; the port's `cuda` is never demoted);
- `classify` on JAX's table (where the port lets an unknown RuntimeError
  propagate), the CUDA strings of the kernels' wrappers and
  `KernelBuildError` (never absorbed);
- the card's rules: a hang or a sticky CUDA error on `cuda` raises
  CardFailure and no later call of the run reaches torch.cuda; the
  per-read route's last rung and admission raise instead of moving the
  work to the host;
- the output guards' violation strings on the same inputs;
- the watchdog: the deadline, and the worker running with the caller's
  request context;
- `memory.estimate_bytes`'s parts equal to the bytes `init_fused_state`,
  B1's plain version, the tables and the read batch really allocate, at a
  few capacities; admission's decisions;
- with injection disarmed, a `cpu` or `native` run starts no watchdog
  thread and makes no extra host sync (the structural twin of JAX's
  overhead guard, with no wall clock);
- each kind injected on the per-read route (`-G -r 2`, which the JAX
  package reroutes to its host engine, so its faults are the port's own)
  and on a sharded `-l` (`--mesh 2` over two CPU devices): the output
  equals the uninjected run's.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the port's name of each JAX backend on the ladder
PORT_NAME = {"jax": "cpu", "native": "native", "numpy": "plain"}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Injection spec and breakers are process-global in both packages."""
    from abpoa_tpu import obs as jobs
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    for pkg in (rz, jrz):
        pkg.inject.reset()
        pkg.breaker().reset()
        pkg.set_enabled(True)
    yield
    for pkg in (rz, jrz):
        pkg.inject.reset()
        pkg.breaker().reset()
        pkg.set_enabled(True)
    obs.start_run()
    jobs.start_run()


def test_inject_spec_parsing():
    from abpoa_tpu_torch import resilience as rz
    rz.inject.configure("oom:2,hang")
    assert rz.inject.armed("oom") and rz.inject.armed("hang")
    assert not rz.inject.armed("garbage")
    assert rz.inject.snapshot() == {"oom": 2, "hang": -1}
    assert rz.inject.fire("oom") and rz.inject.fire("oom")
    assert not rz.inject.fire("oom")
    assert rz.inject.fire("hang")
    rz.inject.reset()
    assert not rz.inject.fire("hang")


@pytest.mark.parametrize("spec", ["frobnicate", "oom,bogus:2", "Oom"])
def test_inject_unknown_kind_raises_as_jax(spec):
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import resilience as rz
    with pytest.raises(ValueError, match="unknown fault-injection kind"):
        rz.inject.configure(spec)
    with pytest.raises(ValueError, match="unknown fault-injection kind"):
        jrz.inject.configure(spec)


@pytest.mark.parametrize("spec", [
    "compile_fail", "oom:3", "hang:1,garbage", "native_crash:2",
    "poison_set:1,worker_kill,worker_sigsegv:1", ""])
def test_inject_kinds_parse_as_jax(spec):
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import resilience as rz
    assert rz.inject.KINDS == jrz.inject.KINDS
    rz.inject.configure(spec)
    jrz.inject.configure(spec)
    assert rz.inject.snapshot() == jrz.inject.snapshot()


@pytest.mark.parametrize("backend,fires", [
    ("cuda", "compile_fail"), ("cpu", "oom"), ("native", "native_crash")])
def test_pre_dispatch_fires_by_backend(backend, fires):
    """Device kinds fire on the device backends, native_crash on native,
    and nothing of the other family."""
    from abpoa_tpu_torch import resilience as rz
    rz.inject.configure("compile_fail:1,oom:1,native_crash:1")
    if fires == "oom":
        rz.inject.fire("compile_fail")
    with pytest.raises(rz.InjectedFault) as ei:
        rz.inject.pre_dispatch(backend)
    assert ei.value.kind == fires
    rz.inject.pre_dispatch("plain")  # the floor has no injection point


def test_injected_oom_carries_the_torch_message():
    from abpoa_tpu_torch import resilience as rz
    rz.inject.configure("oom:1")
    with pytest.raises(rz.InjectedDeviceOOM, match="CUDA out of memory"):
        rz.inject.pre_dispatch("cuda")


# event sequences of tests/test_resilience.py:76-201: ("fail", backend,
# kind[, probe]), ("success", backend, probe), ("sleep", s), ("acquire",
# backend), ("abort", backend); after each event both breakers' state is
# compared
SEQUENCES = {
    "ladder": [("fail", "jax", "oom")] * 3
    + [("fail", "native", "native_crash")] * 3,
    "probe_recloses": [("fail", "jax", "oom")] * 2
    + [("acquire", "jax"), ("sleep", 0.12), ("acquire", "jax"),
       ("acquire", "jax"), ("success", "jax", False),
       ("success", "jax", True), ("acquire", "jax"),
       ("fail", "jax", "oom")],
    "probe_fail_reopens": [("fail", "jax", "oom")] * 2
    + [("sleep", 0.12), ("acquire", "jax"), ("fail", "jax", "oom", False),
       ("fail", "jax", "hang", True), ("acquire", "jax"), ("sleep", 0.12),
       ("acquire", "jax"), ("success", "jax", True)],
    "abort_probe": [("fail", "jax", "oom")] * 2
    + [("sleep", 0.12), ("acquire", "jax"), ("abort", "jax"),
       ("acquire", "jax"), ("sleep", 0.12), ("acquire", "jax")],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_breaker_transitions_equal_jax(monkeypatch, name):
    from abpoa_tpu import obs as jobs
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    monkeypatch.setenv("ABPOA_TPU_BREAKER_COOLDOWN_S", "0.1")
    monkeypatch.setenv("ABPOA_TPU_BREAKER_THRESHOLD",
                       "3" if name == "ladder" else "2")
    jb, pb = jrz.breaker(), rz.breaker()

    def state():
        return [(jb.is_open(b), PORT_NAME.get(jb.effective(b)))
                for b in ("jax", "native")], \
               [(pb.is_open(PORT_NAME[b]), pb.effective(PORT_NAME[b]))
                for b in ("jax", "native")]

    for ev in SEQUENCES[name]:
        op = ev[0]
        if op == "sleep":
            time.sleep(ev[1])
            continue
        b, pbn = ev[1], PORT_NAME[ev[1]]
        if op == "fail":
            probe = ev[3] if len(ev) > 3 else False
            jb.record_failure(b, ev[2], probe=probe)
            pb.record_failure(pbn, ev[2], probe=probe)
        elif op == "success":
            jb.record_success(b, probe=ev[2])
            pb.record_success(pbn, probe=ev[2])
        elif op == "acquire":
            assert jb.acquire(b) == pb.acquire(pbn), ev
        elif op == "abort":
            jb.abort_probe(b)
            pb.abort_probe(pbn)
        js, ps = state()
        assert js == ps, (ev, js, ps)
    jrep, prep = jobs.finalize_report(), obs.finalize_report()
    jdeg = {PORT_NAME[k]: (PORT_NAME.get(v["to"]), v["reason"],
                           v["failures"])
            for k, v in (jrep["degraded"] or {}).items()}
    pdeg = {k: (v["to"], v["reason"], v["failures"])
            for k, v in (prep["degraded"] or {}).items()}
    assert pdeg == jdeg
    jc = {k.replace(".jax", ".cpu").replace(".numpy", ".plain"): v
          for k, v in jrep["counters"].items() if k.startswith("breaker.")}
    pc = {k: v for k, v in prep["counters"].items()
          if k.startswith("breaker.")}
    assert pc == jc
    obs.start_run()  # a new run closes the port's breakers
    assert not pb.is_open("cpu") and not pb.is_open("native")


def test_breaker_probe_through_guarded_dispatch(monkeypatch):
    from abpoa_tpu_torch import resilience as rz
    monkeypatch.setenv("ABPOA_TPU_BREAKER_COOLDOWN_S", "0.1")
    monkeypatch.setenv("ABPOA_TPU_BREAKER_THRESHOLD", "1")
    br = rz.breaker()
    br.record_failure("cpu", "oom")
    calls = []
    with pytest.raises(rz.DispatchFailed) as ei:
        rz.guarded_device_call("t", "cpu", lambda: calls.append(1))
    assert ei.value.kind == "breaker_open" and not calls
    time.sleep(0.12)
    assert rz.guarded_device_call("t", "native", lambda: "ok") == "ok"
    assert "cpu" in br.open  # native's dispatch probes nothing of cpu
    # the next cpu dispatch is the half-open probe, and recloses
    assert rz.guarded_device_call("t", "cpu", lambda: "ok") == "ok"
    assert not br.is_open("cpu")
    # the card has no rung below it: its failures never open a breaker
    for _ in range(3):
        br.record_failure("cuda", "oom")
    assert not br.open and br.effective("cuda") == "cuda"


def test_breaker_abort_probe_on_unclassified(monkeypatch):
    from abpoa_tpu_torch import resilience as rz
    monkeypatch.setenv("ABPOA_TPU_BREAKER_COOLDOWN_S", "0.1")
    monkeypatch.setenv("ABPOA_TPU_BREAKER_THRESHOLD", "1")
    br = rz.breaker()
    br.record_failure("cpu", "oom")
    time.sleep(0.12)
    with pytest.raises(TypeError):
        rz.guarded_device_call(
            "t", "cpu", lambda: (_ for _ in ()).throw(TypeError("bug")))
    assert br.is_open("cpu") and not br.open["cpu"]["probing"]


_STICKY_MSG = ("banded_dp launch: CUDA error 700 (an illegal memory "
               "access was encountered)")


def _no_cuda_calls(monkeypatch):
    """Fail the test at any call into torch.cuda that a lost card must not
    see."""
    for name in ("mem_get_info", "synchronize", "empty_cache",
                 "current_device", "current_stream", "device_count",
                 "get_device_name", "get_device_properties", "is_initialized",
                 "memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: pytest.fail(
                                f"torch.cuda.{_n} called on a lost card"))


@pytest.mark.parametrize("kind", ["hang", "sticky"])
def test_cuda_hang_trips_the_breaker_at_once(monkeypatch, kind):
    """A watchdog timeout or a sticky CUDA error on `cuda` ends the card's
    part in the run at once: CardFailure (no retry, no fallback), the card
    marked lost, and every later dispatch, admission or set of the run
    raises CardFailure with no call into torch.cuda. On `cpu` the
    threshold holds, as in JAX."""
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import pipeline as pl
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.io.fastx import read_fastx
    from abpoa_tpu_torch.kernels import build
    from abpoa_tpu_torch.params import Params
    from conftest import DATA_DIR
    monkeypatch.setenv("ABPOA_TPU_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("ABPOA_TPU_WATCHDOG_FORCE", "1")  # supervise cpu
    monkeypatch.setattr(rz.watchdog, "_caller_context",
                        lambda: lambda: __import__("contextlib").ExitStack())
    if kind == "hang":
        def fn():
            time.sleep(1.0)
        kw = dict(deadline_s=0.05)
    else:
        def fn():
            raise RuntimeError(_STICKY_MSG)
        kw = {}
    with pytest.raises(rz.DispatchFailed) as ei:
        rz.guarded_device_call("t", "cpu", fn, **kw)
    assert not rz.breaker().is_open("cpu")
    calls = []
    with pytest.raises(rz.CardFailure) as ci:
        rz.guarded_device_call("t", "cuda", lambda: (calls.append(1), fn()),
                               **kw)
    want = "hang" if kind == "hang" else "dispatch_error"
    assert ei.value.kind == ci.value.kind == want and len(calls) == 1
    _no_cuda_calls(monkeypatch)
    with pytest.raises(rz.CardFailure):
        rz.guarded_device_call("t", "cuda", lambda: calls.append(2))
    with pytest.raises(rz.CardFailure):
        rz.memory.budget_bytes(torch.device("cuda"), 1)
    with pytest.raises(rz.CardFailure):
        rz.memory.plane_budget(torch.device("cuda"), 1)
    # the next set of the run: its fused route stops before admission
    monkeypatch.setattr(build, "load", lambda: None)
    monkeypatch.setattr(obs, "note_device", lambda dev: None)
    abpt = Params(device="cpu").finalize()
    abpt.torch_device = torch.device("cuda")
    with pytest.raises(rz.CardFailure):
        pl.msa(pl.Abpoa(), abpt, read_fastx(os.path.join(DATA_DIR, "seq.fa")),
               None)
    assert calls == [1]
    rep = obs.finalize_report()
    assert rep["degraded"] is None
    assert [(f["kind"], f["backend"], f["action"])
            for f in rep["faults"]["records"]] == [
        (want, "cpu", "fallback"), (want, "cuda", "abort")]
    assert rep["counters"]["breaker.lost.cuda"] == 1


def test_card_has_no_host_rung(monkeypatch):
    """On `cuda` the per-read route is the card's last rung: a result that
    breaks a guard, and a dispatch whose retry is used up, raise
    CardFailure; the window is never aligned on the host."""
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.align import dispatch
    from abpoa_tpu_torch.align.result import AlignResult
    from abpoa_tpu_torch.params import Params
    monkeypatch.setenv("ABPOA_TPU_BACKOFF_S", "0")
    monkeypatch.setattr(rz.watchdog, "_caller_context",
                        lambda: lambda: __import__("contextlib").ExitStack())
    monkeypatch.setattr(dispatch, "_host_rerun",
                        lambda *a, **k: pytest.fail("host rerun on cuda"))

    class G:
        node_n = 10
    abpt = Params(device="cpu").finalize()
    bad = AlignResult()
    bad.best_score = 1 << 40
    with pytest.raises(rz.CardFailure) as ei:
        dispatch._checked(bad, G(), abpt, (0, 1, np.zeros(5, np.uint8)),
                          "cuda")
    assert ei.value.kind == "garbage_output"
    rz.inject.configure("oom")
    monkeypatch.setattr(dispatch, "align_windows_banded",
                        lambda *a, **k: pytest.fail("dispatched"))
    with pytest.raises(rz.CardFailure) as ei:
        dispatch._device_windows(G(), abpt, [(0, 1, np.zeros(5, np.uint8))],
                                 None, "cuda")
    assert ei.value.kind == "oom"
    # nested in an outer envelope (a guarded lockstep piece), it ends the
    # run too: its "out of memory" text is not read as a fault again
    assert rz.classify(ei.value) is None
    rep = obs.finalize_report()
    assert [(f["kind"], f["action"]) for f in rep["faults"]["records"]] == [
        ("garbage_output", "abort"), ("oom", "retry"), ("oom", "abort")]


@pytest.mark.parametrize("route", ["per_read", "abort"])
def test_card_admission_stays_on_the_card(monkeypatch, route):
    """A set over the admission budget on `cuda` takes the per-read route
    where B2's planes fit the budget, and otherwise stops the run before
    any allocation (CardFailure); it never goes to the host. At this shape
    B2's int32 planes on their wider band need more than B1's, so the
    per-read case stands a smaller estimate in for them."""
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import pipeline as pl
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.align import fused_loop
    from abpoa_tpu_torch.params import Params
    monkeypatch.setenv("ABPOA_TPU_MEM_BUDGET_MB", "3")
    _no_cuda_calls(monkeypatch)
    monkeypatch.setattr(fused_loop, "progressive_poa_fused",
                        lambda *a, **k: pytest.fail("fused dispatch"))
    abpt = Params(device="cpu").finalize()
    abpt.torch_device = torch.device("cuda")
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, 1500).astype(np.uint8) for _ in range(3)]
    caps = fused_loop.plan_dispatch_footprint(abpt, [seqs])
    assert rz.memory.per_read_bytes(caps) > rz.memory.estimate_bytes(caps) \
        > 3e6
    if route == "per_read":
        monkeypatch.setattr(rz.memory, "per_read_bytes", lambda caps: 2e6)
    ab = pl.Abpoa()
    if route == "per_read":
        assert pl._run_fused_device(ab, abpt, seqs, [None] * 3) == "per_read"
    else:
        with pytest.raises(rz.CardFailure, match="does not fit the card"):
            pl._run_fused_device(ab, abpt, seqs, [None] * 3)
    rep = obs.finalize_report()
    assert [(f["kind"], f["backend"], f["action"])
            for f in rep["faults"]["records"]] == [
        ("admission", "cuda", "per_read" if route == "per_read"
         else "abort")]


# (spec, kind, retry, breaks, the port's differs from JAX's): an unknown
# RuntimeError, and "compil" in one, propagate out of the port's envelope
# (JAX absorbs them as dispatch_error and compile_fail)
CLASSIFY = [
    ("injected_oom", "oom", True, True, False),
    ("RuntimeError:RESOURCE_EXHAUSTED: oom", "oom", True, True, False),
    ("RuntimeError:XLA compilation failed", None, None, None, True),
    ("RuntimeError:fused loop: 3 sequential-fusion fallbacks",
     "fused_bail", False, False, False),
    ("RuntimeError:fused lockstep batch: capacity growth did not converge",
     "fused_bail", False, False, False),
    ("timeout", "hang", False, True, False),
    ("RuntimeError:native DP kernel failed (rc=-11)", "native_crash", False,
     True, False),
    ("RuntimeError:something else", None, None, None, True),
    ("TypeError:bug", None, None, None, False),
]


def _exc(pkg, spec):
    if spec == "injected_oom":
        return pkg.InjectedDeviceOOM("x")
    if spec == "timeout":
        return pkg.DispatchTimeout("t")
    cls, _, msg = spec.partition(":")
    return {"RuntimeError": RuntimeError, "TypeError": TypeError}[cls](msg)


@pytest.mark.parametrize("spec,kind,retry,breaks,differs", CLASSIFY)
def test_classify_equals_jax(spec, kind, retry, breaks, differs):
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import resilience as rz
    got = rz.classify(_exc(rz, spec))
    assert (got != jrz.classify(_exc(jrz, spec))) == differs
    assert got == (None if kind is None else (kind, retry, breaks))


@pytest.mark.parametrize("msg,kind", [
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "oom"),
    ("fused_dp launch: CUDA error 2 (out of memory)", "oom"),
    ("banded_dp launch: CUDA error 700 (an illegal memory access was "
     "encountered)", "dispatch_error"),
    ("topo_sort launch: CUDA error 719 (unspecified launch failure)",
     "dispatch_error"),
    ("backtrack launch: CUDA error 710 (device-side assert triggered)",
     "dispatch_error"),
    ("device lockstep: backtrack found no path at read 3", "fused_bail"),
])
def test_classify_cuda_strings(msg, kind):
    from abpoa_tpu_torch import resilience as rz
    got = rz.classify(RuntimeError(msg))
    assert got[0] == kind
    if kind == "dispatch_error":
        assert got == ("dispatch_error", False, True)  # sticky: no retry
    if hasattr(torch.cuda, "OutOfMemoryError"):
        assert rz.classify(torch.cuda.OutOfMemoryError(
            "CUDA out of memory."))[:2] == ("oom", True)


@pytest.mark.parametrize("msg", [
    "nvcc failed (1):\ncompilation terminated.",
    "the kernel library x.so cannot be loaded: out of memory"])
def test_kernel_build_error_is_never_absorbed(msg):
    """JAX's table would read nvcc's "compil" as compile_fail and demote;
    a KernelBuildError propagates out of the envelope, and no fault is
    recorded."""
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.kernels.build import KernelBuildError
    assert rz.classify(KernelBuildError(msg)) is None
    obs.start_run()
    for backend in ("cpu", "cuda", "native"):
        with pytest.raises(KernelBuildError):
            rz.guarded_device_call(
                "t", backend,
                lambda: (_ for _ in ()).throw(KernelBuildError(msg)))
    rep = obs.finalize_report()
    assert rep["faults"] is None and rep["degraded"] is None


def test_failed_nvcc_raises_kernel_build_error(monkeypatch, tmp_path):
    """No nvcc (as on this CPU host): the build raises KernelBuildError,
    which the CLI does not absorb."""
    from abpoa_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.exists(p) and not os.path.isdir(p))
    with pytest.raises(build.KernelBuildError):
        build.build()


GUARD_CASES = [
    ("ok", [(0, 1, 2, 0), (0, 1, 3, 1), (0, 1, 4, 2), (0, 1, 5, 3)], 8),
    ("truncated", [(0, 1, 2, 0), (0, 1, 3, 1)], 8),
    ("absurd_score", [], 1 << 40),
    ("graph_nodes", [(2, 50, 2, 0)], 0),
    ("over_query", [(1, 9, 2, 0)], 0),
    ("bad_op", None, 0),
    ("unpackable", [-5], 0),
    ("non_int", [], "x"),
]


@pytest.mark.parametrize("name,ops,score", GUARD_CASES)
def test_guard_strings_equal_jax(name, ops, score):
    from abpoa_tpu.align.result import AlignResult as JRes
    from abpoa_tpu.cigar import push_cigar as jpush
    from abpoa_tpu.params import Params as JParams
    from abpoa_tpu.resilience.guards import align_result_violation as jv
    from abpoa_tpu_torch.align.result import AlignResult as PRes
    from abpoa_tpu_torch.cigar import push_cigar as ppush
    from abpoa_tpu_torch.params import Params as PParams
    from abpoa_tpu_torch.resilience.guards import \
        align_result_violation as pv
    out = []
    for Res, push, abpt, v in (
            (JRes, jpush, JParams().finalize(), jv),
            (PRes, ppush, PParams(device="cpu").finalize(), pv)):
        res = Res()
        if ops is None:
            res.cigar = [0xF]
        elif ops and not isinstance(ops[0], tuple):
            res.cigar = list(ops)
        else:
            for op, ln, nid, q in ops:
                push(res.cigar, op, ln, nid, q)
        res.best_score = score
        out.append(v(res, 4, 10, abpt))
    assert out[0] == out[1]
    assert (out[1] is None) == (name == "ok")


@pytest.mark.parametrize("bases,m", [
    ([0, 1, 2, 3, 4], 5), ([0, 99], 5), ([-1, 2], 5), ([], 5),
    ([26, 3], 27), ([27], 27)])
def test_graph_and_consensus_guards_equal_jax(bases, m):
    from abpoa_tpu.resilience import guards as jg
    from abpoa_tpu_torch.resilience import guards as pg
    arr = np.array(bases, dtype=np.int32)
    res = []
    for g in (jg, pg):
        try:
            g.check_graph_bases(arr, m)
            res.append(None)
        except g.GarbageOutput as e:
            res.append(str(e))

    class Cons:
        cons_base = [arr, np.array([1, 2])]
    res.append(jg.consensus_violation(Cons, m))
    res.append(pg.consensus_violation(Cons, m))
    assert res[0] == res[1] and res[2] == res[3]


def test_watchdog_deadline_and_context():
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.obs import trace
    wd = rz.watchdog
    assert wd.call_with_deadline(lambda: 41 + 1, 5.0) == 42
    with pytest.raises(ZeroDivisionError):
        wd.call_with_deadline(lambda: 1 // 0, 5.0)
    with pytest.raises(rz.DispatchTimeout):
        wd.call_with_deadline(lambda: time.sleep(0.5), 0.05, label="t")
    assert wd.call_with_deadline(lambda: "x", 0) == "x"
    # the worker runs in the caller's request context (thread-local)
    with trace.request_ctx("abc123", 2):
        got = wd.call_with_deadline(
            lambda: (threading.current_thread().name,
                     trace.current_request()), 5.0, label="ctx")
    assert got == ("abpoa-watchdog:ctx", ("abc123", 2))


@pytest.mark.parametrize("backend,armed,force,want", [
    ("cuda", False, False, True), ("cpu", False, False, False),
    ("cpu", True, False, True), ("cpu", False, True, True),
    ("native", True, True, False), ("plain", True, False, False)])
def test_supervision_needed(monkeypatch, backend, armed, force, want):
    from abpoa_tpu_torch import resilience as rz
    if force:
        monkeypatch.setenv("ABPOA_TPU_WATCHDOG_FORCE", "1")
    rz.inject.configure("oom:1" if armed else "")
    assert rz.watchdog.supervision_needed(backend) is want


# ----------------------------------------------------------------- memory
@pytest.mark.parametrize("N,E,A,W,plane16,R,Qp,paths", [
    (128, 8, 8, 128, True, 3, 128, False),
    (1024, 8, 8, 256, False, 5, 512, True),
    (2048, 16, 8, 512, True, 2, 1024, True),
])
def test_estimate_parts_equal_allocations(N, E, A, W, plane16, R, Qp,
                                          paths):
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.fused_dp_kernel import fused_dp_lanes
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.resilience import memory
    nb = lambda ts: sum(t.nbytes for t in ts)  # noqa: E731
    st = fl.init_fused_state(N, E, A, "cpu", n_reads=R if paths else 0,
                             Pcap=Qp + 2)
    got = nb(v for v in st.g.tensors().values()) + nb(
        [st.order, st.n2i, st.remain])
    if paths:
        got += nb([st.paths, st.path_lens])
    assert got == memory.state_bytes(N, E, A, R if paths else 0, Qp + 2)
    assert nb(fl._build_tables(st.g, st.order, st.n2i, st.remain)) \
        == memory.table_bytes(N, E)
    abpt = Params(device="cpu").finalize()
    rng = np.random.default_rng(N)
    seqs = [rng.integers(0, 4, size=Qp - 3).astype(np.uint8)
            for _ in range(R)]
    arrs = fl._pad_read_set(seqs, [np.ones(len(s), np.int64) for s in seqs],
                            Qp, abpt.mat.astype(np.int32), abpt.m)
    assert (arrs[0].nbytes + arrs[1].nbytes + arrs[3].nbytes
            + abpt.mat.astype(np.int32).nbytes) \
        == memory.read_bytes(R, Qp, abpt.m)
    # B1's plain version: the planes as the card allocates them, beg/end,
    # ok and ext (the kernel adds its row scratch, 2 R int32 a lane)
    L, Rr = 2, 64
    args = _b1_args(abpt, L, Rr, W, plane16)
    out = fused_dp_lanes(*args, gap_mode=abpt.gap_mode, plane16=plane16,
                         extend=False, zdrop_on=False, local=False)
    assert out[0].nbytes * 5 == L * memory.plane_bytes(Rr, W, plane16)
    assert nb(out) + L * 2 * Rr * 4 == memory.dp_bytes(Rr, W, plane16, L)
    caps = dict(N=N, E=E, A=A, W=W, Qp=Qp, reads=R, K=3, plane16=plane16,
                m=abpt.m, paths=paths)
    assert memory.estimate_bytes(caps) == 3 * (
        memory.state_bytes(N, E, A, R if paths else 0, Qp + 2)
        + memory.dp_bytes(N, W, plane16) + memory.table_bytes(N, E)
        + memory.read_bytes(R, Qp, abpt.m))


def _b1_args(abpt, L, R, W, plane16):
    """Inputs of B1's lane form: L lanes of an R-row chain graph."""
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.device_graph import init_device_graph
    from abpoa_tpu_torch.align.fused_lanes import dp_inputs_l
    from abpoa_tpu_torch.align.fused_lanes import stack_graphs
    st = fl.init_fused_state(R, 8, 8, "cpu")
    g = stack_graphs([init_device_graph(R, 8, 8, "cpu")] * L)
    tables = [torch.stack([t] * L) for t in
              fl._build_tables(st.g, st.order, st.n2i, st.remain)]
    qp = torch.zeros((L, abpt.m, 64), dtype=torch.int32)
    args, _ = dp_inputs_l(abpt, g, torch.stack([st.remain] * L), tables,
                          qp, [40] * L, W, -1 << 14, False)
    return args


def test_admission_decisions(monkeypatch):
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch.resilience import memory
    caps = dict(N=20480, E=8, A=8, W=256, Qp=10240, reads=50, K=8,
                plane16=False, m=5)
    one = memory.per_set_bytes(caps)
    monkeypatch.delenv("ABPOA_TPU_MEM_BUDGET_MB", raising=False)
    assert memory.budget_bytes(torch.device("cpu")) is None
    assert memory.admit(caps, torch.device("cpu"))[0] == "ok"
    monkeypatch.setenv("ABPOA_TPU_MEM_BUDGET_MB", "0")
    assert memory.admit(caps)[0] == "ok"
    monkeypatch.setenv("ABPOA_TPU_MEM_BUDGET_MB", str(3.5 * one / 1e6))
    assert memory.admit(caps)[0] == "chunk"
    assert memory.max_sets_within(caps) == 3
    monkeypatch.setenv("ABPOA_TPU_MEM_BUDGET_MB", str(0.5 * one / 1e6))
    assert memory.admit(caps)[0] == "demote"
    c = obs.report().counters
    assert c["admission.chunk"] == 1 and c["admission.demote"] == 1


def test_plane_groups_take_the_memory_formula():
    """The device lockstep's plane groups and admission price a lane's
    planes with one function, and off the card there is no limit."""
    from abpoa_tpu_torch.align import fused_lanes
    from abpoa_tpu_torch.resilience import memory
    assert memory.plane_budget(torch.device("cpu"), 1 << 40) is None
    lane = memory.plane_bytes(20480, 16384, False)
    assert lane == 5 * 20480 * 16384 * 4
    assert fused_lanes.plane_groups(list(range(8)), lane, 3 * lane) == \
        [[0, 1, 2], [3, 4, 5], [6, 7]]


def test_footprint_follows_the_planners():
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch.align.buckets import chunk_node_cap, \
        plan_chunk_buckets
    from abpoa_tpu_torch.params import Params
    abpt = Params(device="cpu").finalize()
    sets = [[np.zeros(900, np.uint8)] * 4, [np.zeros(1500, np.uint8)] * 7]
    caps = fl.plan_dispatch_footprint(abpt, sets, n0=300)
    Qp, W, _ = plan_chunk_buckets(abpt, 1500)
    assert (caps["N"], caps["W"], caps["Qp"], caps["reads"], caps["K"]) == \
        (chunk_node_cap(1500, 300), W, Qp, 7, 2)


# --------------------------------------------- the structural overhead twin
@pytest.mark.parametrize("device", ["cpu", "native"])
def test_disarmed_host_run_starts_no_thread_and_no_sync(monkeypatch,
                                                        device):
    """With injection disarmed, a `cpu` or `native` run never enters the
    watchdog (no worker thread) and adds no host sync: the fused loop's
    sync count is the same with the envelope on and off."""
    import io
    from abpoa_tpu_torch.align import fused_loop as fl
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.params import Params
    from abpoa_tpu_torch.pipeline import Abpoa, msa_from_file
    from conftest import DATA_DIR
    started = []
    real = threading.Thread.start

    def spy(self):
        started.append(self.name)
        return real(self)
    monkeypatch.setattr(threading.Thread, "start", spy)
    monkeypatch.setattr(rz.watchdog, "call_with_deadline",
                        lambda *a, **k: pytest.fail("watchdog entered"))
    outs = []
    for on in (True, False):
        rz.set_enabled(on)
        fl.reset_stats()
        buf = io.StringIO()
        msa_from_file(Abpoa(), Params(device=device).finalize(),
                      os.path.join(DATA_DIR, "seq.fa"), buf)
        outs.append((buf.getvalue(), fl.stats["syncs"]))
    assert outs[0] == outs[1]
    assert not [n for n in started if n.startswith("abpoa-watchdog")]


# ------------------------------------- the per-read route and the mesh
@pytest.mark.parametrize("spec,faults", [
    ("", []),
    ("oom:1", [("oom", "retry")]),
    ("compile_fail:1", [("compile_fail", "retry")]),
    ("garbage:1", [("garbage_output", "host_rerun")]),
    ("hang:1", [("hang", "fallback")]),
    ("oom", [("oom", "retry"), ("oom", "fallback"), ("oom", "fallback")]),
])
def test_per_read_route_absorbs_each_kind(monkeypatch, tmp_path, spec,
                                          faults):
    """`-G -r 2` on the per-read route (B2's plain version a read): each
    kind's output equals the uninjected run's (seq.fa's MSA, the same as
    the JAX CLI gives on its host engine)."""
    from test_torch_resilience_cli import SEQ, _faults, _run
    monkeypatch.setenv("ABPOA_TPU_WATCHDOG_S", "1")
    monkeypatch.setenv("ABPOA_TPU_INJECT_HANG_S", "2")
    argv = [SEQ, "-G", "-r", "2", "--device", "cpu"]
    rc, out, _, rep = _run("port", argv, spec, tmp_path)
    want = _run("jax", [SEQ, "-G", "-r", "2", "--device", "native"], "",
                tmp_path)[1]
    assert (rc, out) == (0, want)
    assert _faults(rep) == faults
    if spec == "oom":
        # demoted to native; -G keeps the Python graph, so plain serves
        assert rep["degraded"]["cpu"]["to"] == "native"
        assert rep["counters"]["fallback.native_to_plain"] > 0
    if spec in ("garbage:1", "hang:1"):
        assert rep["counters"]["dispatch.rerun.plain"] == 1


def test_sharded_list_falls_back_set_by_set(monkeypatch, tmp_path):
    """`-l --mesh 2` over two CPU devices: the piece runs under the
    envelope over the mesh, and its failure goes set by set."""
    from test_torch_resilience_cli import ROOT, _faults, _golden, _run
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", "device")
    argv = ["-l", os.path.join("tests", "data", "list.txt"), "--lockstep",
            "on", "--mesh", "2", "--device", "cpu"]
    for spec in ("", "oom:2"):
        rc, out, err, rep = _run("port", argv, spec, tmp_path)
        assert (rc, out) == (0, _golden("list_mode.txt"))
        os.environ.pop("ABPOA_TPU_MESH", None)
    assert _faults(rep) == [("oom", "retry"), ("oom", "fallback")]
    assert "fused lockstep batch failed" in err
