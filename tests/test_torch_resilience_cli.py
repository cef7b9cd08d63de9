"""Injected faults through the port's CLI, `-l` and `msa_batch` on the CPU,
against the uninjected run and the JAX package.

Every injector leaves the run complete and its output byte-identical to
the run without injection (and to the golden or the JAX CLI), with the
fault in the report. Where the JAX package dispatches the same route on
its device backend (`--device jax`, here on XLA:CPU), the `faults` records
carry the same kinds and actions in the same order (backend names differ:
the port's `cpu` is JAX's `jax`): the fused route under each kind, `-l`
under an unlimited `oom`, `msa_batch` and the native rung's
`native_crash`. The device lockstep's per-set isolation is held to the
uninjected run and to JAX's rule. A kernel build failure propagates, and
a run with no card and no `--device cpu|native` raises. The per-read
route and the sharded `-l` are in test_torch_resilience.py.
"""
import contextlib
import io
import json
import os

import pytest
import torch

from conftest import DATA_DIR, GOLDEN_DIR

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = os.path.join(DATA_DIR, "seq.fa")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import resilience as rz
    monkeypatch.setenv("ABPOA_TPU_ARCHIVE", "0")
    for pkg in (rz, jrz):
        pkg.inject.reset()
        pkg.breaker().reset()
    yield
    for pkg in (rz, jrz):
        pkg.inject.reset()
        pkg.breaker().reset()


def _run(pkg, argv, spec, tmp_path):
    """(rc, stdout, stderr, report) of a CLI run with `spec` armed."""
    if pkg == "jax":
        from abpoa_tpu import resilience as rz
        from abpoa_tpu.cli import main
    else:
        from abpoa_tpu_torch import resilience as rz
        from abpoa_tpu_torch.cli import main
    rep = tmp_path / f"{pkg}_report.json"
    out, err = io.StringIO(), io.StringIO()
    rz.inject.configure(spec)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = main(argv + ["--report", str(rep)])
    finally:
        rz.inject.reset()
    with open(rep) as fp:
        return rc, out.getvalue(), err.getvalue(), json.load(fp)


def _faults(rep):
    return [(f["kind"], f.get("action"))
            for f in (rep["faults"] or {}).get("records", [])]


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as fp:
        return fp.read()


# (spec, hang deadline): the count-limited kinds run after the unlimited
# ones so that JAX's compiles are warm in this process before a short
# watchdog deadline supervises them
FUSED_SPECS = ["oom", "compile_fail", "oom:1", "compile_fail:1",
               "garbage:1", "hang:1", "hang"]


@pytest.mark.parametrize("spec", FUSED_SPECS)
def test_fused_route_faults_equal_jax(monkeypatch, tmp_path, spec):
    if spec == "hang":  # every device dispatch hangs: nothing compiles
        monkeypatch.setenv("ABPOA_TPU_WATCHDOG_S", "0.3")
        monkeypatch.setenv("ABPOA_TPU_INJECT_HANG_S", "0.6")
    elif spec == "hang:1":
        monkeypatch.setenv("ABPOA_TPU_WATCHDOG_S", "3")
        monkeypatch.setenv("ABPOA_TPU_INJECT_HANG_S", "4")
    want = _golden("ref_consensus.txt")
    prc, pout, perr, prep = _run("port", [SEQ, "--device", "cpu"], spec,
                                 tmp_path)
    jrc, jout, _, jrep = _run("jax", [SEQ, "--device", "jax"], spec,
                              tmp_path)
    assert (prc, pout) == (0, want) == (jrc, jout)
    assert _faults(prep) == _faults(jrep)
    assert _faults(prep) and prep["counters"][
        f"inject.{spec.split(':')[0]}"] >= 1
    if spec in ("oom", "compile_fail", "hang"):
        # the breaker opened: cpu -> native, as JAX's jax -> native, and
        # the rest of the run ran on the host rung
        assert prep["degraded"] == {"cpu": {
            "to": "native", "reason": spec, "failures": 3}}
        assert jrep["degraded"]["jax"]["to"] == "native"
        assert "circuit breaker opened" in perr
        assert prep["counters"]["dispatch.native"] > 0
    else:
        assert prep["degraded"] is None and jrep["degraded"] is None
    if _faults(prep)[-1][1] == "fallback":
        assert "fused device loop failed" in perr
        assert prep["counters"]["fallback.fused_to_per_read"] == 1
    # every absorbed fault printed its line
    assert perr.count(" absorbed (") == len(_faults(prep))


@pytest.mark.parametrize("spec", ["native_crash:1", "native_crash",
                                  "garbage:1"])
def test_native_rung_faults_equal_jax(tmp_path, spec):
    """`--device native`: a crashed or garbage native dispatch is aligned
    again on the floor (JAX's numpy, the port's plain)."""
    prc, pout, _, prep = _run("port", [SEQ, "--device", "native"], spec,
                              tmp_path)
    jrc, jout, _, jrep = _run("jax", [SEQ, "--device", "native"], spec,
                              tmp_path)
    assert (prc, pout) == (0, _golden("ref_consensus.txt")) == (jrc, jout)
    assert _faults(prep) == _faults(jrep)
    rerun = prep["counters"].get("dispatch.rerun.plain", 0)
    assert rerun == jrep["counters"].get("dispatch.rerun.numpy", 0) >= 1
    if spec == "native_crash":
        assert prep["degraded"]["native"]["to"] == "plain"


@pytest.mark.parametrize("impl,spec,faults", [
    ("split", "oom", [("oom", "retry"), ("oom", "fallback"),
                      ("oom", "fallback")]),
    ("device", "oom", [("oom", "retry"), ("oom", "fallback"),
                       ("oom", "fallback")]),
    ("split", "poison_set:1", [("poisoned_set", "quarantined")]),
    ("device", "garbage:1", [("garbage_output", "sequential_rerun")]),
    ("device", "oom:1", [("oom", "retry")]),
])
def test_list_mode_faults(monkeypatch, tmp_path, impl, spec, faults):
    """`-l` in lockstep (both implementations): the output equals the
    golden; the unlimited `oom` and `poison_set:1` give JAX's faults (its
    split lockstep on XLA:CPU, its quarantine), and a garbage set in the
    device lockstep is rerun alone (JAX fused_loop.py:2135-2160)."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ABPOA_TPU_LOCKSTEP_IMPL", impl)
    argv = ["-l", os.path.join("tests", "data", "list.txt"),
            "--lockstep", "on"]
    rc, out, err, rep = _run("port", argv + ["--device", "cpu"], spec,
                             tmp_path)
    assert _faults(rep) == faults
    if spec == "poison_set:1":
        assert rc == 0 and "set 0 (tests/data/seq.fa) quarantined" in err
        jargs = argv + ["--device", "numpy"]
    else:
        assert (rc, out) == (0, _golden("list_mode.txt"))
        jargs = argv + ["--device", "jax"]
    if spec in ("oom", "poison_set:1") and impl == "split":
        jrc, jout, _, jrep = _run("jax", jargs, spec, tmp_path)
        assert (jrc, jout) == (rc, out)
        assert _faults(jrep) == faults
    if spec == "oom":
        assert "fused lockstep batch failed" in err
        assert rep["counters"]["fallback.lockstep_to_sequential"] >= 1
    if spec == "garbage:1":
        assert rep["counters"]["breaker.failures.cpu"] == 1
        assert rep["faults"]["records"][0]["set"] == 0


def test_msa_batch_faults_equal_jax():
    """`msa_batch` in lockstep under an unlimited `oom`: every set equals
    its uninjected result, and the faults equal JAX's."""
    from abpoa_tpu import obs as jobs
    from abpoa_tpu import pyapi as jpa
    from abpoa_tpu import resilience as jrz
    from abpoa_tpu_torch import obs
    from abpoa_tpu_torch import pyapi as tpa
    from abpoa_tpu_torch import resilience as rz
    from abpoa_tpu_torch.io.fastx import read_fastx
    sets = [[r.seq for r in read_fastx(os.path.join(DATA_DIR, f))]
            for f in ("seq.fa", "heter.fa", "seq4.fa")]
    want = [r.cons_seq for r in tpa.msa_aligner(
        device="cpu", lockstep="on").msa_batch(sets, True, False)]
    rz.inject.configure("oom")
    got = [r.cons_seq for r in tpa.msa_aligner(
        device="cpu", lockstep="on").msa_batch(sets, True, False)]
    prep = obs.finalize_report()
    jrz.inject.configure("oom")
    jgot = [r.cons_seq for r in jpa.msa_aligner(device="jax").msa_batch(
        sets, True, False)]
    jrep = jobs.finalize_report()
    assert got == want == jgot
    assert _faults(prep) == _faults(jrep) and _faults(prep)
    assert prep["degraded"]["cpu"]["to"] == "native"


def test_kernel_build_failure_propagates(monkeypatch):
    """A KernelBuildError inside a guarded dispatch is not absorbed: the
    CLI raises (a non-zero exit) and records no demotion."""
    from abpoa_tpu_torch import cli, obs
    from abpoa_tpu_torch.align import fused_loop
    from abpoa_tpu_torch.kernels.build import KernelBuildError

    def fail(*a, **k):
        raise KernelBuildError("nvcc failed (1):\ncompilation terminated.")
    monkeypatch.setattr(fused_loop, "progressive_poa_fused", fail)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(KernelBuildError):
            cli.main([SEQ, "--device", "cpu"])
    rep = obs.finalize_report()
    assert rep["faults"] is None and rep["degraded"] is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is attached")
def test_no_card_still_raises():
    """No `auto` device: without a card and without --device cpu|native
    the port raises instead of picking the host."""
    from abpoa_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([SEQ])
