"""Structured run telemetry: the process-global `RunReport`.

Counterpart of `abpoa_tpu/obs/report.py`: the same schema name, version,
top-level keys, hooks and renderers. Where the JAX package reads jax, this
module reads torch: `device` names the card of the run's torch device
(`note_device`), and the `compiles` block is the kernel library's build
and load log (compile_log.py), whose nvcc seconds stand where JAX puts
`xla_compile_s`. `degraded` lists the circuit breakers open at the end
of the run (`resilience/breaker.py`).

The stderr verbosity ladder (utils/logging.py) answers "what happened";
this module answers "where did the time go" in machine-readable form —
the per-phase / per-counter attribution accelerated-alignment papers
report (SeGraM's per-stage cycle breakdowns, arXiv:2205.05883; AnySeq/GPU's
cell-updates-per-second per kernel stage, arXiv:2205.07610). One global
report per run, reset by `start_run()`, rendered by `finalize_report()`
into a versioned JSON schema (SCHEMA/SCHEMA_VERSION below).

Overhead contract: every hook is host-side aggregation of values the
pipeline already holds (dict increments, two `perf_counter()` calls per
phase enter/exit). Nothing here adds device syncs to the hot loop;
the port's tests hold the outputs, launch counts and host syncs equal
with reporting on and off.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from typing import Dict, Iterator, Optional

from . import compile_log as _clog
from . import metrics as _metrics
from . import trace as _trace

SCHEMA = "abpoa-tpu-run-report"
SCHEMA_VERSION = 4

# top-level keys of the rendered report, in schema order. Goldened by
# tests/test_obs.py: adding a key is a SCHEMA_VERSION bump.
# v2 adds `reads` (per-read latency records -> p50/p95/p99, the item-1
# service's SLO numbers) and `compiles` (the compile log, compile_log.py).
# v3 adds `faults` (every absorbed dispatch failure / quarantined set,
# abpoa_tpu/resilience) and `degraded` (circuit-breaker demotions active
# at the end of the run) — a clean run carries null for both.
# v4 re-bases the `reads` block on the streaming log-bucket sketch
# (obs/metrics.py LogSketch): `count`/`wall_ms`/`backends`/`fallbacks`
# now cover EVERY read — honest p50/p95/p99 past READS_CAP in O(1)
# memory — while raw records (bounded by READS_CAP, `records_kept`) feed
# only the qlen/band attribution tables.
SCHEMA_KEYS = ("schema", "schema_version", "created", "total_wall_s",
               "phase_wall_sum_s", "phases", "counters", "values",
               "reads", "compiles", "faults", "degraded", "device", "mfu")

# raw per-read record bound. Since v4 this caps only the attribution
# tables (qlen/band extents): the wall percentiles come from the sketch,
# which sees every read, so they stay honest for a long-lived process
# streaming millions of reads. Records past the cap are still counted
# (`reads.dropped`).
READS_CAP = 100_000

# fault-record bound (same contract as READS_CAP): a fault storm must not
# grow the report without bound, but the drops are counted
FAULTS_CAP = 256


class RunReport:
    """Phase timers + counters + value summaries for one run."""

    __slots__ = ("t_start", "phases", "counters", "values",
                 "reads", "reads_dropped", "wall_sketch", "read_backends",
                 "read_fallbacks", "reads_amortized", "faults",
                 "faults_dropped", "degraded", "device")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.t_start = time.perf_counter()
        self.phases: Dict[str, list] = {}    # name -> [wall_s, calls]
        self.counters: Dict[str, int] = {}   # name -> int
        self.values: Dict[str, list] = {}    # name -> [count, sum, min, max]
        # (wall_s, qlen, band_cols, backend, fallback, amortized)
        self.reads: list = []
        self.reads_dropped = 0
        # v4: the percentile path — a bounded mergeable sketch over EVERY
        # read's wall, plus exact O(1) attribution dicts; the raw list
        # above only feeds the qlen/band tables
        self.wall_sketch = _metrics.LogSketch()
        self.read_backends: Dict[str, int] = {}
        self.read_fallbacks: Dict[str, int] = {}
        self.reads_amortized = 0
        # absorbed failures (resilience layer): dicts, FAULTS_CAP-bounded
        self.faults: list = []
        self.faults_dropped = 0
        # backend -> {"to", "reason", "failures"} (circuit-breaker opens)
        self.degraded: Dict[str, dict] = {}
        # the torch device of the run (note_device), None before a route
        # resolved one
        self.device = None
        _clog.reset_run()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Accumulating wall-clock timer; re-entries add up. Phases are
        non-overlapping by convention (pipeline.py) so their sum is a
        partition of run wall time. The same (t0, dt) measurement feeds
        the trace timeline, so phase spans reconcile with phase timers
        exactly."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            # metrics._MUT (RLock) also guards this report's accumulators,
            # so the final report agrees with the (locked) Prometheus
            # counters when threads publish to both
            with _metrics._MUT:
                rec = self.phases.get(name)
                if rec is None:
                    self.phases[name] = [dt, 1]
                else:
                    rec[0] += dt
                    rec[1] += 1
            _trace.add_span(name, "phase", t0, dt)
            _metrics.publish_phase(name, dt)

    def merge_phase(self, name: str, wall_s: float, calls: int = 1) -> None:
        """Fold a phase wall measured elsewhere into this report and the
        registry: the accumulation phase() performs, without a timer."""
        with _metrics._MUT:
            rec = self.phases.get(name)
            if rec is None:
                self.phases[name] = [wall_s, calls]
            else:
                rec[0] += wall_s
                rec[1] += calls
        _metrics.publish_phase(name, wall_s)

    def count(self, name: str, n: int = 1) -> None:
        with _metrics._MUT:
            self.counters[name] = self.counters.get(name, 0) + n
        # mirror into the process-cumulative registry (curated Prometheus
        # families; names outside the map stay run-local)
        _metrics.publish_counter(name, n)

    def observe(self, name: str, value: float) -> None:
        """Value summary (count/sum/min/max) — a histogram's moments without
        bucket bookkeeping in the hot path."""
        with _metrics._MUT:
            rec = self.values.get(name)
            if rec is None:
                self.values[name] = [1, value, value, value]
            else:
                rec[0] += 1
                rec[1] += value
                if value < rec[2]:
                    rec[2] = value
                if value > rec[3]:
                    rec[3] = value

    def record_dp(self, rows: int, band_cols: int, gap_mode: int) -> None:
        """Account one DP dispatch: band extent and cell totals, so reads/s
        can be normalized to cell-updates/s (the AnySeq/GPU metric). Values
        come from host-side planning state (graph row count, band formula)
        — never from a device readback."""
        self.record_dp_cells(rows * band_cols, 1, band_cols, gap_mode)

    def record_dp_cells(self, cells: int, dispatches: int, band_cols: int,
                        gap_mode: int) -> None:
        """Pre-aggregated DP accounting (the fused loop reports its whole
        run at once from a host-side model). Single owner of the dp.*
        counter schema."""
        from .mfu import CELL_INT_OPS
        self.observe("dp.band_width", band_cols)
        self.count("dp.dispatches", dispatches)
        self.count("dp.cells", cells)
        self.count("dp.cell_ops", cells * CELL_INT_OPS.get(gap_mode, 16))

    def record_read(self, wall_s: float, qlen: int, band_cols: int,
                    backend: str, fallback: Optional[str] = None,
                    amortized: bool = False) -> None:
        """One per-read latency record (the SLO stream): wall seconds, read
        length, planned band extent, the backend that ran it, and the
        fallback reason when a faster path was bypassed. `amortized` marks
        records derived from a multi-read dispatch (fused loop / lockstep
        batch) whose wall was split evenly across its reads — the per-read
        number is then a share, not an independent measurement."""
        # the sketch and the attribution dicts see EVERY read (O(1) each);
        # only the raw record list is capped. One lock spans the whole
        # record so concurrent publishers keep count and sketch consistent
        with _metrics._MUT:
            self.wall_sketch.observe(wall_s)
            self.read_backends[backend] = \
                self.read_backends.get(backend, 0) + 1
            if fallback:
                self.read_fallbacks[fallback] = \
                    self.read_fallbacks.get(fallback, 0) + 1
            if amortized:
                self.reads_amortized += 1
            if len(self.reads) < READS_CAP:
                self.reads.append((wall_s, qlen, band_cols, backend,
                                   fallback, amortized))
            else:
                self.reads_dropped += 1
        _metrics.publish_read(wall_s, backend, fallback)

    def record_fault(self, kind: str, backend: Optional[str] = None,
                     set_index: Optional[int] = None, detail: str = "",
                     action: str = "", extra: Optional[dict] = None) -> None:
        """One absorbed failure (abpoa_tpu/resilience): what failed, where
        it was headed, and what the degradation ladder did about it. The
        contract of that layer is that NOTHING is swallowed silently —
        every fallback/demotion/quarantine lands here (and in the
        `faults.<kind>` counter) even when the run then succeeds. `extra`
        adds flat fields (a caller's cross-references) to the record."""
        self.count(f"faults.{kind}")
        rec = {"kind": kind, "t_s": round(time.perf_counter() - self.t_start,
                                          4)}
        if backend:
            rec["backend"] = backend
        if set_index is not None:
            rec["set"] = set_index
        if detail:
            rec["detail"] = detail
        if action:
            rec["action"] = action
        if extra:
            for k, v in extra.items():
                if v is not None and k not in rec:
                    rec[k] = v
        with _metrics._MUT:
            if len(self.faults) >= FAULTS_CAP:
                self.faults_dropped += 1
            else:
                self.faults.append(rec)

    def mark_degraded(self, backend: str, to: str, reason: str,
                      failures: int) -> None:
        """A circuit-breaker open: `backend` serves as `to` until the
        breaker recloses (resilience/breaker.py is the single caller)."""
        with _metrics._MUT:
            self.degraded[backend] = {"to": to, "reason": reason,
                                      "failures": failures}

    def mark_reclosed(self, backend: str) -> None:
        """A half-open probe succeeded: the backend leaves the `degraded`
        block, which reports the breakers open now (the history is in the
        breaker.* counters)."""
        with _metrics._MUT:
            self.degraded.pop(backend, None)

    # ----------------------------------------------------------- rendering
    def _faults_block(self) -> Optional[dict]:
        if not self.faults and not self.faults_dropped:
            return None
        kinds: Dict[str, int] = {}
        for rec in self.faults:
            kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
        return {
            "count": len(self.faults) + self.faults_dropped,
            "dropped": self.faults_dropped,
            "kinds": dict(sorted(kinds.items())),
            "records": self.faults,
        }

    def _reads_block(self) -> Optional[dict]:
        """Tail-latency aggregation of the per-read stream (schema v4):
        `count`, `wall_ms` percentiles, `backends`/`fallbacks` cover every
        read via the streaming sketch + O(1) dicts; the qlen/band
        attribution tables come from the raw records (READS_CAP-bounded,
        `records_kept`/`dropped`)."""
        sk = self.wall_sketch
        if sk.count == 0:
            return None
        n = sk.count
        qlens = [r[1] for r in self.reads]
        bands = [r[2] for r in self.reads]
        nk = len(self.reads)

        def ms(x):
            return round(x * 1e3, 4) if x is not None else None

        return {
            "count": n,
            "records_kept": nk,
            "dropped": self.reads_dropped,
            "amortized": self.reads_amortized,
            "backends": dict(sorted(self.read_backends.items())),
            "fallbacks": dict(sorted(self.read_fallbacks.items())),
            "wall_ms": {
                "p50": ms(sk.quantile(0.50)),
                "p95": ms(sk.quantile(0.95)),
                "p99": ms(sk.quantile(0.99)),
                "mean": ms(sk.sum / n),
                "max": ms(sk.max),
            },
            # sketch provenance: a reader can tell these percentiles carry
            # a declared tolerance instead of nearest-rank exactness
            "sketch": {"kind": "log-bucket",
                       "relative_error": sk.RELATIVE_ERROR},
            "qlen": {"min": min(qlens), "max": max(qlens),
                     "mean": round(sum(qlens) / nk, 1)} if nk else None,
            "band_cols": {"min": min(bands),
                          "max": max(bands)} if nk else None,
        }

    @staticmethod
    def _compiles_block() -> Optional[dict]:
        """The run's build and load log (compile_log.py): one record a load
        of the kernel library, a miss when nvcc had to build it, with the
        build's seconds (`nvcc_build_s`, where JAX puts `xla_compile_s`)."""
        recs = _clog.run_records()
        dropped = _clog.run_dropped()
        if not recs and not dropped:
            return None
        misses = sum(1 for r in recs if not r["cache_hit"])
        built = sum(r.get("nvcc_build_s") or 0.0 for r in recs)
        return {
            "count": len(recs) + dropped,
            "dropped": dropped,
            "misses": misses,
            "hits": len(recs) - misses,
            "nvcc_build_s": round(built, 6),
            "records": recs,
        }

    def as_dict(self) -> dict:
        from .mfu import mfu_block
        total = time.perf_counter() - self.t_start
        phases = {k: {"wall_s": round(v[0], 6), "calls": v[1]}
                  for k, v in sorted(self.phases.items())}
        values = {k: {"count": v[0], "sum": v[1], "min": v[2], "max": v[3]}
                  for k, v in sorted(self.values.items())}
        dev = _device_info(self.device)
        rep = {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "total_wall_s": round(total, 6),
            "phase_wall_sum_s": round(sum(v[0] for v in self.phases.values()),
                                      6),
            "phases": phases,
            "counters": dict(sorted(self.counters.items())),
            "values": values,
            "reads": self._reads_block(),
            "compiles": self._compiles_block(),
            "faults": self._faults_block(),
            "degraded": dict(sorted(self.degraded.items())) or None,
            "device": dev,
            "mfu": mfu_block(self, dev),
        }
        return rep


def exact_percentile(sorted_vals, q: float):
    """Nearest-rank percentile over an ascending list (no interpolation).
    The sketch-tolerance tests use this as the exact reference the
    LogSketch estimates are judged against."""
    if not sorted_vals:
        return None
    i = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def _device_info(dev=None) -> Optional[dict]:
    """The run's device, host-side only: the card's name where the run's
    torch device (`note_device`) is cuda, whose route has initialised CUDA
    already; `cpu` for a CPU run, which never initialises CUDA here; None
    before any route noted a device."""
    if dev is None:
        return None
    if dev.type != "cuda":
        return {"backend": "torch", "platform": "cpu", "kind": "cpu"}
    import torch
    return {"backend": "torch", "platform": "gpu",
            "kind": torch.cuda.get_device_name(dev)}


# --------------------------------------------------------------------------- #
# process-global registry                                                     #
# --------------------------------------------------------------------------- #

_REPORT = RunReport()


def _metrics_collector(reg) -> None:
    """Render-time gauges too cheap to bother pushing per event: the trace
    ring's drop count and the device identity + MFU peak (readable only
    once a route noted the run's device)."""
    reg.gauge("abpoa_trace_dropped_events",
              "Trace ring-buffer events overwritten before export").set(
        _trace.tracer().dropped)
    dev = _device_info(_REPORT.device)
    if dev:
        reg.gauge("abpoa_device_info",
                  "Accelerator identity (value is always 1)").set(
            1, platform=dev.get("platform", ""), kind=dev.get("kind", ""))
        from .mfu import peak_ops_for_kind
        peak = peak_ops_for_kind(dev.get("kind") or "")
        if peak:
            reg.gauge("abpoa_device_peak_ops_per_second",
                      "Peak int-op throughput of the attached device "
                      "(MFU denominator)").set(peak)


_metrics.register_global_collector(_metrics_collector)


def report() -> RunReport:
    return _REPORT


def note_device(dev) -> None:
    """Record the run's torch device (the routes call this where they
    start; the report's `device` block and the MFU peak read it)."""
    _REPORT.device = dev


def start_run() -> None:
    """Reset the global report; call at the top of each CLI/pyapi run."""
    _REPORT.reset()
    _metrics.publish_run_start()
    # run-scoped gauges must not outlive their run in the exposition
    _metrics.clear_batch_progress()
    # the resolved-backend label and the breaker's demotions are run-scoped
    # too (abpoa_tpu/obs/report.py:450-464)
    from ..align.dispatch import reset_resolved
    from ..resilience.breaker import breaker
    reset_resolved()
    breaker().reset()


def phase(name: str):
    return _REPORT.phase(name)


def count(name: str, n: int = 1) -> None:
    _REPORT.count(name, n)


def observe(name: str, value: float) -> None:
    _REPORT.observe(name, value)


def record_dp(rows: int, band_cols: int, gap_mode: int) -> None:
    _REPORT.record_dp(rows, band_cols, gap_mode)


def record_read(wall_s: float, qlen: int, band_cols: int, backend: str,
                fallback: Optional[str] = None,
                amortized: bool = False) -> None:
    _REPORT.record_read(wall_s, qlen, band_cols, backend, fallback, amortized)


def record_fault(kind: str, backend: Optional[str] = None,
                 set_index: Optional[int] = None, detail: str = "",
                 action: str = "", extra: Optional[dict] = None) -> None:
    _REPORT.record_fault(kind, backend, set_index, detail, action, extra)


def finalize_report() -> dict:
    """Render the global report to its versioned dict."""
    return _REPORT.as_dict()


def write_report(path: str, rep: Optional[dict] = None, fp=None) -> None:
    """`--report FILE` sink ('-' = stdout, or `fp` when the caller needs
    to keep stdout clean for sequence output)."""
    if rep is None:
        rep = finalize_report()
    text = json.dumps(rep, indent=1, sort_keys=False)
    if path == "-":
        (fp or sys.stdout).write(text + "\n")
    else:
        with open(path, "w") as out:
            out.write(text + "\n")


def summary(rep: dict) -> dict:
    """The compact embedding used by bench.py / microbench / chip_watcher:
    per-phase walls plus the throughput-normalization numbers, small enough
    to live inside a BENCH_* `extra` blob."""
    mfu = rep.get("mfu") or {}
    reads = rep.get("reads") or None
    return {
        "schema_version": rep["schema_version"],
        "phases": {k: v["wall_s"] for k, v in rep["phases"].items()},
        "dp_cells": rep["counters"].get("dp.cells", 0),
        "cell_updates_per_sec": mfu.get("cell_updates_per_sec"),
        "mfu": mfu.get("mfu"),
        # per-read tail latency (the item-1 service's SLO numbers)
        "read_wall_ms": ({q: reads["wall_ms"][q]
                          for q in ("p50", "p95", "p99")}
                         if reads else None),
    }


def render_report(rep: dict) -> str:
    """One-screen human rendering of a run report: phase table (sorted by
    wall, with share of total), throughput line, per-read percentiles,
    compile log totals, and the counter table. The reader for the JSON
    the `--report` flag emits — `abpoa-tpu report FILE` and
    tools/report_view.py both route here."""
    lines = []
    total = rep.get("total_wall_s") or 0.0
    ver = rep.get("schema_version")
    lines.append(f"run report (schema v{ver})  total {total:.3f}s")
    dev = rep.get("device")
    if dev:
        lines.append(f"device: {dev.get('platform', '?')} "
                     f"{dev.get('kind', '')} x{dev.get('count', 1)}".rstrip())

    phases = rep.get("phases") or {}
    if phases:
        lines.append("")
        lines.append(f"  {'phase':<16} {'wall_s':>9} {'share':>6} {'calls':>7}")
        covered = 0.0
        for name, ph in sorted(phases.items(),
                               key=lambda kv: -kv[1]["wall_s"]):
            w = ph["wall_s"]
            covered += w
            share = (100.0 * w / total) if total else 0.0
            lines.append(f"  {name:<16} {w:>9.4f} {share:>5.1f}% "
                         f"{ph['calls']:>7}")
        if total:
            lines.append(f"  {'(covered)':<16} {covered:>9.4f} "
                         f"{100.0 * covered / total:>5.1f}%")

    mfu = rep.get("mfu") or {}
    if mfu:
        cups = mfu.get("cell_updates_per_sec")
        bits = [f"dp cells {rep['counters'].get('dp.cells', 0):,}"]
        if cups:
            bits.append(f"{cups:,.0f} cell-updates/s")
        if mfu.get("mfu") is not None:
            bits.append(f"MFU {100.0 * mfu['mfu']:.3f}%")
        lines.append("")
        lines.append("throughput: " + "  ".join(bits))

    reads = rep.get("reads")
    if reads:
        wm = reads["wall_ms"]
        lines.append("")
        lines.append(f"reads: {reads['count']:,}"
                     + (f" (qlen/band tables over the first "
                        f"{reads.get('records_kept', 0):,} records)"
                        if reads.get("dropped") else "")
                     + (f", {reads['amortized']:,} amortized"
                        if reads.get("amortized") else ""))
        sk = reads.get("sketch")
        tol = (f" (sketch, ±{100 * sk['relative_error']:.0f}%)"
               if sk else "")
        lines.append(f"  wall ms  p50 {wm['p50']}  p95 {wm['p95']}  "
                     f"p99 {wm['p99']}  max {wm['max']}{tol}")
        if reads.get("backends"):
            lines.append("  backends: " + "  ".join(
                f"{k}={v}" for k, v in reads["backends"].items()))
        if reads.get("fallbacks"):
            lines.append("  fallbacks: " + "  ".join(
                f"{k}={v}" for k, v in reads["fallbacks"].items()))

    comp = rep.get("compiles")
    if comp:
        lines.append("")
        lines.append(f"compiles: {comp['misses']} compiled / "
                     f"{comp['hits']} cache hits"
                     + (f", {comp['xla_compile_s']:.3f}s in XLA"
                        if comp.get("xla_compile_s") else "")
                     + (f", {comp['nvcc_build_s']:.3f}s in nvcc"
                        if comp.get("nvcc_build_s") else ""))

    # v3: fault history + active demotions — the operator's view of what
    # the degradation ladder absorbed (resilience/), without raw JSON
    faults = rep.get("faults")
    if faults:
        lines.append("")
        lines.append(f"faults: {faults['count']:,}"
                     + (f" (+{faults['dropped']:,} dropped)"
                        if faults.get("dropped") else "")
                     + "  " + "  ".join(f"{k}={v}" for k, v in
                                        faults["kinds"].items()))
        for rec in faults["records"][:20]:
            where = (f" set {rec['set']}" if "set" in rec
                     else (f" [{rec['backend']}]" if "backend" in rec
                           else ""))
            act = f" -> {rec['action']}" if rec.get("action") else ""
            det = f": {rec['detail']}" if rec.get("detail") else ""
            lines.append(f"  t+{rec['t_s']:.2f}s {rec['kind']}{where}"
                         f"{act}{det}")
        if len(faults["records"]) > 20:
            lines.append(f"  ... {len(faults['records']) - 20} more "
                         "(see the JSON report)")
    degraded = rep.get("degraded")
    if degraded:
        lines.append("")
        lines.append("degraded (circuit breakers open at end of run):")
        for backend, d in degraded.items():
            lines.append(f"  {backend} -> {d['to']}  after {d['failures']} "
                         f"failures (last: {d['reason']})")
    quarantined = ((rep.get("counters") or {}).get("quarantine.sets")
                   or (faults or {}).get("kinds", {}).get("poisoned_set"))
    if quarantined:
        lines.append("")
        lines.append(f"quarantined sets: {quarantined} "
                     "(see faults records with a set index)")

    counters = rep.get("counters") or {}
    if counters:
        lines.append("")
        lines.append("counters:")
        for name, v in sorted(counters.items()):
            lines.append(f"  {name:<28} {v:,}")
    return "\n".join(lines) + "\n"


def _diff_rows(rep: dict) -> dict:
    """The comparable scalar slice of a run report (either schema
    direction: v2+ reports all carry these or render as n/a)."""
    reads = rep.get("reads") or {}
    wall_ms = reads.get("wall_ms") or {}
    comp = rep.get("compiles") or {}
    mfu = rep.get("mfu") or {}
    counters = rep.get("counters") or {}
    total = rep.get("total_wall_s") or 0.0
    n_reads = reads.get("count") or 0
    rows = {"total_wall_s": total,
            "reads": n_reads,
            "reads_per_sec": (n_reads / total) if total and n_reads
            else None,
            "read_p50_ms": wall_ms.get("p50"),
            "read_p99_ms": wall_ms.get("p99"),
            "cell_updates_per_sec": mfu.get("cell_updates_per_sec"),
            "dp_cells": counters.get("dp.cells"),
            "compile_misses": comp.get("misses"),
            "compile_hits": comp.get("hits"),
            "faults": (rep.get("faults") or {}).get("count", 0),
            "quarantined_sets": counters.get("quarantine.sets", 0)}
    for name, ph in sorted((rep.get("phases") or {}).items()):
        rows[f"phase.{name}_s"] = ph.get("wall_s")
    return rows


# fields where bigger is better (delta coloring of the diff): everything
# else is a cost
_DIFF_HIGHER_BETTER = {"reads_per_sec", "cell_updates_per_sec",
                       "compile_hits"}


def render_report_diff(rep_a: dict, rep_b: dict,
                       label_a: str = "A", label_b: str = "B") -> str:
    """`abpoa-tpu report --diff A B`: side-by-side per-field comparison
    of two run reports (phase walls, reads/s, CUPS, compiles, faults)
    with absolute delta and percent change — the manual perf-triage loop
    without eyeballing two JSON blobs."""
    rows_a, rows_b = _diff_rows(rep_a), _diff_rows(rep_b)
    names = list(rows_a)
    names.extend(k for k in rows_b if k not in rows_a)
    la = (os.path.basename(label_a) or label_a)[:16]
    lb = (os.path.basename(label_b) or label_b)[:16]
    lines = [f"report diff: A={label_a} (schema "
             f"v{rep_a.get('schema_version')})  B={label_b} (schema "
             f"v{rep_b.get('schema_version')})",
             f"  {'field':<22} {la:>14} {lb:>14} {'delta':>12} "
             f"{'change':>8}"]

    def fmt(v):
        if v is None:
            return "n/a"
        if isinstance(v, float):
            return f"{v:,.4g}" if abs(v) < 1e6 else f"{v:,.0f}"
        return f"{v:,}"

    for name in names:
        va, vb = rows_a.get(name), rows_b.get(name)
        if va is None and vb is None:
            continue
        if va is None or vb is None:
            delta = pct = mark = ""
        else:
            d = vb - va
            delta = f"{d:+,.4g}" if isinstance(d, float) else f"{d:+,}"
            pct = f"{100.0 * d / va:+.1f}%" if va else ""
            better = (d > 0) == (name in _DIFF_HIGHER_BETTER)
            mark = "" if d == 0 else ("  +" if better else "  -")
        lines.append(f"  {name:<22} {fmt(va):>14} {fmt(vb):>14} "
                     f"{delta:>12} {pct:>8}{mark}")
    return "\n".join(lines) + "\n"
