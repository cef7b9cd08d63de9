"""Metric registry: typed metrics + Prometheus exposition.

Counterpart of `abpoa_tpu/obs/metrics.py`, copied with its family names
(`abpoa_reads_total`, ...), help texts and exposition format, so a
scraper and `top` read one feed from either package. The default
textfile path is the port's own, under `~/.cache/abpoa_tpu_torch/`. The
server's families are here; the pool's come with the pool.

Everything the RunReport (report.py) knows dies with the run; this module
holds process-cumulative counters, gauges and streaming-quantile
histograms, rendered in the Prometheus text exposition format, either as
a textfile exporter (`--metrics FILE`, atomic rename,
node_exporter-compatible) or over a stdlib-only HTTP endpoint
(`--metrics-port N`).

Three metric types:

- Counter: monotonic totals, labeled (`abpoa_reads_total{backend="cuda"}`).
- Gauge: last-written values (`abpoa_round_lanes`).
- Histogram: a bounded log-bucket sketch (`LogSketch`): fixed geometric
  buckets over [LO, HI), so p50/p95/p99 over millions of observations
  cost O(1) memory and stay within a declared relative error
  (`LogSketch.RELATIVE_ERROR`). Sketches merge bucket-wise.

Publication: obs/report.py mirrors its hooks here (counter names ->
labeled Prometheus families via `publish_counter`, phase exits via
`publish_phase`, per-read records via `publish_read`); the drivers
publish their round, mesh and route gauges directly. Every publication is
a host-side dict or array update: no device sync.

Rates (reads/s, cell-updates/s, MFU) are computed at render time from
counter deltas between consecutive renders, so a periodic exporter
(`start_textfile_exporter`) yields live gauges `top` can poll.
"""
from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

NAMESPACE = "abpoa"

# serializes the mutate paths (Counter.inc / Gauge.set / sketch.observe):
# read-modify-write under the GIL can interleave between threads. One
# process-wide RLock (an uncontended acquire is ~100 ns); render paths
# snapshot under the GIL and never hold this lock.
_MUT = threading.RLock()


# --------------------------------------------------------------------------- #
# streaming-quantile sketch                                                   #
# --------------------------------------------------------------------------- #

class LogSketch:
    """Fixed-bucket log histogram over (LO, HI): a bounded, mergeable
    quantile sketch.

    Bucket i covers [LO*G^i, LO*G^(i+1)); a quantile query walks the
    cumulative counts and answers the geometric midpoint of the target
    bucket, clamped to the exact observed [min, max]. Worst-case relative
    error is sqrt(G)-1 (~2.5% at G=1.05) for in-range values — declared
    as RELATIVE_ERROR with margin. Out-of-range values clamp into the
    edge buckets but min/max stay exact, so the clamp keeps even those
    honest at the distribution edges.
    """

    LO = 1e-6          # 1 microsecond
    HI = 1e4           # ~2.8 hours
    GROWTH = 1.05
    N_BUCKETS = int(math.ceil(math.log(HI / LO) / math.log(GROWTH)))  # ~472
    RELATIVE_ERROR = 0.05

    __slots__ = ("counts", "count", "sum", "min", "max")

    _LOG_G = math.log(GROWTH)
    _LOG_LO = math.log(LO)

    def __init__(self) -> None:
        self.counts = [0] * self.N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        with _MUT:
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.count += 1
            self.sum += v
            if v <= self.LO:
                i = 0
            else:
                i = int((math.log(v) - self._LOG_LO) / self._LOG_G)
                if i >= self.N_BUCKETS:
                    i = self.N_BUCKETS - 1
            self.counts[i] += 1

    def merge(self, other: "LogSketch") -> None:
        """Bucket-wise merge (cross-run / cross-shard aggregation)."""
        with _MUT:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate within RELATIVE_ERROR."""
        if self.count == 0:
            return None
        rank = max(1, min(self.count, math.ceil(q * self.count)))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                mid = self.LO * self.GROWTH ** (i + 0.5)
                return min(self.max, max(self.min, mid))
        return self.max

    def bucket_upper_bounds(self):
        """(upper_bound_seconds, cumulative_count) for every non-empty
        bucket — the Prometheus histogram series (cumulative `le`).
        Snapshots the bucket array first so a concurrent observe() from
        the run thread cannot produce a non-cumulative series."""
        out = []
        acc = 0
        for i, c in enumerate(list(self.counts)):
            if c:
                acc += c
                out.append((self.LO * self.GROWTH ** (i + 1), acc))
        return out


# --------------------------------------------------------------------------- #
# metric families                                                             #
# --------------------------------------------------------------------------- #

def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    esc = lambda v: str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")  # noqa: E731
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in labels) + "}"


class Counter:
    TYPE = "counter"

    __slots__ = ("name", "help", "values")

    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self.values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with _MUT:
            self.values[key] = self.values.get(key, 0) + n

    def value(self, **labels) -> float:
        return self.values.get(tuple(sorted(labels.items())), 0)

    def total(self) -> float:
        # atomic snapshot first: summing the live view from the exporter
        # thread would raise if the run thread inserts a key mid-sum
        return sum(list(self.values.values()))

    def render(self, out: List[str]) -> None:
        # list() snapshots atomically under the GIL: the exporter thread
        # renders while the run thread inserts new label keys, and keys
        # are never deleted, so a snapshot of items is always consistent
        for key, v in sorted(list(self.values.items())):
            out.append(f"{self.name}{_fmt_labels(key)} {_num(v)}")


class Gauge(Counter):
    TYPE = "gauge"
    __slots__ = ()

    def set(self, v: float, **labels) -> None:
        with _MUT:
            self.values[tuple(sorted(labels.items()))] = v


class Histogram:
    """One LogSketch, exposed in the Prometheus histogram format
    (cumulative `le` buckets + `_sum` + `_count`)."""

    TYPE = "histogram"

    __slots__ = ("name", "help", "sketch")

    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self.sketch = LogSketch()

    def observe(self, v: float) -> None:
        self.sketch.observe(v)

    def quantile(self, q: float) -> Optional[float]:
        return self.sketch.quantile(q)

    def render(self, out: List[str]) -> None:
        # +Inf and _count derive from the same bucket snapshot the `le`
        # series used: a frame rendered mid-observe stays self-consistent
        # (the lint checks exactly that), at worst one observation stale
        buckets = self.sketch.bucket_upper_bounds()
        total = buckets[-1][1] if buckets else 0
        for ub, acc in buckets:
            out.append(f'{self.name}_bucket{{le="{ub:.9g}"}} {acc}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {_num(self.sketch.sum)}")
        out.append(f"{self.name}_count {total}")


def _num(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


# --------------------------------------------------------------------------- #
# registry                                                                    #
# --------------------------------------------------------------------------- #

class MetricsRegistry:
    """Process-global family store + exposition renderer.

    `collectors` are callbacks run at render time (device identity,
    trace-drop gauges: values that are cheap to read but wasteful to
    push on every event). Rate gauges (reads/s, CUPS, MFU) are derived
    from counter deltas between consecutive renders.
    """

    def __init__(self) -> None:
        self._families: Dict[str, object] = {}
        self._order: List[str] = []
        self.collectors: List[Callable[["MetricsRegistry"], None]] = []
        self._lock = threading.Lock()
        # rate-gauge origin: first render averages over registry lifetime,
        # later renders over the inter-render interval (live rates)
        self._prev_rates: Tuple[float, float, float, float, float] = (
            time.perf_counter(), 0.0, 0.0, 0.0, 0.0)
        self.created = time.time()

    # ------------------------------------------------------------- families
    def _family(self, cls, name: str, help_: str):
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = cls(name, help_)
                    self._families[name] = fam
                    self._order.append(name)
        return fam

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._family(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._family(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._family(Histogram, name, help_)

    def get(self, name: str):
        return self._families.get(name)

    def register_collector(self, fn: Callable) -> None:
        if fn not in self.collectors:
            self.collectors.append(fn)

    # ------------------------------------------------------------- rendering
    def _update_rate_gauges(self) -> None:
        """reads/s, cell-updates/s and MFU from counter deltas between
        consecutive renders — live gauges for a polling exporter, whole-
        process averages on a one-shot render."""
        now = time.perf_counter()
        reads = _fam_total(self, "abpoa_reads_total")
        cells = _fam_total(self, "abpoa_dp_cells_total")
        ops = _fam_total(self, "abpoa_dp_cell_ops_total")
        map_reads = _fam_total(self, "abpoa_map_reads_total")
        prev = self._prev_rates
        self._prev_rates = (now, reads, cells, ops, map_reads)
        dt = now - prev[0]
        if dt <= 0:
            return
        g = self.gauge("abpoa_reads_per_second",
                       "Read throughput over the last exporter interval")
        g.set(round((reads - prev[1]) / dt, 3))
        if map_reads > 0:
            g = self.gauge("abpoa_map_reads_per_second",
                           "Map-workload read throughput over the last "
                           "exporter interval")
            prev_map = prev[4] if len(prev) > 4 else 0.0
            g.set(round((map_reads - prev_map) / dt, 3))
        g = self.gauge("abpoa_cell_updates_per_second",
                       "DP cell-updates/s over the last exporter interval "
                       "(the AnySeq/GPU throughput metric)")
        g.set(round((cells - prev[2]) / dt, 1))
        peak = _fam_total(self, "abpoa_device_peak_ops_per_second")
        if peak > 0:
            g = self.gauge("abpoa_mfu_ratio",
                           "Model FLOPs utilization estimate over the last "
                           "exporter interval (DP int-ops vs device peak)")
            g.set(round((ops - prev[3]) / dt / peak, 6))

    def _update_quantile_gauges(self) -> None:
        for base, help_ in (
                ("abpoa_read_wall_seconds",
                 "Sketch-estimated per-read wall quantiles "
                 "(textfile-exporter convenience for `top`)"),
                ("abpoa_serve_request_seconds",
                 "Sketch-estimated request-latency quantiles "
                 "(textfile-exporter convenience for `top`)")):
            h = self._families.get(base)
            if h is None or h.sketch.count == 0:
                continue
            g = self.gauge(base + "_quantile", help_)
            for q, label in ((0.5, "0.5"), (0.95, "0.95"), (0.99, "0.99")):
                g.set(round(h.quantile(q), 9), quantile=label)

    def render(self) -> str:
        """The Prometheus text exposition (format version 0.0.4)."""
        for fn in list(_GLOBAL_COLLECTORS) + list(self.collectors):
            try:
                fn(self)
            except Exception:
                pass
        self._update_rate_gauges()
        self._update_quantile_gauges()
        out: List[str] = []
        with self._lock:
            names = list(self._order)
        for name in names:
            fam = self._families[name]
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.TYPE}")
            fam.render(out)
        return "\n".join(out) + "\n"


def _fam_total(reg: MetricsRegistry, name: str) -> float:
    fam = reg.get(name)
    return fam.total() if isinstance(fam, Counter) else 0.0


_REGISTRY = MetricsRegistry()

# collectors that survive reset_registry() (module-lifetime publishers:
# obs/report.py's device/trace gauges)
_GLOBAL_COLLECTORS: List[Callable] = []


def register_global_collector(fn: Callable) -> None:
    if fn not in _GLOBAL_COLLECTORS:
        _GLOBAL_COLLECTORS.append(fn)


def registry() -> MetricsRegistry:
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Fresh registry (tests)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY


# --------------------------------------------------------------------------- #
# publication hooks (called from obs/report.py and the drivers)                #
# --------------------------------------------------------------------------- #

# RunReport counter name -> (family, help, label name). The run report
# keeps the full dotted namespace; the registry keeps the curated
# families. A prefix absent here stays report-only by design.
_PREFIX_FAMILIES = {
    "dispatch": ("abpoa_dispatches_total",
                 "DP kernel dispatches by backend", "backend"),
    "fallback": ("abpoa_fallbacks_total",
                 "Degraded-path falls by reason", "reason"),
    "faults": ("abpoa_faults_total",
               "Absorbed dispatch/input faults by kind", "kind"),
    "inject": ("abpoa_injected_faults_total",
               "Fault-injector firings by kind", "kind"),
}

# scheduler decisions carry TWO labels — the route kind plus the
# categorical decision code (`scheduler.<kind>.<code>` report counters),
# so crossover-serial is distinguishable from explicit/ineligible-serial
# in the ledger's route mix
_SCHED_FAMILY = ("abpoa_scheduler_routes_total",
                 "Batch/serve dispatch route decisions by route and "
                 "decision reason")

_EXACT_FAMILIES = {
    "compile.hits": ("abpoa_compile_hits_total",
                     "Jit dispatches served from a compile cache"),
    "compile.misses": ("abpoa_compile_misses_total",
                       "Jit dispatches that compiled (XLA or persistent-"
                       "cache load)"),
    "quarantine.sets": ("abpoa_quarantined_sets_total",
                        "Read sets quarantined at the -l/batch boundary"),
    "watchdog.timeouts": ("abpoa_watchdog_fires_total",
                          "Dispatch watchdog deadline expiries"),
    "admission.demote": ("abpoa_admission_demotions_total",
                         "Memory-admission demotions to the host kernel"),
    "admission.chunk": ("abpoa_admission_chunks_total",
                        "Memory-admission lockstep group splits"),
    "breaker.short_circuit": ("abpoa_breaker_short_circuits_total",
                              "Dispatches short-circuited by an open "
                              "circuit breaker"),
    "lockstep.groups": ("abpoa_lockstep_groups_total",
                        "Lockstep multi-set device dispatch groups"),
    "lockstep.chunks": ("abpoa_lockstep_chunks_total",
                        "Lockstep dispatch rounds/chunks (all-device "
                        "chunks, or split-driver DP rounds)"),
    "lockstep.drain_chunks": ("abpoa_lockstep_drain_chunks_total",
                              "Lockstep rounds entered with at least one "
                              "set already finished (divergence drain)"),
    "lockstep.joins": ("abpoa_lockstep_joins_total",
                       "Requests that joined an in-flight lockstep group "
                       "at a round boundary (continuous batching)"),
    "lockstep.early_retires": ("abpoa_lockstep_early_retires_total",
                               "Lanes retired from an in-flight lockstep "
                               "group before the group ended (result "
                               "returned early, slot freed for joiners)"),
    "lockstep.evictions": ("abpoa_lockstep_evictions_total",
                           "Lanes evicted from an in-flight lockstep group "
                           "at a round boundary (deadline expired)"),
    "dp.dispatches": ("abpoa_dp_dispatches_total", "DP kernel dispatches"),
    "dp.cells": ("abpoa_dp_cells_total", "DP cells computed"),
    "dp.cell_ops": ("abpoa_dp_cell_ops_total",
                    "Estimated integer ops over DP cells (MFU numerator)"),
    # the server's per-request traces (serve --trace-dir)
    "serve.traces": ("abpoa_serve_traces_total",
                     "Per-request Chrome traces written to --trace-dir"),
    # fixed-graph map workload (parallel/map_driver.py)
    "map.reads": ("abpoa_map_reads_total",
                  "Reads mapped against a static graph (map workload)"),
    "map.rounds": ("abpoa_map_rounds_total",
                   "Map-driver dispatch rounds (one vmapped DP chunk per "
                   "round, zero fusion barrier)"),
    "map.joins": ("abpoa_map_joins_total",
                  "Reads that boarded a map round via the streaming hook "
                  "(continuous batching at DP-round granularity)"),
}


_BREAKER_PREFIXES = {
    "breaker.failures": ("abpoa_breaker_failures_total",
                         "Classified dispatch failures by backend"),
    "breaker.open": ("abpoa_breaker_opens_total",
                     "Circuit-breaker open events by backend"),
    "breaker.half_open": ("abpoa_breaker_half_open_probes_total",
                          "Cooldown-expiry half-open probe dispatches by "
                          "backend"),
    "breaker.reclose": ("abpoa_breaker_recloses_total",
                        "Circuit-breaker reclose events (successful "
                        "half-open probes) by backend"),
    "breaker.probe_fail": ("abpoa_breaker_probe_failures_total",
                           "Half-open probes that failed and reopened "
                           "the breaker, by backend"),
}


def publish_counter(name: str, n: int) -> None:
    """Mirror one RunReport counter increment into the registry."""
    exact = _EXACT_FAMILIES.get(name)
    if exact is not None:
        _REGISTRY.counter(*exact).inc(n)
        return
    head, _, rest = name.partition(".")
    if head == "scheduler":
        kind, _, code = rest.partition(".")
        _REGISTRY.counter(*_SCHED_FAMILY).inc(
            n, route=kind, reason=code or "unspecified")
        return
    fam = _PREFIX_FAMILIES.get(head)
    if fam is not None:
        _REGISTRY.counter(fam[0], fam[1]).inc(n, **{fam[2]: rest})
        return
    for pref, (fname, fhelp) in _BREAKER_PREFIXES.items():
        if name.startswith(pref + "."):
            _REGISTRY.counter(fname, fhelp).inc(
                n, backend=name[len(pref) + 1:])
            return


def publish_phase(name: str, wall_s: float) -> None:
    _REGISTRY.counter(
        "abpoa_phase_wall_seconds_total",
        "Wall seconds by pipeline phase").inc(wall_s, phase=name)


# the per-read families (first creation wins: one definition site keeps
# the exposition text independent of which publisher ran first)
_READS_FAMILY = ("abpoa_reads_total",
                 "Reads aligned, by the backend that ran them")
_READ_FALLBACKS_FAMILY = ("abpoa_read_fallbacks_total",
                          "Reads that ran on a fallback path, by reason")
_READ_WALL_FAMILY = ("abpoa_read_wall_seconds",
                     "Per-read wall seconds (log-bucket sketch, "
                     f"~{int(LogSketch.RELATIVE_ERROR * 100)}% quantile "
                     "tolerance)")


def publish_read(wall_s: float, backend: str,
                 fallback: Optional[str]) -> None:
    _REGISTRY.counter(*_READS_FAMILY).inc(1, backend=backend)
    if fallback:
        _REGISTRY.counter(*_READ_FALLBACKS_FAMILY).inc(1, reason=fallback)
    _REGISTRY.histogram(*_READ_WALL_FAMILY).observe(wall_s)


def publish_run_start() -> None:
    _REGISTRY.counter("abpoa_runs_total", "Runs started").inc(1)


def set_breaker_state(backend: str, open_: bool) -> None:
    _REGISTRY.gauge(
        "abpoa_breaker_open",
        "Circuit-breaker state by backend (1 = open/demoted)").set(
        1 if open_ else 0, backend=backend)


_ROUTE_KINDS = ("serial", "pool", "lockstep", "hybrid", "map", "sharded")


def publish_map_round(reads: int, occ: float) -> None:
    """One map-driver round: reads dispatched this round and the round's
    lane occupancy (lanes over the K cap — every round boundary is a
    join/retire point, so this gauge IS the map stream's fullness)."""
    _REGISTRY.gauge(
        "abpoa_map_lane_occupancy",
        "Lane occupancy of the last map-driver round (dispatched lanes "
        "over the group's K cap)").set(occ)
    _REGISTRY.gauge(
        "abpoa_map_round_reads",
        "Reads dispatched in the last map-driver round").set(reads)


def publish_mesh(n: int, platform: str) -> None:
    """Mesh inventory of the sharded route: device count and platform of
    the mesh the last sharded chunk spanned."""
    _REGISTRY.gauge(
        "abpoa_mesh_devices",
        "Devices in the sharded route's lane mesh").set(n)
    _REGISTRY.gauge(
        "abpoa_mesh_platform_info",
        "Mesh platform marker (1 = the labelled platform backs the "
        "mesh)").set(1, platform=platform)


def publish_shard_occupancy(shard_i: int, occ: float) -> None:
    """Per-slot lane occupancy of the last sharded round: live lanes over
    the slot's K/mesh slice. The slices are contiguous and balanced, so a
    slot reads < 1.0 only where K does not divide evenly."""
    _REGISTRY.gauge(
        "abpoa_shard_lane_occupancy",
        "Lane occupancy per mesh shard in the last sharded round "
        "(live lanes over the per-shard slice)").set(
        occ, shard=str(shard_i))


def publish_round(route: str, wall_s: float, lanes: int,
                  k_cap: int) -> None:
    """One driver round sealed (obs/rounds.py): the round-wall histogram
    plus the last round's lane gauge for `top`."""
    _REGISTRY.histogram(
        "abpoa_round_wall_seconds",
        "Wall seconds per lockstep/sharded/map driver round (log-bucket "
        "sketch)").observe(wall_s)
    _REGISTRY.gauge(
        "abpoa_round_lanes",
        "Live lanes in the last driver round").set(lanes)


def publish_shard_skew(ratio: float, straggler: int,
                       walls: Dict[int, float]) -> None:
    """Last sharded round's skew verdict (obs/rounds.py): max/min
    live-slot ratio, the straggler slot (the fullest, whose estimated
    wall is the measured one), and per-slot wall estimates."""
    _REGISTRY.gauge(
        "abpoa_shard_skew_ratio",
        "Max/min live-lane ratio across mesh shards in the last sharded "
        "round (1.0 = perfectly level)").set(round(ratio, 6))
    _REGISTRY.gauge(
        "abpoa_shard_straggler",
        "Shard id that gated the last sharded round (max live "
        "lanes)").set(straggler)
    g = _REGISTRY.gauge(
        "abpoa_shard_round_wall_seconds",
        "Estimated per-shard wall of the last sharded round (dispatch "
        "wall attributed by live lanes; the straggler's estimate is the "
        "measured wall)")
    for i, w in walls.items():
        g.set(round(w, 9), shard=str(i))


def publish_noop_fraction(ewma: float) -> None:
    """The lockstep idle-lane EWMA (the server's K-cap input)."""
    _REGISTRY.gauge(
        "abpoa_lockstep_noop_fraction",
        "EWMA of the lockstep idle-lane fraction (divergence; feeds "
        "the scheduler's sub-batch K cap)").set(ewma)


def publish_lane_occupancy(ewma: float) -> None:
    """The measured lane occupancy EWMA (live lanes over the group's
    capacity, a sample a split-driver or map round)."""
    _REGISTRY.gauge(
        "abpoa_lockstep_lane_occupancy",
        "EWMA of measured lockstep lane occupancy (live lanes over "
        "group capacity, per round)").set(ewma)


def publish_join_wait(wait_s: float) -> None:
    """Arrival to boarding of one request that joined an in-flight group
    at a round boundary."""
    _REGISTRY.histogram(
        "abpoa_lockstep_join_wait_seconds",
        "Wait from request arrival to joining an in-flight lockstep "
        "group (continuous batching)").observe(wait_s)


def publish_route(route) -> None:
    """Scheduler decision gauges for `top`: the last planned route (one-hot
    over route kinds) and its lockstep K cap."""
    for kind in _ROUTE_KINDS:
        _REGISTRY.gauge(
            "abpoa_scheduler_route",
            "Last planned batch/serve route (1 = selected)").set(
            1 if route.kind == kind else 0, route=kind)
    _REGISTRY.gauge(
        "abpoa_scheduler_k_cap",
        "Lockstep sub-batch K cap of the last planned route").set(
        route.k_cap)


def publish_batch_progress(done: int, total: Optional[int] = None) -> None:
    """Live -l/msa_batch progress for the `top` dashboard: sets completed
    vs total in the current batch run (a quarantined set counts as
    completed: the batch moved past it)."""
    _REGISTRY.gauge(
        "abpoa_batch_sets_done",
        "Read sets completed in the current -l/batch run").set(done)
    if total is not None:
        _REGISTRY.gauge(
            "abpoa_batch_sets",
            "Read sets in the current -l/batch run").set(total)


def bump_batch_set_done() -> None:
    """Count one more set as completed in the current batch run. A set
    is done once it has a final disposition — a result OR a quarantine:
    the batch moved past it either way. The count lives in the gauge
    itself, so every caller shares one definition of 'done'."""
    g = _REGISTRY.gauge(
        "abpoa_batch_sets_done",
        "Read sets completed in the current -l/batch run")
    with _MUT:  # read-modify-write spans two calls (RLock re-enters)
        g.set(g.value() + 1)


def publish_read_aggregate(backends: Dict[str, int],
                           fallbacks: Dict[str, int],
                           sketch: LogSketch) -> None:
    """Many reads' records at once (a worker's delta): the backend and
    fallback counts and a merge of their latency sketch, the exposition
    per-read publishes would give."""
    for b, n in backends.items():
        if n > 0:
            _REGISTRY.counter(*_READS_FAMILY).inc(n, backend=b)
    for r, n in fallbacks.items():
        if n > 0:
            _REGISTRY.counter(*_READ_FALLBACKS_FAMILY).inc(n, reason=r)
    if sketch.count:
        _REGISTRY.histogram(*_READ_WALL_FAMILY).sketch.merge(sketch)


# ------------------------------------------------------------- serve hooks

def publish_serve_request(status: str, wall_s: float) -> None:
    """One request's terminal status (ok | rejected | poisoned | oversized
    | timeout | draining | error) and its whole wall, queue included."""
    _REGISTRY.counter(
        "abpoa_serve_requests_total",
        "Serve requests by terminal status").inc(1, status=status)
    _REGISTRY.histogram(
        "abpoa_serve_request_seconds",
        "End-to-end request latency (log-bucket sketch, "
        f"~{int(LogSketch.RELATIVE_ERROR * 100)}% quantile tolerance)"
    ).observe(wall_s)


def publish_serve_admitted() -> None:
    _REGISTRY.counter("abpoa_serve_admitted_total",
                      "Requests admitted into the serve queue").inc(1)


def publish_serve_state(queue_depth: int, inflight: int) -> None:
    """The queue-depth and in-flight gauges, at each admission and
    completion."""
    _REGISTRY.gauge("abpoa_serve_queue_depth",
                    "Requests waiting in the serve admission queue").set(
        queue_depth)
    _REGISTRY.gauge("abpoa_serve_inflight",
                    "Requests currently executing in serve workers").set(
        inflight)


def clear_batch_progress() -> None:
    """Zero the batch gauges at run start so a later non-batch run does
    not keep exporting the previous batch's progress. Only touches
    families a batch run already materialized — a process that never ran
    a batch never exports them at all."""
    for name in ("abpoa_batch_sets", "abpoa_batch_sets_done"):
        fam = _REGISTRY.get(name)
        if fam is not None:
            fam.set(0)


# --------------------------------------------------------------------------- #
# textfile exporter (atomic) + background flusher                             #
# --------------------------------------------------------------------------- #

def default_textfile_path() -> str:
    """Where `--metrics` (no argument) writes and `abpoa-tpu top` (no
    argument) reads: one well-known handoff point per user."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "abpoa_tpu_torch", "metrics.prom")


def write_textfile(path: str) -> None:
    """One atomic exposition write (tmp + rename): a scraper or the `top`
    dashboard never reads a torn file."""
    text = _REGISTRY.render()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fp:
        fp.write(text)
    os.replace(tmp, path)


class _Flusher(threading.Thread):
    def __init__(self, path: str, interval_s: float) -> None:
        super().__init__(daemon=True, name="abpoa-metrics-flusher")
        self.path = path
        self.interval_s = interval_s
        # NOT `_stop`: Thread.join() calls a private `_stop()` internally
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                write_textfile(self.path)
            except Exception:
                # a transient render/IO failure must not kill the
                # exporter for the rest of the run — the next interval
                # writes a fresh frame
                pass

    def stop(self) -> None:
        self._stop_event.set()


_FLUSHER: Optional[_Flusher] = None


def start_textfile_exporter(path: str, interval_s: float = 1.0) -> None:
    """Periodic atomic exposition writes to `path` (`--metrics FILE`): the
    live feed `top` renders while a run executes. Host-side rendering
    only: the flusher reads counters the routes already maintain, it never
    touches the device."""
    global _FLUSHER
    stop_textfile_exporter()
    write_textfile(path)  # immediate first frame
    _FLUSHER = _Flusher(path, interval_s)
    _FLUSHER.start()


def stop_textfile_exporter(final_write: bool = True) -> None:
    global _FLUSHER
    if _FLUSHER is not None:
        _FLUSHER.stop()
        # join before the final write: both threads use the same tmp
        # path, so an in-flight flusher write racing the final one could
        # rename a torn frame into place
        _FLUSHER.join(timeout=10.0)
        if final_write:
            try:
                write_textfile(_FLUSHER.path)
            except OSError:
                pass
        _FLUSHER = None


# --------------------------------------------------------------------------- #
# stdlib HTTP endpoint                                                        #
# --------------------------------------------------------------------------- #

def start_http_exporter(port: int, host: str = "127.0.0.1"):
    """`/metrics` over stdlib http.server in a daemon thread
    (`--metrics-port N`). Returns the server (call .shutdown() to
    stop)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = _REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrape spam stays off stderr
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="abpoa-metrics-http").start()
    return srv


# --------------------------------------------------------------------------- #
# exposition parsing + linting (top dashboard, tests, CI smoke)               #
# --------------------------------------------------------------------------- #

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?P<labels>\{[^}]*\})?'
    r'\s+(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf|NaN))\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str):
    """-> (samples, types): samples maps (name, labels-frozenset) -> float,
    types maps family name -> declared TYPE. The reader `abpoa-tpu top`
    and the lint below share."""
    samples: Dict[Tuple[str, frozenset], float] = {}
    types: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: unparseable sample: {line!r}")
        labels = frozenset(_LABEL_RE.findall(m.group("labels") or ""))
        samples[(m.group("name"), labels)] = float(m.group("value"))
    return samples, types


def sample_value(samples, name: str, **labels) -> Optional[float]:
    return samples.get((name, frozenset((k, str(v))
                                        for k, v in labels.items())))


def lint_exposition(text: str) -> List[str]:
    """Structural lint of a Prometheus text exposition: every sample's
    family has a TYPE, counters end in _total, histograms carry a +Inf
    bucket with consistent _count, gauges/counters parse as numbers.
    Returns problems (empty = clean). CI's metrics-smoke gate."""
    problems: List[str] = []
    try:
        samples, types = parse_exposition(text)
    except ValueError as e:
        return [str(e)]
    hist_bases = {n for n, t in types.items() if t == "histogram"}
    for (name, labels), _v in samples.items():
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in hist_bases:
                base = name[:-len(suffix)]
        if base not in types:
            problems.append(f"{name}: sample without a # TYPE declaration")
        elif types[base] == "counter" and not name.endswith("_total"):
            problems.append(f"{name}: counter family without _total suffix")
    for base in hist_bases:
        inf = sample_value(samples, base + "_bucket", le="+Inf")
        cnt = samples.get((base + "_count", frozenset()))
        if inf is None:
            problems.append(f"{base}: histogram without a +Inf bucket")
        elif cnt is not None and inf != cnt:
            problems.append(f"{base}: +Inf bucket {inf} != _count {cnt}")
        buckets = sorted(
            (float(dict(lb)["le"]), v)
            for (n, lb), v in samples.items()
            if n == base + "_bucket" and dict(lb).get("le", "+Inf") != "+Inf")
        last = 0.0
        for ub, v in buckets:
            if v < last:
                problems.append(f"{base}: non-cumulative bucket le={ub}")
            last = v
    return problems
