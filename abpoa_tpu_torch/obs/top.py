"""`abpoa-tpu top` — a live terminal dashboard over the metrics exporter.

Counterpart of `abpoa_tpu/obs/top.py`; it reads the same families, with
the server's and the tracing panels, less the pool's, which comes with
the pool.

Reads the Prometheus textfile a concurrent run maintains (`--metrics
FILE`, atomic renames, so a frame is never torn) and renders the
operator's one-screen view: reads/s, cell-updates/s, MFU, the route and
its rounds, the phase split, kernel-library builds, faults.
Plain-refresh rendering (ANSI home+clear per frame) — no curses
dependency, works over ssh and in CI transcripts; `--once` prints a
single frame and exits (the testable path).

    terminal 1:  abpoa-tpu -l lists.txt --metrics /tmp/abpoa.prom
    terminal 2:  abpoa-tpu top /tmp/abpoa.prom
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Tuple

from . import metrics as M

BAR_W = 24


def _labeled(samples, family: str, label: str) -> Dict[str, float]:
    """{label-value: sample} for every sample of `family` keyed by one
    label name."""
    out: Dict[str, float] = {}
    for (name, labels), v in samples.items():
        if name == family:
            d = dict(labels)
            if label in d:
                out[d[label]] = v
    return out


def _total(samples, family: str) -> float:
    return sum(v for (name, _l), v in samples.items() if name == family)


def _bar(frac: float, width: int = BAR_W) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def _fmt_si(v: float) -> str:
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suf}"
    return f"{v:.0f}"


def render_frame(samples, types, path: str, age_s: float) -> str:
    """One dashboard frame from parsed exposition samples."""
    lines = []
    staleness = " [STALE]" if age_s > 10 else ""
    lines.append(f"abpoa-tpu top — {path}  (updated {age_s:.1f}s ago"
                 f"{staleness})")
    runs = _total(samples, "abpoa_runs_total")
    dev = next((dict(lb) for (n, lb) in samples
                if n == "abpoa_device_info"), None)
    devs = (f"  device {dev.get('platform', '?')} {dev.get('kind', '')}"
            .rstrip() if dev else "")
    batch = M.sample_value(samples, "abpoa_batch_sets")
    prog = ""
    if batch:
        done = M.sample_value(samples, "abpoa_batch_sets_done") or 0
        prog = (f"  batch {done:.0f}/{batch:.0f} sets "
                f"{_bar(done / batch, 12)}")
    lines.append(f"runs {runs:.0f}{devs}{prog}")
    lines.append("")

    # throughput block
    reads = _total(samples, "abpoa_reads_total")
    rps = M.sample_value(samples, "abpoa_reads_per_second") or 0.0
    q = {lbl: v for lbl, v in _labeled(
        samples, "abpoa_read_wall_seconds_quantile", "quantile").items()}
    lat = ""
    if q:
        lat = ("  wall ms  p50 {:.2f}  p95 {:.2f}  p99 {:.2f}".format(
            1e3 * q.get("0.5", 0), 1e3 * q.get("0.95", 0),
            1e3 * q.get("0.99", 0)))
    lines.append(f"reads    {_fmt_si(reads):>9} total  {rps:>9.1f}/s{lat}")
    cells = _total(samples, "abpoa_dp_cells_total")
    cups = M.sample_value(samples, "abpoa_cell_updates_per_second") or 0.0
    mfu = M.sample_value(samples, "abpoa_mfu_ratio")
    mfu_s = f"  MFU {100 * mfu:.3f}%" if mfu is not None else ""
    lines.append(f"dp       {_fmt_si(cells):>9} cells  "
                 f"{_fmt_si(cups):>8}/s CUPS{mfu_s}")

    # serve panel (present only when a server feeds the exporter): the
    # admission state, the requests by terminal status and the request
    # latency quantiles
    statuses = _labeled(samples, "abpoa_serve_requests_total", "status")
    qdepth = M.sample_value(samples, "abpoa_serve_queue_depth")
    if statuses or qdepth is not None:
        inflight = M.sample_value(samples, "abpoa_serve_inflight") or 0
        disp = "  ".join(f"{k}={v:.0f}" for k, v in sorted(statuses.items()))
        lines.append(f"serve    queue {qdepth or 0:.0f}  inflight "
                     f"{inflight:.0f}  {disp}")
        sq = _labeled(samples, "abpoa_serve_request_seconds_quantile",
                      "quantile")
        if sq:
            lines.append("         req ms  p50 {:.2f}  p95 {:.2f}  "
                         "p99 {:.2f}".format(
                             1e3 * sq.get("0.5", 0), 1e3 * sq.get("0.95", 0),
                             1e3 * sq.get("0.99", 0)))

    # scheduler panel (present once a batch or serve route was planned):
    # the selected route, lockstep K cap, route-decision counts and the
    # idle-lane EWMA the server's K cap reads
    route_hot = _labeled(samples, "abpoa_scheduler_route", "route")
    # the route counter carries a `reason` label too (crossover vs
    # ineligible vs eligible...), so per-route display sums over reasons
    routes: Dict[str, float] = {}
    for (name, labels), v in samples.items():
        if name == "abpoa_scheduler_routes_total":
            r = dict(labels).get("route")
            if r is not None:
                routes[r] = routes.get(r, 0.0) + v
    if route_hot or routes:
        cur = next((k for k, v in route_hot.items() if v >= 1), "?")
        k_cap = M.sample_value(samples, "abpoa_scheduler_k_cap")
        parts = [f"route {cur}"]
        noop = M.sample_value(samples, "abpoa_lockstep_noop_fraction")
        if k_cap is not None:
            parts.append(f"k_cap {k_cap:.0f}")
        if noop is not None:
            parts.append(f"noop {noop:.2f} [{_bar(noop, 8)}]")
        if routes:
            parts.append("  ".join(f"{k}={v:.0f}"
                                   for k, v in sorted(routes.items())))
        lines.append("sched    " + "  ".join(parts))
        # mesh row (present only when the sharded route built a device
        # mesh): device count, platform, per-shard lane occupancy
        mesh_n = M.sample_value(samples, "abpoa_mesh_devices")
        if mesh_n:
            plat = next((dict(lb).get("platform", "?")
                         for (n, lb) in samples
                         if n == "abpoa_mesh_platform_info"), "?")
            shard_occ = _labeled(samples, "abpoa_shard_lane_occupancy",
                                 "shard")
            occ_s = ""
            if shard_occ:
                occ_s = "  occ " + " ".join(
                    f"{s}:{v:.2f}" for s, v in sorted(
                        shard_occ.items(), key=lambda kv: int(kv[0])))
            lines.append(f"         mesh {mesh_n:.0f}x{plat}{occ_s}")
            # shard-skew row (obs/rounds.py): max/min estimated slot wall
            # of the last sharded round and the straggler slot
            skew = M.sample_value(samples, "abpoa_shard_skew_ratio")
            shard_walls = _labeled(samples,
                                   "abpoa_shard_round_wall_seconds",
                                   "shard")
            if skew is not None and shard_walls:
                straggler = M.sample_value(samples,
                                           "abpoa_shard_straggler")
                walls = sorted(shard_walls.items(),
                               key=lambda kv: kv[1])
                lo_s, lo_w = walls[0]
                hi_s, hi_w = walls[-1]
                lines.append(
                    f"         skew {skew:.2f}x  round wall "
                    f"max {1e3 * hi_w:.2f} ms (shard {hi_s}) / "
                    f"min {1e3 * lo_w:.2f} ms (shard {lo_s})  "
                    f"straggler shard "
                    f"{straggler if straggler is None else int(straggler)}")
        chunks = _total(samples, "abpoa_lockstep_chunks_total")
        drains = _total(samples, "abpoa_lockstep_drain_chunks_total")
        if chunks:
            lines.append(f"         lockstep rounds {chunks:.0f}  "
                         f"drain {drains:.0f}")
        # lane occupancy, the churn counters (joins boarded mid-flight,
        # lanes retired early, boundary evictions) and the join wait
        occ = M.sample_value(samples, "abpoa_lockstep_lane_occupancy")
        if occ is not None:
            lines.append(f"         occupancy {occ:.2f} [{_bar(occ, 8)}]")
        joins = _total(samples, "abpoa_lockstep_joins_total")
        retires = _total(samples, "abpoa_lockstep_early_retires_total")
        evicts = _total(samples, "abpoa_lockstep_evictions_total")
        if joins or retires or evicts:
            lines.append(f"         churn joins {joins:.0f}  "
                         f"early-retires {retires:.0f}  "
                         f"evictions {evicts:.0f}")
        jq = _labeled(samples, "abpoa_lockstep_join_wait_seconds_quantile",
                      "quantile")
        if jq:
            lines.append("         join wait p50 %.0f ms  p99 %.0f ms"
                         % (1e3 * jq.get("0.5", 0), 1e3 * jq.get("0.99", 0)))
    # map panel (present only when `map` ran): reads against the static
    # graph, the lane occupancy and join counters
    map_reads = _total(samples, "abpoa_map_reads_total")
    if map_reads:
        mrps = M.sample_value(samples, "abpoa_map_reads_per_second") or 0.0
        parts = [f"{_fmt_si(map_reads):>9} reads  {mrps:>9.1f}/s"]
        rounds = _total(samples, "abpoa_map_rounds_total")
        if rounds:
            parts.append(f"rounds {rounds:.0f}")
        joins = _total(samples, "abpoa_map_joins_total")
        if joins:
            parts.append(f"joins {joins:.0f}")
        lines.append("map      " + "  ".join(parts))
        mocc = M.sample_value(samples, "abpoa_map_lane_occupancy")
        if mocc is not None:
            lines.append(f"         occupancy {mocc:.2f} [{_bar(mocc, 8)}]")

    # tracing panel: the per-request traces the server wrote (`why`
    # reads them)
    traces = _total(samples, "abpoa_serve_traces_total")
    if traces:
        lines.append(f"tracing  request traces {traces:.0f}")

    # abandoned watchdog threads: a request's deadline abandons its
    # thread, which may still be running
    abandoned = M.sample_value(samples, "abpoa_watchdog_abandoned_threads")
    if abandoned:
        lines.append(f"watchdog abandoned-threads {abandoned:.0f}")

    # phase split
    phases = _labeled(samples, "abpoa_phase_wall_seconds_total", "phase")
    tot = sum(phases.values())
    if tot > 0:
        lines.append("")
        lines.append(f"phases   ({tot:.1f}s recorded)")
        for name, w in sorted(phases.items(), key=lambda kv: -kv[1])[:8]:
            frac = w / tot
            lines.append(f"  {name:<16} {_bar(frac)} {100 * frac:>5.1f}% "
                         f"{w:>8.2f}s")

    # compiles
    hits = _total(samples, "abpoa_compile_hits_total")
    misses = _total(samples, "abpoa_compile_misses_total")
    if hits or misses:
        lines.append("")
        lines.append(f"compiles {misses:.0f} compiled / {hits:.0f} cache "
                     "hits")

    # resilience block
    breakers = _labeled(samples, "abpoa_breaker_open", "backend")
    if breakers:
        states = "  ".join(
            f"{b}={'OPEN' if v else 'closed'}"
            for b, v in sorted(breakers.items()))
        lines.append(f"breakers {states}")
    faults = _labeled(samples, "abpoa_faults_total", "kind")
    if faults:
        lines.append("faults   " + "  ".join(
            f"{k}={v:.0f}" for k, v in sorted(faults.items())))
    fbs = _labeled(samples, "abpoa_fallbacks_total", "reason")
    if fbs:
        lines.append("fallback " + "  ".join(
            f"{k}={v:.0f}" for k, v in sorted(fbs.items())))
    extras = []
    for fam, lbl in (("abpoa_quarantined_sets_total", "quarantined sets"),
                     ("abpoa_watchdog_fires_total", "watchdog fires"),
                     ("abpoa_admission_demotions_total",
                      "admission demotions")):
        v = _total(samples, fam)
        if v:
            extras.append(f"{lbl} {v:.0f}")
    if extras:
        lines.append("events   " + "  ".join(extras))
    return "\n".join(lines) + "\n"


def _read_frame(path: str) -> Tuple[str, float]:
    with open(path) as fp:
        text = fp.read()
    age = time.time() - os.path.getmtime(path)
    return text, age


def _fetch_frame(url: str, timeout: float = 5.0) -> Tuple[str, float]:
    """Scrape a live /metrics endpoint (a run's `--metrics-port`
    exporter). A fetched frame is by definition fresh (age 0)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace"), 0.0


def top_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="abpoa-tpu top",
        description="live terminal dashboard over the --metrics exporter "
                    "file of a concurrent run, or a live /metrics "
                    "endpoint (--url)")
    ap.add_argument("file", nargs="?", default=M.default_textfile_path(),
                    help="exporter textfile to watch "
                         "[%(default)s]")
    ap.add_argument("--url", default=None, metavar="URL",
                    help="scrape a live endpoint instead of the textfile "
                         "(e.g. http://host:port/metrics, a run's "
                         "--metrics-port exporter)")
    ap.add_argument("-n", "--interval", type=float, default=1.0,
                    help="refresh interval seconds [%(default)s]")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clearing)")
    args = ap.parse_args(argv)
    src = args.url or args.file
    while True:
        try:
            if args.url:
                text, age = _fetch_frame(args.url)
            else:
                text, age = _read_frame(args.file)
            samples, types = M.parse_exposition(text)
            frame = render_frame(samples, types, src, age)
        except OSError as e:
            if args.url:
                frame = (f"abpoa-tpu top — waiting for {args.url}\n"
                         f"({e})\n")
            else:
                frame = (f"abpoa-tpu top — waiting for {args.file}\n"
                         "(start a run with `--metrics "
                         f"{args.file}` to feed it)\n")
        except ValueError as e:
            frame = f"abpoa-tpu top — unparseable exposition: {e}\n"
        if args.once:
            sys.stdout.write(frame)
            return 0
        # plain refresh: home + clear-to-end, then the frame
        sys.stdout.write("\x1b[H\x1b[2J" + frame)
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
