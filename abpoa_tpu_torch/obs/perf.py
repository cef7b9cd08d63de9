"""`abpoa-tpu perf` — render the performance-trajectory ledger and run
the drift gate.

Counterpart of `abpoa_tpu/obs/perf.py` over the port's ledger file
(`ledger.LEDGER_FILE`).

Default: a per-(source, workload) x metric table with count, median,
latest, and a sparkline of the series: "has reads/s drifted over the
last N runs".

`--diff A B` compares two records (integer window indexes, or the newest
record matching a source/workload/key/git-sha string). `--json` emits
the raw window for scripting.

`--gate` is the drift detector: the NEWEST record of every (source,
workload) group is compared against the trailing-window MEDIAN of its
own group; any metric below `--threshold` x median fails (rc 1). Groups
with fewer than `--min-history` prior records pass vacuously: a new
workload must not fail its own first runs. `--inject-slowdown F` divides
the current values first, to show that the gate can fail.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import ledger


def perf_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="abpoa-tpu perf",
        description="Render the performance-trajectory ledger "
                    f"({ledger.LEDGER_FILE}) or run the drift gate.")
    ap.add_argument("--ledger", metavar="PATH", default=None,
                    help="ledger file (default: ABPOA_TPU_LEDGER_DIR/"
                         f"{ledger.LEDGER_FILE})")
    ap.add_argument("--window", type=int, default=500, metavar="N",
                    help="newest N records to consider (default 500)")
    ap.add_argument("--json", action="store_true",
                    help="emit the record window (or gate verdicts) as "
                         "JSON instead of the table")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two records: window indexes or "
                         "source/workload/key/sha selectors")
    ap.add_argument("--gate", action="store_true",
                    help="drift-gate mode: rc 1 when any (source, "
                         "workload) group's newest record regresses "
                         "below threshold x trailing median")
    ap.add_argument("--threshold", type=float, default=ledger.DRIFT_RATIO,
                    help="gate floor as a fraction of the trailing "
                         f"median (default {ledger.DRIFT_RATIO})")
    ap.add_argument("--min-history", type=int,
                    default=ledger.DRIFT_MIN_HISTORY,
                    help="prior records a group needs before it can "
                         f"fail (default {ledger.DRIFT_MIN_HISTORY})")
    ap.add_argument("--span", type=int, default=ledger.DRIFT_SPAN,
                    help="trailing records the median is taken over "
                         f"(default {ledger.DRIFT_SPAN})")
    ap.add_argument("--inject-slowdown", type=float, default=1.0,
                    metavar="F",
                    help="self-test: divide current metrics by F before "
                         "gating (the gate must flip to rc 1)")
    ap.add_argument("--metric", action="append", default=None,
                    help="metric(s) to render/gate (repeatable; default "
                         + "/".join(ledger.DRIFT_METRICS) + ")")
    args = ap.parse_args(argv)

    window = ledger.read_window(args.window, path=args.ledger)
    metrics = tuple(args.metric) if args.metric else ledger.DRIFT_METRICS

    if args.gate:
        return _gate(window, args, metrics)
    try:
        if args.diff:
            print(ledger.render_diff(window, args.diff[0], args.diff[1]))
        elif args.json:
            print(json.dumps(window))
        else:
            print(ledger.render_trajectory(window, metrics=metrics,
                                           path=args.ledger))
    except BrokenPipeError:
        # `perf | head` closing the pipe is not an error
        sys.stderr.close()
    return 0


def _gate(window, args, metrics) -> int:
    if not window:
        print("[perf-drift] FAIL: ledger is empty: run "
              "`abpoa_tpu_torch warm` first", file=sys.stderr)
        return 1
    verdicts = ledger.drift_check(
        window, metrics=metrics, ratio=args.threshold,
        min_history=args.min_history, span=args.span,
        slowdown=args.inject_slowdown)
    if args.json:
        print(json.dumps(verdicts))
    bad = [v for v in verdicts if not v["ok"]]
    for v in verdicts:
        tag = "ok  " if v["ok"] else "DRIFT"
        med = v.get("median")
        print(f"[perf-drift] {tag} {v['source']}:{v['workload'] or '-'} "
              f"{v['metric']} current={v['current']} "
              f"median={med if med is not None else '-'} "
              f"n={v['n_history']}"
              + (f" floor={v['floor']}" if "floor" in v else "")
              + (f" ({v['note']})" if v.get("note") else ""),
              file=sys.stderr)
    if bad:
        print(f"[perf-drift] FAIL: {len(bad)} metric(s) regressed below "
              f"{args.threshold} x trailing median", file=sys.stderr)
        return 1
    print(f"[perf-drift] PASS: {len(verdicts)} metric checks over "
          f"{len(window)} records", file=sys.stderr)
    return 0
