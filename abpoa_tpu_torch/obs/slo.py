"""SLO evaluation over the run-report archive: `abpoa-tpu slo`.

Counterpart of `abpoa_tpu/obs/slo.py`, over the port's archive
(`archive.archive_dir`).

Objectives are declared in JSON (``tools/slo_objectives.json`` is the
shipped default): each names a per-run metric derived from an archive
record (obs/archive.py), a ceiling, and an error budget — the fraction
of runs in the window allowed to breach the ceiling before the
objective is VIOLATED. The evaluator prints per-objective burn rate
(bad-fraction / budget; >1 means the budget is spent) and remaining
budget, and exits nonzero on any violation: "are the runs still
meeting their service numbers".

Objective file format::

    {
      "window_runs": 200,
      "objectives": [
        {"name": "read-p99-wall", "metric": "read_p99_ms",
         "max": 500.0, "error_budget": 0.05,
         "description": "..."},
        ...
      ]
    }

Metrics an objective can reference (each derived per run; a run missing
the metric is skipped for that objective, never counted as bad):

- ``read_p99_ms``     sketch p99 of per-read wall, milliseconds
- ``read_p50_ms``     sketch p50, milliseconds
- ``fallback_rate``   fallback reads / total reads
- ``recompile_rate``  compile misses / total jit dispatches (0 when the
                      run made no jit dispatches)
- ``fault_rate``      absorbed faults / max(1, reads)
- ``quarantine_rate`` quarantined sets per run
- ``total_wall_s``    whole-run wall seconds
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import archive

DEFAULT_WINDOW = 200


def _metric(rec: dict, name: str) -> Optional[float]:
    reads = rec.get("reads") or 0
    wall_ms = rec.get("read_wall_ms") or {}
    if name == "read_p99_ms":
        return wall_ms.get("p99")
    if name == "read_p50_ms":
        return wall_ms.get("p50")
    if name == "fallback_rate":
        if not reads:
            return None
        return (rec.get("fallback_reads") or 0) / reads
    if name == "recompile_rate":
        hits = rec.get("compile_hits") or 0
        misses = rec.get("compile_misses") or 0
        return misses / (hits + misses) if hits + misses else 0.0
    if name == "fault_rate":
        return (rec.get("faults") or 0) / max(1, reads)
    if name == "quarantine_rate":
        return float(rec.get("quarantined") or 0)
    if name == "total_wall_s":
        return rec.get("total_wall_s")
    raise ValueError(f"unknown SLO metric: {name!r}")


def evaluate(objectives: dict, records: List[dict]) -> dict:
    """-> {"window", "objectives": [...], "violated"}; per objective:
    evaluated/bad counts, bad fraction, burn rate (bad_fraction /
    error_budget) and remaining budget. Violated = budget exhausted."""
    out = []
    any_violated = False
    for obj in objectives.get("objectives", []):
        name, metric = obj["name"], obj["metric"]
        ceiling = float(obj["max"])
        budget = float(obj.get("error_budget", 0.0))
        # optional workload scope: "map" runs amortize K-lane
        # round walls into per-read shares, so they get their own
        # ceilings; an objective without `workload` judges every run,
        # records without the field count as "consensus"
        scope = obj.get("workload")
        evaluated = bad = 0
        worst: Optional[float] = None
        offenders: List[tuple] = []   # (value, request id/label) of breaches
        for rec in records:
            if scope and (rec.get("workload") or "consensus") != scope:
                continue
            v = _metric(rec, metric)
            if v is None:
                continue
            evaluated += 1
            if worst is None or v > worst:
                worst = v
            if v > ceiling:
                bad += 1
                offenders.append(
                    (v, rec.get("request_id") or rec.get("label") or "?"))
        # the requests or runs that burned the budget, worst first: a
        # server record's request id (`why <id>` renders it), else the
        # run's label
        offenders.sort(key=lambda t: -t[0])
        bad_frac = bad / evaluated if evaluated else 0.0
        # zero budget means "no run may breach the ceiling": one bad run
        # reads as infinite burn
        burn = (bad_frac / budget) if budget > 0 else \
            (float("inf") if bad else 0.0)
        violated = evaluated > 0 and bad_frac > budget
        any_violated = any_violated or violated
        out.append({
            "name": name, "metric": metric, "max": ceiling,
            "error_budget": budget, "evaluated": evaluated, "bad": bad,
            "bad_fraction": round(bad_frac, 6),
            "burn_rate": (round(burn, 4)
                          if burn != float("inf") else None),
            "budget_remaining": round(max(0.0, 1.0 - burn), 4)
            if burn != float("inf") else 0.0,
            "worst": worst,
            "offenders": [{"id": oid, "value": round(v, 4)}
                          for v, oid in offenders[:5]],
            "violated": violated,
        })
    return {"window": len(records), "objectives": out,
            "violated": any_violated}


def format_table(result: dict, archive_path: str = "") -> str:
    lines = [f"SLO evaluation over {result['window']} archived runs"
             + (f"  ({archive_path})" if archive_path else "")]
    hdr = (f"  {'objective':<18} {'metric':<16} {'ceiling':>10} "
           f"{'bad/n':>9} {'budget':>7} {'burn':>6} {'left':>6}  verdict")
    lines.append(hdr)
    for o in result["objectives"]:
        burn = "inf" if o["burn_rate"] is None else f"{o['burn_rate']:.2f}"
        left = f"{100 * o['budget_remaining']:.0f}%"
        verdict = "VIOLATED" if o["violated"] else "ok"
        lines.append(
            f"  {o['name']:<18} {o['metric']:<16} {o['max']:>10g} "
            f"{o['bad']:>4}/{o['evaluated']:<4} "
            f"{100 * o['error_budget']:>6.1f}% {burn:>6} {left:>6}  "
            f"{verdict}")
        if o.get("offenders"):
            # the ids that burned the budget: `why <id>` renders each
            ids = "  ".join(f"{of['id']}({of['value']:g})"
                            for of in o["offenders"][:3])
            lines.append(f"      burned by: {ids}")
    lines.append("result: " + ("VIOLATED (error budget exhausted)"
                               if result["violated"] else
                               "ok (all objectives within budget)"))
    return "\n".join(lines) + "\n"


def default_objectives_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "tools", "slo_objectives.json")


def slo_main(argv) -> int:
    """`abpoa-tpu slo` — evaluate declared objectives against the archive
    window; rc 0 ok, 1 violated, 2 nothing to evaluate / bad input."""
    ap = argparse.ArgumentParser(
        prog="abpoa-tpu slo",
        description="evaluate SLO objectives (p99 wall, fallback-rate, "
                    "recompile-rate, fault-rate ceilings with error "
                    "budgets) against the run-report archive")
    ap.add_argument("--objectives", default=None, metavar="FILE",
                    help="objectives JSON [tools/slo_objectives.json]")
    ap.add_argument("--archive-dir", default=None, metavar="DIR",
                    help="archive directory [ABPOA_TPU_ARCHIVE_DIR or "
                         "~/.cache/abpoa_tpu_torch/reports]")
    ap.add_argument("--window", type=int, default=None, metavar="N",
                    help="newest N runs to evaluate [objectives file "
                         f"window_runs, else {DEFAULT_WINDOW}]")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="also write the machine-readable result "
                         "('-' for stdout)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the table (exit status only)")
    args = ap.parse_args(argv)
    obj_path = args.objectives or default_objectives_path()
    try:
        with open(obj_path) as fp:
            objectives = json.load(fp)
    except (OSError, ValueError) as e:
        print(f"Error: cannot load objectives {obj_path}: {e}",
              file=sys.stderr)
        return 2
    window = args.window or objectives.get("window_runs", DEFAULT_WINDOW)
    adir = args.archive_dir or archive.archive_dir()
    path = os.path.join(adir, archive.ARCHIVE_FILE)
    records = archive.read_window(window, path=path)
    if not records:
        print(f"Error: no archived runs under {adir} "
              "(run with archiving enabled first; see --report/--metrics "
              "docs)", file=sys.stderr)
        return 2
    try:
        result = evaluate(objectives, records)
    except (KeyError, ValueError) as e:
        print(f"Error: bad objectives file {obj_path}: {e}",
              file=sys.stderr)
        return 2
    if not args.quiet:
        sys.stdout.write(format_table(result, path))
    if args.json:
        text = json.dumps(result, indent=1)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w") as fp:
                fp.write(text + "\n")
    return 1 if result["violated"] else 0
