"""`why`: the postmortem of one request, one verdict.

Counterpart of `abpoa_tpu/obs/why.py`, with the same text. Input is a
request id (looked up in the run-report archive, whose server records
name the request's trace and dump files), or the path of a per-request
Chrome trace (`serve --trace-dir`) or of a harvested flight-recorder dump
(`obs/flight.py`). Output is a one-screen account:

- header: request id, terminal status, wall, device, when;
- where the wall went (admission wait, execution, the rest), from the
  request's spans;
- the span timeline, indented by containment, attempts marked;
- the flight recorder's tail: what a worker was doing when it died (open
  span, last dispatch and its shape, RSS trend, absorbed faults);
- a verdict line, e.g. "504: 28.1 s of 30 s budget spent in admission
  wait behind a coalesced K=8 group".

The JAX module's `--fleet` search over replica archives comes with the
fleet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

from . import archive
from .flight import SCHEMA as FLIGHT_SCHEMA

# rung-describing keys rendered from dispatch span args, in display order
_RUNG_KEYS = ("Qp", "W", "K", "R", "P", "N", "rows", "qlen", "sets")


def _fmt_rung(args: Optional[dict]) -> str:
    if not args:
        return ""
    parts = [f"{k}={args[k]}" for k in _RUNG_KEYS if k in args]
    return "/".join(parts)


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "?"
    return f"{v * 1e3:.1f} ms" if v < 1.0 else f"{v:.1f} s"


# --------------------------------------------------------------------------- #
# input resolution                                                            #
# --------------------------------------------------------------------------- #

def load_artifact(path: str) -> Tuple[Optional[dict], Optional[dict]]:
    """-> (trace_doc, dump) from one JSON file, whichever it is."""
    with open(path) as fp:
        doc = json.load(fp)
    if isinstance(doc, dict) and doc.get("schema") == FLIGHT_SCHEMA:
        return None, doc
    if isinstance(doc, dict) and "traceEvents" in doc:
        return doc, None
    raise ValueError(f"{path}: neither a flight dump nor a Chrome trace")


def find_record(rid: str, window: int = 0) -> Optional[dict]:
    """Newest archive record carrying this request id (archive.find_request
    — serve requests and pool jobs both record one per terminal status)."""
    return archive.find_request(rid, window)


# --------------------------------------------------------------------------- #
# analysis                                                                    #
# --------------------------------------------------------------------------- #

def _trace_spans(trace_doc: dict) -> List[dict]:
    return [e for e in trace_doc.get("traceEvents", [])
            if e.get("ph") == "X"]


def _attribution(spans: List[dict]) -> dict:
    """Per-name wall sums (seconds) over the request's spans, plus the
    request envelope: the outermost `request`/`pool_wait` bracket."""
    tot: dict = {}
    for e in spans:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e6
    return tot


def _span_tree_lines(spans: List[dict], limit: int = 24) -> List[str]:
    """The timeline, indented by containment per track (tid). Chrome
    semantics: a span nests under the previous span of the same tid that
    still covers its interval."""
    lines: List[str] = []
    by_tid: dict = {}
    for e in sorted(spans, key=lambda e: (e.get("ts", 0.0),
                                          -e.get("dur", 0.0))):
        tid = e.get("tid", 0)
        stack = by_tid.setdefault(tid, [])
        ts, dur = e.get("ts", 0.0), e.get("dur", 0.0)
        while stack and ts >= stack[-1]:
            stack.pop()
        depth = len(stack)
        stack.append(ts + dur)
        args = e.get("args") or {}
        att = f" [attempt {args['attempt']}]" if args.get("attempt") else ""
        rung = _fmt_rung(args)
        rung = f"  ({rung})" if rung else ""
        lines.append(f"  {'  ' * depth}{e['name']:<24} "
                     f"{_fmt_s(dur / 1e6):>10}  t+{ts / 1e6:.3f}s"
                     f"{att}{rung}")
    if len(lines) > limit:
        lines = lines[:limit] + [f"  ... {len(lines) - limit} more spans "
                                 "(open the trace in Perfetto)"]
    return lines


_DEATH_PHRASES = {
    "killed_deadline": "hard-killed at the job deadline",
    "killed_rss": "hard-killed over the RSS budget",
    "killed_stall": "hard-killed on a stalled heartbeat",
    "crashed": "crashed",
}


def _death_clause(dump: dict) -> str:
    """The kill half of the verdict, from a harvested flight dump."""
    harvest = dump.get("harvest") or {}
    reason = harvest.get("reason", "died")
    reason = _DEATH_PHRASES.get(reason, reason)
    job = dump.get("job") or {}
    open_spans = dump.get("open_spans") or []
    last = dump.get("last_dispatch")
    where = ""
    if open_spans:
        inner = open_spans[-1]
        where = f" mid `{inner['name']}`"
        rung = _fmt_rung(inner.get("args"))
        if not rung and last:
            rung = _fmt_rung(last.get("args"))
        if rung:
            where += f", rung {rung}"
    elif last:
        rung = _fmt_rung(last.get("args"))
        where = (f" between dispatches (last: `{last['name']}`"
                 + (f", rung {rung}" if rung else "") + ")")
    att = job.get("attempt")
    att_s = f" on attempt {att}" if att and att > 1 else ""
    return f"worker {reason}{where}{att_s}"


def verdict(record: Optional[dict], trace_doc: Optional[dict],
            dump: Optional[dict]) -> str:
    """One causal sentence. Status comes from the archive record when we
    have one, else from the dump's harvested death."""
    status = (record or {}).get("status")
    wall = (record or {}).get("total_wall_s")
    deadline = (record or {}).get("deadline_s")
    clauses: List[str] = []
    att = _attribution(_trace_spans(trace_doc)) if trace_doc else {}
    wait = att.get("admission_wait") or att.get("pool_wait")
    # continuous batching: a churned request's pickup-time
    # coalesced_k is stale — the record (and its admission_wait span args)
    # carry the group id and the round it actually boarded
    jr = (record or {}).get("join_round")
    jg = (record or {}).get("join_group")
    if jr is None and trace_doc:
        for e in _trace_spans(trace_doc):
            if e["name"] == "admission_wait":
                a = e.get("args") or {}
                if a.get("join_round") is not None:
                    jr, jg = a.get("join_round"), a.get("join_group")
    joined = (f"joined group {jg} at round {jr}"
              if jr is not None else "")
    if status == "timeout":
        head = "504"
        if wait and wall:
            k = None
            for e in _trace_spans(trace_doc):
                if e["name"] == "admission_wait":
                    k = (e.get("args") or {}).get("coalesced_k")
            behind = (f" ({joined})" if joined
                      else f" behind a coalesced K={k} group"
                      if k and k > 1 else "")
            budget = f" of {deadline:g} s budget" if deadline else ""
            clauses.append(f"{wait:.1f} s{budget} spent in admission wait"
                           f"{behind}")
        elif wall is not None:
            clauses.append(f"deadline expired after {_fmt_s(wall)}"
                           + (f" ({joined})" if joined else ""))
    elif status == "ok":
        head = "ok"
        clauses.append(f"served in {_fmt_s(wall)}"
                       + (f" ({_fmt_s(wait)} of it queued)"
                          if wait and wall and wait > 0.5 * wall else "")
                       + (f" ({joined})" if joined else ""))
    elif status == "poisoned" or status == "quarantined":
        head = "400"
        clauses.append("poisoned set rejected at the quarantine boundary")
    elif status in ("error", "poison"):
        head = "500"
        if not dump:
            clauses.append("unclassified failure (see faults)")
    elif status is None and dump is not None:
        head = "killed"
    else:
        head = status or "?"
    if dump is not None and (dump.get("harvest")
                             or (dump.get("job") or {}).get(
                                 "status", "").startswith("died")):
        clauses.append(_death_clause(dump))
    if not clauses:
        clauses.append("no causal signal recorded (trace/dump missing?)")
    return f"{head}: " + "; ".join(clauses)


# --------------------------------------------------------------------------- #
# rendering                                                                   #
# --------------------------------------------------------------------------- #

def render_why(record: Optional[dict], trace_doc: Optional[dict],
               dump: Optional[dict], ref: str = "") -> str:
    lines: List[str] = []
    rid = ((record or {}).get("request_id")
           or ((dump or {}).get("job") or {}).get("rid")
           or ((dump or {}).get("harvest") or {}).get("request_id")
           or ref)
    head = f"why {rid}"
    if record:
        head += (f"  status={record.get('status')}"
                 f"  wall={_fmt_s(record.get('total_wall_s'))}"
                 + (f"  device={record.get('device')}"
                    if record.get("device") else "")
                 + (f"  replica={record.get('replica')}"
                    if record.get("replica") else "")
                 + (f"  attempt={record.get('attempt')}"
                    if (record.get("attempt") or 1) > 1 else "")
                 + (f"  at {record.get('ts')}" if record.get("ts") else ""))
    lines.append(head)
    # sharded route: the record prices the whole mesh — name the
    # global K cap and the mesh it was spread over
    if record and record.get("mesh"):
        lines.append(f"route: {record.get('route') or 'sharded'} "
                     f"K={record.get('k_cap') or '?'} "
                     f"over mesh={record['mesh']}")
        # shard-skew attribution (obs/rounds.py via serve account()):
        # which shard gated the request's last sharded round, and by how
        # much the mesh was out of level
        if record.get("slowest_shard") is not None:
            wall = record.get("round_wall_ms")
            lines.append(
                f"slowest shard: {record['slowest_shard']} "
                f"(skew {record.get('shard_skew', 1.0):.2f}x"
                + (f", round wall {wall:.2f} ms" if wall else "")
                + ")")
    lines.append("")
    lines.append("verdict: " + verdict(record, trace_doc, dump))

    if trace_doc:
        spans = _trace_spans(trace_doc)
        att = _attribution(spans)
        if att:
            lines.append("")
            total = (record or {}).get("total_wall_s")
            lines.append("time attribution (span wall sums):")
            for name, w in sorted(att.items(), key=lambda kv: -kv[1])[:8]:
                share = (f" {100 * w / total:>5.1f}%"
                         if total else "")
                lines.append(f"  {name:<24} {_fmt_s(w):>10}{share}")
        if spans:
            lines.append("")
            lines.append(f"span timeline ({len(spans)} spans):")
            lines.extend(_span_tree_lines(spans))

    if dump:
        lines.append("")
        job = dump.get("job") or {}
        lines.append(f"flight recorder (worker pid {dump.get('pid')}, "
                     f"label {dump.get('label') or '?'}, "
                     f"{dump.get('beats', 0)} beats):")
        if job:
            lines.append(f"  job: {job.get('kind')} {job.get('label') or ''}"
                         f" rid={job.get('rid')} attempt={job.get('attempt')}"
                         f" status={job.get('status')}".rstrip())
        harvest = dump.get("harvest")
        if harvest:
            det = f" ({harvest['detail']})" if harvest.get("detail") else ""
            lines.append(f"  harvested: {harvest.get('reason')}{det}")
        for sp in dump.get("open_spans") or []:
            rung = _fmt_rung(sp.get("args"))
            lines.append(f"  open span at death: `{sp['name']}` "
                         f"[{sp['cat']}] running {_fmt_s(sp['elapsed_s'])}"
                         + (f"  rung {rung}" if rung else ""))
        last = dump.get("last_dispatch")
        if last:
            rung = _fmt_rung(last.get("args"))
            lines.append(f"  last dispatch: `{last['name']}` "
                         f"{_fmt_s(last.get('dur_s'))}"
                         + (f"  rung {rung}" if rung else ""))
        rss = dump.get("rss") or []
        if rss:
            first, peak = rss[0][1], max(r[1] for r in rss)
            lines.append(f"  rss: {first / 1e6:.0f} MB -> "
                         f"{rss[-1][1] / 1e6:.0f} MB at death "
                         f"(peak {peak / 1e6:.0f} MB over "
                         f"{len(rss)} beats)")
        faults = dump.get("faults") or []
        if faults:
            lines.append(f"  absorbed faults ({len(faults)} recent):")
            for rec in faults[-5:]:
                lines.append(f"    t+{rec.get('t_s', 0):.2f}s "
                             f"{rec.get('kind')}"
                             + (f" -> {rec['action']}"
                                if rec.get("action") else ""))

    if record:
        refs = []
        if record.get("trace_file"):
            refs.append(f"trace: {record['trace_file']}")
        if record.get("dump_file"):
            refs.append(f"dump: {record['dump_file']}")
        if refs:
            lines.append("")
            lines.append("artifacts: " + "  ".join(refs))
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# CLI                                                                         #
# --------------------------------------------------------------------------- #

def why_main(argv) -> int:
    """`why <request-id | trace.json | dump.json>`: rc 0 on a rendered
    verdict, 2 when the id or file resolves to nothing."""
    ap = argparse.ArgumentParser(
        prog="python -m abpoa_tpu_torch why",
        description="postmortem analyzer: render one request's span tree "
                    "+ flight-recorder tail into a causal verdict "
                    "(why was this a 504/500/kill?)")
    ap.add_argument("what",
                    help="request id (X-Abpoa-Request-Id / archive "
                         "request_id), or a path to a per-request trace "
                         "or harvested flight dump")
    ap.add_argument("--archive-dir", default=None, metavar="DIR",
                    help="archive directory for id lookup "
                         "[ABPOA_TPU_ARCHIVE_DIR or "
                         "~/.cache/abpoa_tpu_torch/reports]")
    ap.add_argument("--window", type=int, default=0, metavar="N",
                    help="newest N archive records to search [all]")
    args = ap.parse_args(argv)
    if args.archive_dir:
        os.environ["ABPOA_TPU_ARCHIVE_DIR"] = args.archive_dir
    record = trace_doc = dump = None
    if os.path.exists(args.what):
        try:
            trace_doc, dump = load_artifact(args.what)
        except (OSError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 2
        rid = (((dump or {}).get("job") or {}).get("rid")
               or ((dump or {}).get("harvest") or {}).get("request_id"))
        if not rid and trace_doc:
            for e in trace_doc.get("traceEvents", []):
                rid = (e.get("args") or {}).get("rid") or \
                    (e.get("args") or {}).get("request_id")
                if rid:
                    break
        if rid:
            record = find_record(rid, args.window)
    else:
        record = find_record(args.what, args.window)
        if record is None:
            print(f"Error: request id {args.what!r} not found in the "
                  f"archive under {archive.archive_dir()} (and it is not "
                  "a file)", file=sys.stderr)
            return 2
    # pull the cross-referenced artifacts the archive record names
    if record is not None:
        for key, slot in (("trace_file", "trace"), ("dump_file", "dump")):
            path = record.get(key)
            if not path or not os.path.exists(path):
                continue
            try:
                t, d = load_artifact(path)
            except (OSError, ValueError):
                continue
            if slot == "trace" and trace_doc is None:
                trace_doc = t
            if slot == "dump" and dump is None:
                dump = d
    sys.stdout.write(render_why(record, trace_doc, dump, ref=args.what))
    if record is not None and (record.get("attempt") or 1) > 1:
        # a delivery after the first (a router's retry): the earlier
        # attempt's replica left no record
        sys.stdout.write(
            f"\nfleet: delivered on attempt {record['attempt']} by "
            f"replica {record.get('replica') or '?'} — the earlier "
            "attempt left no archive record (its replica died "
            "mid-request; the router failed the request over)\n")
    return 0
