"""Performance-trajectory ledger: the cross-run perf memory behind
`perf`.

Counterpart of `abpoa_tpu/obs/ledger.py`, with its record schema, drift
gate and renderers. A perf-bearing entry point (in the port: `warm`)
appends ONE schema-versioned JSONL record: git sha, host fingerprint,
device, route, rung, reads/s, CUPS, MFU, occupancy, p50/p95/p99, compile
misses, gate verdict. `perf --gate` compares the newest record of each
(source, workload) group against the trailing-window MEDIAN of its own
group.

The port's file is ``TORCH_RUN_LEDGER.jsonl`` (never the repository's
``PERF_LEDGER.jsonl``) under ``ABPOA_TPU_LEDGER_DIR`` or
``~/.cache/abpoa_tpu_torch/ledger``; `device` names the card and its
power limit (`device_label`).

Write discipline is `obs/archive.py`'s: one ``os.write`` on an
``O_APPEND`` descriptor (same-host appends can never interleave bytes),
rotation past MAX_BYTES (8 MB) to ``TORCH_RUN_LEDGER.jsonl.1`` under a
process lock with a re-stat, one rotated generation kept. Append failure
never fails the work that produced the record. Records carry an
idempotency ``key``.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

LEDGER_FILE = "TORCH_RUN_LEDGER.jsonl"
LEDGER_SCHEMA_VERSION = 1
MAX_BYTES = 8_000_000

# the drift gate's defaults: a run regresses when a metric falls below
# RATIO x the trailing-window median of its own (source, workload) group;
# groups with fewer than MIN_HISTORY prior records pass vacuously (a new
# workload must not fail its own first run)
DRIFT_RATIO = 0.6
DRIFT_MIN_HISTORY = 3
DRIFT_SPAN = 12
DRIFT_METRICS = ("reads_per_sec", "cell_updates_per_sec")

_ROTATE_LOCK = threading.Lock()
_GIT_SHA_CACHE: Optional[str] = None


def ledger_dir() -> str:
    d = os.environ.get("ABPOA_TPU_LEDGER_DIR")
    if d:
        return d
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "abpoa_tpu_torch", "ledger")


def ledger_path() -> str:
    return os.path.join(ledger_dir(), LEDGER_FILE)


def git_sha() -> str:
    """Short sha of the working tree, "" outside a repo / without git.
    Cached per process: the ledger appends from tight gate loops."""
    global _GIT_SHA_CACHE
    if _GIT_SHA_CACHE is None:
        try:
            _GIT_SHA_CACHE = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA_CACHE = ""
    return _GIT_SHA_CACHE


def host_fingerprint() -> Dict[str, object]:
    return {
        "node": platform.node(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpus": os.cpu_count() or 1,
    }


def device_label(dev=None) -> str:
    """The ledger's `device` for a torch device: the card's name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` gives them (for
    example "NVIDIA H100 80GB HBM3, 700.00 W"), the name from
    `torch.cuda.get_device_name` alone where nvidia-smi does not answer;
    "cpu" for the CPU."""
    import torch
    dev = torch.device(dev or "cpu")
    if dev.type != "cuda":
        return dev.type
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(idx)],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or torch.cuda.get_device_name(idx)


def make_record(source: str, *, workload: str = "", device: str = "",
                route: str = "", rung: Optional[dict] = None,
                reads_per_sec: Optional[float] = None,
                cell_updates_per_sec: Optional[float] = None,
                mfu: Optional[float] = None,
                occupancy: Optional[float] = None,
                read_wall_ms: Optional[dict] = None,
                compile_misses: Optional[int] = None,
                verdict: Optional[str] = None,
                ts: Optional[str] = None,
                key: Optional[str] = None,
                extra: Optional[dict] = None) -> dict:
    """One canonical ledger record. Every appender goes through here so
    the schema-golden test pins ONE shape; `rung` is the compile-rung
    coordinate ({"K":..,"mesh":..,"Qp":..} — absent axes omitted), and
    `key` is the idempotency handle (derived from source+ts when the
    caller has no natural one)."""
    ts = ts or time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    rec = {
        "ts": ts,
        "schema_version": LEDGER_SCHEMA_VERSION,
        "source": source,
        "workload": workload,
        "git_sha": git_sha(),
        "host": host_fingerprint(),
        "device": device,
        "route": route,
        "rung": dict(rung or {}),
        "reads_per_sec": _num(reads_per_sec),
        "cell_updates_per_sec": _num(cell_updates_per_sec),
        "mfu": _num(mfu),
        "occupancy": _num(occupancy),
        "read_wall_ms": dict(read_wall_ms) if read_wall_ms else None,
        "compile_misses": compile_misses,
        "verdict": verdict,
    }
    if key is None:
        key = hashlib.sha1(
            f"{source}|{workload}|{ts}|{reads_per_sec}".encode()
        ).hexdigest()[:16]
    rec["key"] = key
    if extra:
        rec["extra"] = extra
    return rec


def _num(v) -> Optional[float]:
    if v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return round(f, 6)


def append_record(rec: dict) -> Optional[str]:
    """Append one ledger record. Same contract as archive.append_record:
    single O_APPEND write, rotate past the cap, failure returns None and
    never raises into the caller's perf run."""
    path = ledger_path()
    data = (json.dumps(rec) + "\n").encode()
    try:
        os.makedirs(ledger_dir(), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        _rotate_if_needed(path)
    except OSError:
        return None
    return path


def _rotate_if_needed(path: str) -> None:
    with _ROTATE_LOCK:
        try:
            if os.path.getsize(path) <= MAX_BYTES:
                return
            os.replace(path, path + ".1")  # drops any previous .1
        except OSError:
            pass


def read_window(n: int, path: Optional[str] = None) -> List[dict]:
    """The newest `n` ledger records, oldest-first, rotated generation
    included; unparseable lines skipped, never fatal."""
    path = path or ledger_path()
    lines: List[str] = []
    for p in (path + ".1", path):
        try:
            with open(p) as fp:
                lines.extend(fp.read().splitlines())
        except OSError:
            continue
    out: List[dict] = []
    for line in lines[-n:] if n else lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


REQUIRED_KEYS = ("ts", "schema_version", "source", "workload", "git_sha",
                 "host", "device", "route", "rung", "reads_per_sec",
                 "cell_updates_per_sec", "mfu", "occupancy", "read_wall_ms",
                 "compile_misses", "verdict", "key")


def lint_record(rec: dict) -> List[str]:
    """Schema complaints for one record (empty = clean)."""
    problems: List[str] = []
    for k in REQUIRED_KEYS:
        if k not in rec:
            problems.append(f"missing key {k!r}")
    if rec.get("schema_version") != LEDGER_SCHEMA_VERSION:
        problems.append(f"schema_version {rec.get('schema_version')!r} != "
                        f"{LEDGER_SCHEMA_VERSION}")
    if not rec.get("source"):
        problems.append("empty source")
    if not rec.get("key"):
        problems.append("empty idempotency key")
    for k in ("rung", "host"):
        if k in rec and not isinstance(rec[k], dict):
            problems.append(f"{k} is not a dict")
    if rec.get("read_wall_ms") is not None \
            and not isinstance(rec["read_wall_ms"], dict):
        problems.append("read_wall_ms is not a p50/p95/p99 dict")
    for m in ("reads_per_sec", "cell_updates_per_sec", "mfu", "occupancy"):
        v = rec.get(m)
        if v is not None and not isinstance(v, (int, float)):
            problems.append(f"{m} is not numeric")
    if rec.get("verdict") not in (None, "pass", "fail"):
        problems.append(f"verdict {rec.get('verdict')!r} not in "
                        "(None, 'pass', 'fail')")
    return problems


# ---------------------------------------------------------------- drift

def group_key(rec: dict) -> Tuple[str, str]:
    return (str(rec.get("source") or ""), str(rec.get("workload") or ""))


def group_records(window: Sequence[dict]) -> Dict[Tuple[str, str],
                                                  List[dict]]:
    """Records bucketed by (source, workload), ledger order preserved.
    Drift is only meaningful within a group: two workloads' reads/s are
    rates on different payloads and must never median together."""
    groups: Dict[Tuple[str, str], List[dict]] = {}
    for rec in window:
        groups.setdefault(group_key(rec), []).append(rec)
    return groups


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def drift_check(window: Sequence[dict],
                metrics: Sequence[str] = DRIFT_METRICS,
                ratio: float = DRIFT_RATIO,
                min_history: int = DRIFT_MIN_HISTORY,
                span: int = DRIFT_SPAN,
                slowdown: float = 1.0) -> List[dict]:
    """Drift verdicts: for every (source, workload) group, compare the
    NEWEST record's metrics against the median of up to `span` trailing
    records. A metric regresses when current < ratio x median. Groups
    with < min_history prior records are reported `ok` with
    history=short (a fresh workload's first runs never self-fail).
    `slowdown` divides the current values first — the gate's
    --inject-slowdown self-test."""
    verdicts: List[dict] = []
    for (source, workload), recs in sorted(group_records(window).items()):
        cur, hist = recs[-1], recs[:-1][-span:]
        for m in metrics:
            cv = cur.get(m)
            if cv is None:
                continue
            cv = float(cv) / max(slowdown, 1e-9)
            hvals = [float(r[m]) for r in hist
                     if isinstance(r.get(m), (int, float))]
            v = {"source": source, "workload": workload, "metric": m,
                 "current": round(cv, 3), "n_history": len(hvals)}
            if len(hvals) < min_history:
                v.update(ok=True, median=None, note="history<min")
            else:
                med = _median(hvals)
                v.update(median=round(med, 3),
                         floor=round(ratio * med, 3),
                         ok=(med <= 0) or (cv >= ratio * med))
            verdicts.append(v)
    return verdicts


# ------------------------------------------------------------ rendering

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals: Sequence[float], width: int = 24) -> str:
    vals = [float(v) for v in vals if isinstance(v, (int, float))]
    if not vals:
        return ""
    vals = vals[-width:]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[3] * len(vals)
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int((v - lo) / (hi - lo) * (len(_SPARK) - 1)))]
                   for v in vals)


def render_trajectory(window: Sequence[dict],
                      metrics: Sequence[str] = DRIFT_METRICS,
                      path: Optional[str] = None) -> str:
    """The `abpoa-tpu perf` table: one row per (source, workload) x
    metric with count, median, latest, and a sparkline of the series.
    `path` is the file the window was read from (default the ledger's)."""
    if not window:
        return "perf ledger: no records (run `abpoa_tpu_torch warm`)"
    lines = [f"perf ledger: {len(window)} records @ {path or ledger_path()}",
             f"{'source':<16}{'workload':<20}{'metric':<22}"
             f"{'n':>4}{'median':>10}{'latest':>10}  trend"]
    for (source, workload), recs in sorted(group_records(window).items()):
        verdicts = [r.get("verdict") for r in recs if r.get("verdict")]
        tag = ""
        if verdicts:
            n_fail = sum(1 for v in verdicts if v != "pass")
            tag = f"  [{len(verdicts) - n_fail}/{len(verdicts)} pass]"
        emitted = False
        for m in metrics:
            series = [float(r[m]) for r in recs
                      if isinstance(r.get(m), (int, float))]
            if not series:
                continue
            lines.append(
                f"{source:<16}{workload:<20.19}{m:<22}{len(series):>4}"
                f"{_human(_median(series)):>10}{_human(series[-1]):>10}"
                f"  {sparkline(series)}")
            emitted = True
        if emitted:
            if tag:
                lines[-1] += tag
        else:
            # metric-less group (warm records carry only build counts):
            # still one row, so the group is visible and its tag never
            # lands on another row
            lines.append(f"{source:<16}{workload:<20.19}{'-':<22}"
                         f"{len(recs):>4}{'-':>10}{'-':>10}{tag}")
    return "\n".join(lines)


def _human(v: float) -> str:
    for cut, suf in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= cut:
            return f"{v / cut:.2f}{suf}"
    return f"{v:.2f}"


def _resolve_record(window: Sequence[dict], sel: str) -> Optional[dict]:
    """`--diff A B` selector: an integer indexes the chronological window
    (negatives from the end), anything else picks the newest record whose
    source, workload, key, or git sha matches."""
    try:
        return window[int(sel)]
    except (ValueError, IndexError):
        pass
    for rec in reversed(window):
        if sel in (rec.get("source"), rec.get("workload"),
                   rec.get("key"), rec.get("git_sha")):
            return rec
    return None


def render_diff(window: Sequence[dict], a_sel: str, b_sel: str) -> str:
    a, b = _resolve_record(window, a_sel), _resolve_record(window, b_sel)
    if a is None or b is None:
        missing = a_sel if a is None else b_sel
        return f"perf --diff: no record matches {missing!r}"
    lines = [f"{'':<24}{_slug(a):>18}{_slug(b):>18}{'delta':>10}"]
    for m in ("reads_per_sec", "cell_updates_per_sec", "mfu", "occupancy",
              "compile_misses"):
        av, bv = a.get(m), b.get(m)
        lines.append(f"{m:<24}{_fmt(av):>18}{_fmt(bv):>18}"
                     f"{_delta(av, bv):>10}")
    for p in ("p50", "p95", "p99"):
        av = (a.get("read_wall_ms") or {}).get(p)
        bv = (b.get("read_wall_ms") or {}).get(p)
        lines.append(f"read_wall_ms.{p:<11}{_fmt(av):>18}{_fmt(bv):>18}"
                     f"{_delta(av, bv):>10}")
    return "\n".join(lines)


def _slug(rec: dict) -> str:
    s = f"{rec.get('source')}:{rec.get('workload') or '-'}"
    return s[-18:]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v) if v is not None else "-"


def _delta(a, b) -> str:
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)) \
            or not a:
        return "-"
    return f"{(b - a) / abs(a) * 100:+.1f}%"
