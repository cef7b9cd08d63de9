"""Worker flight recorder: the black box a SIGKILL cannot erase.

Counterpart of `abpoa_tpu/obs/flight.py`, whole: the dump's schema, its
reader (`why`) and the recorder. Its writers are the process pool's (a
worker installs the recorder and the supervisor harvests a dead worker's
dump), which the port has not yet; the server of this package calls none
of it, and `why` reads the dumps.

A supervisor can kill a worker at any instant: a deadline, an RSS
breach, a fault. Everything the worker knew then (the open span, the last
dispatch and its shape, the RSS trend, the faults it absorbed) dies with
the process unless it is already on disk. The recorder keeps a bounded
record in memory and persists it by atomic rename at every heartbeat
(~1 s), so the freshest dump a dead worker leaves is at most one beat
stale.

Layout on disk (``ABPOA_TPU_FLIGHT_DIR``, default
``~/.cache/abpoa_tpu_torch/flight``):

- ``worker-<pid>.json``   the live dump, rewritten atomically each beat
- ``dump-<rid>-a<N>-p<pid>.json``  a harvested dump: the supervisor
  renames the live dump of a worker it killed (or saw die) and adds the
  cause it observed (the `harvest` block), the file `why` renders and
  the archive record points at.

Cost: a span's entry and exit are two list operations on a bounded stack;
the JSON is written on the heartbeat thread, never on the job's path.
Outside a worker nothing is installed and `trace.span` pays one `is None`
check.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

SCHEMA = "abpoa-tpu-flight"
SCHEMA_VERSION = 1

# bounded tails: recent closed spans / faults / RSS samples kept in a dump
SPAN_KEEP = 48
RSS_KEEP = 64

# span categories that count as "a dispatch" for last_dispatch attribution
_DISPATCH_CATS = ("dp", "fused", "compile")


def flight_dir() -> str:
    d = os.environ.get("ABPOA_TPU_FLIGHT_DIR")
    if d:
        return d
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "abpoa_tpu_torch", "flight")


def worker_dump_path(pid: int, dirpath: Optional[str] = None) -> str:
    return os.path.join(dirpath or flight_dir(), f"worker-{pid}.json")


class FlightRecorder:
    """One worker process's always-on bounded record + atomic persister."""

    def __init__(self, path: str, label: str = "") -> None:
        self.path = path
        self.label = label
        self.pid = os.getpid()
        self.t0 = time.perf_counter()
        self.beats = 0
        self.job: Optional[dict] = None     # current job context
        self.open_spans: list = []          # stack of (name, cat, t0, args)
        self.last_dispatch: Optional[dict] = None
        self.rss: list = []                 # [(t_s, bytes)] bounded tail
        self._lock = threading.Lock()       # job thread vs heartbeat thread

    # ----------------------------------------------------------- recording
    def push_open(self, name: str, cat: str, t0: float,
                  args: Optional[dict]) -> None:
        self.open_spans.append((name, cat, t0, args))

    def pop_open(self, name: str, cat: str, t0: float, dur: float,
                 args: Optional[dict]) -> None:
        if self.open_spans and self.open_spans[-1][0] == name:
            self.open_spans.pop()
        if cat in _DISPATCH_CATS:
            self.last_dispatch = {"name": name, "cat": cat,
                                  "t_s": round(t0 - self.t0, 4),
                                  "dur_s": round(dur, 6),
                                  "args": dict(args) if args else None}

    def begin_job(self, rid: str, attempt: int, kind: str,
                  label: str = "") -> None:
        """New job context; persisted IMMEDIATELY so even a kill that
        lands before the first heartbeat leaves a dump naming the job."""
        with self._lock:
            self.job = {"rid": rid or None, "attempt": int(attempt),
                        "kind": kind, "label": label,
                        "t_start_s": round(time.perf_counter() - self.t0, 4),
                        "status": "running"}
        self.persist()

    def end_job(self, status: str = "done") -> None:
        with self._lock:
            if self.job is not None:
                self.job["status"] = status

    def beat(self, rss_bytes: int) -> None:
        """One heartbeat: append the RSS sample, persist the dump."""
        self.beats += 1
        self.rss.append((round(time.perf_counter() - self.t0, 3),
                         int(rss_bytes)))
        if len(self.rss) > RSS_KEEP:
            del self.rss[:len(self.rss) - RSS_KEEP]
        self.persist()

    # ----------------------------------------------------------- rendering
    def snapshot(self) -> dict:
        # note: the package attribute `report` is the accessor FUNCTION
        # (obs/__init__ re-exports it), so import from the module itself
        from .report import report as _get_report
        from . import trace as _trace
        t_now = time.perf_counter()
        spans = []
        for ev in _trace.tracer().tail(SPAN_KEEP):
            kind, name, cat, ts, dur, _tid, args, req = ev
            if kind != "X":
                continue
            rec = {"name": name, "cat": cat,
                   "t_s": round(ts - self.t0, 4), "dur_s": round(dur, 6)}
            if args:
                rec["args"] = args
            if req:
                rec["rid"], rec["attempt"] = req[0], req[1]
            spans.append(rec)
        with self._lock:
            job = dict(self.job) if self.job else None
            open_spans = [{"name": n, "cat": c,
                           "t_s": round(t0 - self.t0, 4),
                           "elapsed_s": round(t_now - t0, 4),
                           "args": dict(a) if a else None}
                          for n, c, t0, a in self.open_spans]
        if job is not None and job.get("status") == "running":
            job["elapsed_s"] = round(
                t_now - self.t0 - job.get("t_start_s", 0.0), 4)
        rep = _get_report()
        return {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "pid": self.pid,
            "label": self.label,
            "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "uptime_s": round(t_now - self.t0, 3),
            "beats": self.beats,
            "job": job,
            "open_spans": open_spans,
            "last_dispatch": self.last_dispatch,
            "recent_spans": spans,
            "faults": list(rep.faults[-16:]),
            "rss": list(self.rss),
        }

    def persist(self) -> None:
        """Atomic-rename write; failure is swallowed — the recorder must
        never fail the work it records."""
        try:
            tmp = f"{self.path}.tmp.{self.pid}"
            with open(tmp, "w") as fp:
                json.dump(self.snapshot(), fp)
            os.replace(tmp, self.path)
        except (OSError, ValueError, TypeError):
            pass


# --------------------------------------------------------------------------- #
# module registry (worker side)                                               #
# --------------------------------------------------------------------------- #

_REC: Optional[FlightRecorder] = None


def install(label: str = "", path: Optional[str] = None) -> FlightRecorder:
    """Arm the flight recorder for THIS process (pool worker_init). The
    span tracer must already be enabled — the recorder's recent-span tail
    reads the tracer ring."""
    global _REC
    from . import trace as _trace
    if path is None:
        path = worker_dump_path(os.getpid())
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    except OSError:
        pass
    _REC = FlightRecorder(path, label=label)
    _trace.set_flight(_REC)
    return _REC


def uninstall() -> None:
    global _REC
    from . import trace as _trace
    _trace.set_flight(None)
    _REC = None


def shutdown() -> None:
    """Clean worker exit: remove the live dump (nothing died — a stale
    `worker-<pid>.json` would otherwise accumulate per pid and could be
    mis-harvested by a future worker reusing the pid)."""
    global _REC
    rec = _REC
    uninstall()
    if rec is not None:
        try:
            os.unlink(rec.path)
        except OSError:
            pass


def recorder() -> Optional[FlightRecorder]:
    return _REC


def begin_job(rid: str, attempt: int, kind: str, label: str = "") -> None:
    if _REC is not None:
        _REC.begin_job(rid, attempt, kind, label)


def end_job(status: str = "done") -> None:
    if _REC is not None:
        _REC.end_job(status)


def beat(rss_bytes: int) -> None:
    if _REC is not None:
        _REC.beat(rss_bytes)


# --------------------------------------------------------------------------- #
# harvest (supervisor side)                                                   #
# --------------------------------------------------------------------------- #

def harvest(pid: int, reason: str, rid: str = "", attempt: int = 0,
            detail: str = "", dirpath: Optional[str] = None) -> Optional[str]:
    """Collect a dead worker's live dump: read ``worker-<pid>.json``,
    enrich it with the parent-observed cause of death (`harvest` block —
    the worker cannot record its own SIGKILL), and move it to a stable
    ``dump-…`` name the archive record can reference. Returns the dump
    path, or None when the worker never persisted (died before its first
    beat with no job begun, or the dir is unwritable)."""
    dirpath = dirpath or flight_dir()
    src = worker_dump_path(pid, dirpath)
    try:
        with open(src) as fp:
            dump = json.load(fp)
    except (OSError, ValueError):
        return None
    dump["harvest"] = {
        "reason": reason,
        "detail": detail[:300],
        "request_id": rid or (dump.get("job") or {}).get("rid"),
        "attempt": attempt or (dump.get("job") or {}).get("attempt"),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if dump.get("job") and dump["job"].get("status") == "running":
        dump["job"]["status"] = f"died:{reason}"
    tag = dump["harvest"]["request_id"] or "nojob"
    dest = os.path.join(
        dirpath, f"dump-{tag}-a{dump['harvest']['attempt'] or 0}-p{pid}.json")
    try:
        with open(dest, "w") as fp:
            json.dump(dump, fp)
        os.unlink(src)
    except OSError:
        return None
    # bounded like --trace-dir: deaths are rare enough that the listdir
    # can run on every harvest (no amortization needed)
    _prune_dumps(dirpath)
    return dest


def max_dumps() -> int:
    return int(os.environ.get("ABPOA_TPU_FLIGHT_DIR_MAX", "256"))


def _prune_dumps(dirpath: str) -> None:
    """Keep only the newest `max_dumps()` harvested dumps — a multi-day
    soak under recurring kill conditions must not fill the disk with one
    permanent file per death."""
    try:
        names = [n for n in os.listdir(dirpath)
                 if n.startswith("dump-") and n.endswith(".json")]
        keep = max_dumps()
        if len(names) <= keep:
            return
        full = sorted((os.path.getmtime(os.path.join(dirpath, n)), n)
                      for n in names)
        for _mt, n in full[:len(names) - keep]:
            os.unlink(os.path.join(dirpath, n))
    except OSError:
        pass
