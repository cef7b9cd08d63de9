"""Counterpart of `abpoa_tpu/obs/trace.py` (host spans only).

Event-level span tracer -> Chrome trace-event JSON (Perfetto-viewable).

The RunReport (report.py) answers "where did the time go" in aggregate;
this module answers "when": a timeline of the same phase names plus the
routes' own spans (`fused_chunk`, `lockstep_group`, `set:i`, `dp_chunk`,
`dp:<device>`, `read:i`). Armed by CLI `--trace FILE` (or `enable()` from
the API), exported in the Chrome trace-event format, which Perfetto
(ui.perfetto.dev) and chrome://tracing load directly.

Spans are host spans: a span around a kernel launch measures its enqueue,
so the routes close theirs where they already sync with the card.

Overhead contract: disabled (the default) every hook is one attribute
check; enabled, a span is two `perf_counter()` calls and one ring-buffer
store, with no device sync. The ring buffer is bounded (default 65536
events): a long run overwrites its oldest events and reports the drop
count in the export metadata. `RunReport.phase()` forwards its own
(t0, dt) measurements here, so phase spans and phase timers are the same
numbers.

Request context: every event optionally carries a request tag
``(rid, attempt)`` taken from a thread-local set by `request_ctx()`,
rendered as `args.rid`/`args.attempt` in the export. The server
(`serve/server.py`) mints the id at ingress and, with `--trace-dir`,
registers it in the request index (`begin_request`) so that the
request's events are also kept on a list of their own, which
`export_request_trace` writes as one Chrome trace (`req-<rid>.trace.json`,
at most ABPOA_TPU_TRACE_DIR_MAX files, default 512). Sampling
(ABPOA_TPU_TRACE_SAMPLE, default 1.0) is a hash of the id, so every
process that sees an id reaches the same verdict. The ring's store, the
tid table and the index take one lock: the server's threads record at
once.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Iterator, Optional, Tuple

DEFAULT_CAPACITY = 65536

# event tuples: (kind, name, cat, t_start_s, dur_s, tid, args, req)
# kind: "X" complete span | "i" instant; req: None | (rid, attempt)
_KIND_SPAN = "X"
_KIND_INSTANT = "i"

# thread-local request context: (rid, attempt) tagged onto every event
_CTX = threading.local()


def new_request_id() -> str:
    """Mint a request id (12 hex chars). Random, not sequential: ids from
    concurrent or restarted processes must not collide in a shared
    archive."""
    return os.urandom(6).hex()


# the flight recorder (obs/flight.py) span() tells of entries and exits,
# so that a dump names the span that was open; None when none is installed
_FLIGHT = None


def current_request() -> Optional[Tuple[str, int]]:
    return getattr(_CTX, "req", None)


@contextlib.contextmanager
def request_ctx(rid: Optional[str], attempt: int = 0) -> Iterator[None]:
    """Tag every event recorded by this thread with (rid, attempt); a
    retried request's attempts stay apart by `attempt`."""
    if not rid:
        yield
        return
    prev = getattr(_CTX, "req", None)
    _CTX.req = (rid, int(attempt))
    try:
        yield
    finally:
        _CTX.req = prev


def sample_rate() -> float:
    try:
        return float(os.environ.get("ABPOA_TPU_TRACE_SAMPLE", "1") or 1.0)
    except ValueError:
        return 1.0


def sampled(rid: str) -> bool:
    """Is request `rid` traced? A hash of the id against
    ABPOA_TPU_TRACE_SAMPLE: the same verdict every time, in every
    process."""
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0 or not rid:
        return False
    try:
        return (int(rid, 16) % 10_000) < rate * 10_000
    except ValueError:
        return True


def set_flight(rec) -> None:
    """Install (or clear, with None) the flight recorder span() tells."""
    global _FLIGHT
    _FLIGHT = rec


# a request's indexed events are cut here (the ring's own cap still holds
# for the whole timeline); the cut is counted in the export's metadata
REQUEST_INDEX_CAP = 4096


class Tracer:
    """Bounded ring buffer of trace events on a monotonic clock."""

    __slots__ = ("enabled", "capacity", "t0", "_buf", "_n", "_tids",
                 "index_requests", "_req_idx", "_req_drop", "_lock")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.enabled = False
        self.capacity = capacity
        # the request index (serve --trace-dir): a registered id's events
        # also go to a list of its own, so its export does not scan the
        # ring
        self.index_requests = False
        # the server's threads record at once: the ring's counter and
        # overwrite and the index must not race
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self._buf: list = []
        self._n = 0          # total events ever added (>= len(_buf))
        self._tids: dict = {}  # thread ident -> dense tid
        self._req_idx: dict = {}   # rid -> [events], registered ids only
        self._req_drop: dict = {}  # rid -> events cut at REQUEST_INDEX_CAP

    # ------------------------------------------------------------- recording
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[ident] = tid
        return tid

    def _store(self, ev: tuple) -> None:
        with self._lock:
            if self._n < self.capacity:
                self._buf.append(ev)
            else:
                self._buf[self._n % self.capacity] = ev  # overwrite oldest
            self._n += 1
            if self.index_requests and ev[7] is not None:
                lst = self._req_idx.get(ev[7][0])
                if lst is not None:
                    if len(lst) < REQUEST_INDEX_CAP:
                        lst.append(ev)
                    else:
                        rid = ev[7][0]
                        self._req_drop[rid] = self._req_drop.get(rid, 0) + 1

    # ------------------------------------------------------------- index
    def begin_request(self, rid: str) -> None:
        """Register `rid` for indexed collection, before the request is
        visible to a worker (else a fast request's slice could be taken
        before it is registered, and the entry would never be taken)."""
        if self.index_requests and rid:
            with self._lock:
                self._req_idx[rid] = []

    def take_request(self, rid: str) -> Optional[Tuple[list, int]]:
        """Remove and return a registered id's (events, events cut), or
        None; every registered id is taken once, at its terminal status."""
        with self._lock:
            lst = self._req_idx.pop(rid, None)
            dropped = self._req_drop.pop(rid, 0)
            return None if lst is None else (lst, dropped)

    def add_span(self, name: str, cat: str, t_start: float, dur: float,
                 args: Optional[dict] = None,
                 req: Optional[Tuple[str, int]] = None) -> None:
        """Record a completed span from caller-held timestamps (the path
        RunReport.phase uses, so span == timer to the last bit). `req`
        overrides the thread-local request tag."""
        self._store((_KIND_SPAN, name, cat, t_start, dur, self._tid(),
                     args, req if req is not None else current_request()))

    def add_instant(self, name: str, cat: str,
                    args: Optional[dict] = None) -> None:
        self._store((_KIND_INSTANT, name, cat, time.perf_counter(), 0.0,
                     self._tid(), args, current_request()))

    def add_foreign(self, kind: str, name: str, cat: str, t_start: float,
                    dur: float, tid: int, args: Optional[dict],
                    req: Optional[Tuple[str, int]]) -> None:
        """Add an event on a track of its own (`tid`), timed by the caller
        on this tracer's clock: the rounds timeline's tracks."""
        self._store((kind, name, cat, t_start, dur, tid, args, req))

    # ------------------------------------------------------------- reading
    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def events(self) -> list:
        """Events oldest-first (unwrapping the ring); a consistent
        snapshot under the writer lock."""
        with self._lock:
            if self._n <= self.capacity:
                return list(self._buf)
            k = self._n % self.capacity
            return self._buf[k:] + self._buf[:k]

    def tail(self, k: int) -> list:
        """The newest `k` events, oldest first, without unwrapping the
        whole ring (the flight recorder reads it every heartbeat)."""
        with self._lock:
            if self._n <= self.capacity:
                return self._buf[-k:]
            i = self._n % self.capacity   # oldest slot, the wrap point
            if k <= i:
                return self._buf[i - k:i]
            return self._buf[-(k - i):] + self._buf[:i]

    def events_for(self, rid: str) -> list:
        """Every ring event tagged with request id `rid`, oldest first."""
        return [e for e in self.events() if e[7] is not None
                and e[7][0] == rid]


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enable(capacity: Optional[int] = None) -> None:
    """Arm tracing (resets the buffer and the timeline origin)."""
    if capacity:
        _TRACER.capacity = int(capacity)
    _TRACER.reset()
    _TRACER.enabled = True


def disable() -> None:
    _TRACER.enabled = False


def enabled() -> bool:
    return _TRACER.enabled


@contextlib.contextmanager
def span(name: str, cat: str = "run",
         args: Optional[dict] = None) -> Iterator[None]:
    """Timed hierarchical span; nesting is expressed by time containment
    (how the Chrome trace format builds its flame graph). Disabled: one
    attribute check and a bare yield."""
    if not _TRACER.enabled:
        yield
        return
    fl = _FLIGHT
    t0 = time.perf_counter()
    if fl is not None:
        fl.push_open(name, cat, t0, args)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TRACER.add_span(name, cat, t0, dt, args)
        if fl is not None:
            fl.pop_open(name, cat, t0, dt, args)


def instant(name: str, cat: str = "run", args: Optional[dict] = None) -> None:
    """Zero-duration marker (growth events, fallbacks, errors)."""
    if _TRACER.enabled:
        _TRACER.add_instant(name, cat, args)


def add_span(name: str, cat: str, t_start: float, dur: float,
             args: Optional[dict] = None,
             req: Optional[Tuple[str, int]] = None) -> None:
    """Record a span from caller-held timestamps (RunReport.phase)."""
    if _TRACER.enabled:
        _TRACER.add_span(name, cat, t_start, dur, args, req=req)


# --------------------------------------------------------------------------- #
# Chrome trace-event export                                                   #
# --------------------------------------------------------------------------- #

def to_chrome_trace(extra_meta: Optional[dict] = None,
                    events: Optional[list] = None) -> dict:
    """The trace as a Chrome trace-event JSON object: `ph:"X"` complete
    events with microsecond ts/dur on a run-relative timeline; metadata
    records process naming and the drop count. `events` narrows the
    export to a subset; request tags render as `args.rid`/`args.attempt`
    so Perfetto's args panel can follow one request across threads."""
    t = _TRACER
    pid = os.getpid()
    out = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "abpoa-tpu"}},
    ]
    meta = {"dropped_events": t.dropped, "capacity": t.capacity}
    if extra_meta:
        meta.update(extra_meta)
    out.append({"name": "trace_meta", "ph": "M", "pid": pid, "tid": 0,
                "args": meta})
    t0 = t.t0
    for kind, name, cat, ts, dur, tid, args, req in (
            t.events() if events is None else events):
        ev = {"name": name, "cat": cat, "ph": kind,
              "ts": round((ts - t0) * 1e6, 3), "pid": pid, "tid": tid}
        if kind == _KIND_SPAN:
            ev["dur"] = round(dur * 1e6, 3)
        else:
            ev["s"] = "t"  # thread-scoped instant
        if args or req:
            a = dict(args) if args else {}
            if req:
                a["rid"] = req[0]
                if req[1]:
                    a["attempt"] = req[1]
            ev["args"] = a
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, fp=None,
                        extra_meta: Optional[dict] = None,
                        events: Optional[list] = None) -> None:
    """`--trace FILE` sink ('-' = stdout, or `fp` when stdout is taken)."""
    text = json.dumps(to_chrome_trace(extra_meta, events=events))
    if path == "-":
        (fp or sys.stdout).write(text + "\n")
    else:
        with open(path, "w") as out:
            out.write(text + "\n")


# the directory listing is the bound's expensive part, so it runs every
# 32 exports (the bound is then max_files + 32)
_EXPORTS = {"n": 0}


def export_request_trace(dirpath: str, rid: str,
                         extra_meta: Optional[dict] = None,
                         max_files: Optional[int] = None,
                         events: Optional[list] = None) -> Optional[str]:
    """Write one request's events as `req-<rid>.trace.json` under
    `dirpath` (serve's --trace-dir), deleting the oldest trace files past
    ABPOA_TPU_TRACE_DIR_MAX (512). `events` is the request's indexed slice
    (default: a scan of the ring). Returns the path, or None where the
    request recorded nothing or the directory cannot be written: tracing
    never fails the request."""
    evs = events if events is not None else _TRACER.events_for(rid)
    if not evs:
        return None
    if max_files is None:
        max_files = int(os.environ.get("ABPOA_TPU_TRACE_DIR_MAX", "512"))
    path = os.path.join(dirpath, f"req-{rid}.trace.json")
    try:
        os.makedirs(dirpath, exist_ok=True)
        meta = {"request_id": rid, "events": len(evs)}
        if extra_meta:
            meta.update(extra_meta)
        export_chrome_trace(path, extra_meta=meta, events=evs)
        _EXPORTS["n"] += 1
        if _EXPORTS["n"] % 32 == 0 or max_files < 32:
            _prune_trace_dir(dirpath, max_files)
    except OSError:
        return None
    return path


def _prune_trace_dir(dirpath: str, max_files: int) -> None:
    try:
        names = [n for n in os.listdir(dirpath)
                 if n.startswith("req-") and n.endswith(".trace.json")]
        if len(names) <= max_files:
            return
        full = sorted((os.path.getmtime(os.path.join(dirpath, n)), n)
                      for n in names)
        for _mt, n in full[:len(names) - max_files]:
            os.unlink(os.path.join(dirpath, n))
    except OSError:
        pass


def span_totals(cat: Optional[str] = None) -> dict:
    """Per-name wall sums over recorded spans (tests reconcile these with
    the RunReport phase timers)."""
    tot: dict = {}
    for kind, name, c, _ts, dur, _tid, _args, _req in _TRACER.events():
        if kind == _KIND_SPAN and (cat is None or c == cat):
            tot[name] = tot.get(name, 0.0) + dur
    return tot
