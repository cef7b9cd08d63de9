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
rendered as `args.rid`/`args.attempt` in the export. The port's CLI
routes run no requests; the context is the hook a server tags its
requests with.
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


class Tracer:
    """Bounded ring buffer of trace events on a monotonic clock."""

    __slots__ = ("enabled", "capacity", "t0", "_buf", "_n", "_tids",
                 "_lock")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.enabled = False
        self.capacity = capacity
        # the exporter and a driver's threads may record at once: the
        # ring's counter and overwrite must not race
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self._buf: list = []
        self._n = 0          # total events ever added (>= len(_buf))
        self._tids: dict = {}  # thread ident -> dense tid

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
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TRACER.add_span(name, cat, t0, time.perf_counter() - t0, args)


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


def span_totals(cat: Optional[str] = None) -> dict:
    """Per-name wall sums over recorded spans (tests reconcile these with
    the RunReport phase timers)."""
    tot: dict = {}
    for kind, name, c, _ts, dur, _tid, _args, _req in _TRACER.events():
        if kind == _KIND_SPAN and (cat is None or c == cat):
            tot[name] = tot.get(name, 0.0) + dur
    return tot
