"""Run-report archive: the cross-run memory behind `abpoa-tpu slo`.

Counterpart of `abpoa_tpu/obs/archive.py`, with the same record shape and
environment variables (`ABPOA_TPU_ARCHIVE`, `ABPOA_TPU_ARCHIVE_DIR`); its
default root is `~/.cache/abpoa_tpu_torch/reports`, so the port's records
never mix with the JAX package's.

Each CLI run appends one compact JSONL record (the SLO-relevant slice of
its RunReport: wall, read percentiles, fallback/compile/fault counts) to
``reports.jsonl`` there, and the server appends one record a request
through the same `append_record`; that turns per-run telemetry into
questions over many runs: "what was our fallback rate across the last 500 runs",
"has p99 drifted this week".

Every record is written as ONE ``os.write`` on an ``O_APPEND``
descriptor, so concurrent appenders' lines never interleave; rotation
runs under a process lock with a re-stat inside it.

Growth is bounded: past MAX_BYTES (8 MB, ~20k records) the live file
rotates to ``reports.jsonl.1`` (one rotated generation kept).
``ABPOA_TPU_ARCHIVE=0`` disables archiving; ``ABPOA_TPU_ARCHIVE_DIR``
redirects it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

ARCHIVE_FILE = "reports.jsonl"
MAX_BYTES = 8_000_000

# serializes rotation against in-process writers; the append itself needs
# no lock (single O_APPEND write)
_ROTATE_LOCK = threading.Lock()


def archive_enabled() -> bool:
    return os.environ.get("ABPOA_TPU_ARCHIVE", "1") not in ("0", "off")


def archive_dir() -> str:
    d = os.environ.get("ABPOA_TPU_ARCHIVE_DIR")
    if d:
        return d
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "abpoa_tpu_torch", "reports")


def archive_path() -> str:
    return os.path.join(archive_dir(), ARCHIVE_FILE)


def summarize_report(rep: dict, label: str = "",
                     device: str = "") -> dict:
    """One archive record from a finalized run report: the fields the SLO
    objectives evaluate, nothing that grows with the run."""
    reads = rep.get("reads") or {}
    comp = rep.get("compiles") or {}
    faults = rep.get("faults") or {}
    counters = rep.get("counters") or {}
    mfu = rep.get("mfu") or {}
    n_reads = reads.get("count") or 0
    total = rep.get("total_wall_s") or 0.0
    fallback_reads = sum((reads.get("fallbacks") or {}).values())
    return {
        "ts": rep.get("created") or time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                  time.gmtime()),
        "schema_version": rep.get("schema_version"),
        "label": label,
        "device": device,
        "total_wall_s": total,
        "reads": n_reads,
        "reads_per_sec": round(n_reads / total, 3) if total else None,
        "read_wall_ms": reads.get("wall_ms"),
        "fallback_reads": fallback_reads,
        "compile_hits": comp.get("hits", 0),
        "compile_misses": comp.get("misses", 0),
        "faults": faults.get("count", 0),
        "quarantined": counters.get("quarantine.sets", 0),
        "degraded": sorted(rep.get("degraded") or {}),
        "dp_cells": counters.get("dp.cells", 0),
        "cell_updates_per_sec": mfu.get("cell_updates_per_sec"),
        "mfu": mfu.get("mfu"),
    }


def append_record(rec: dict) -> Optional[str]:
    """Append one archive record (summarize_report's shape). Thread- and
    process-safe: the line lands
    as a single O_APPEND write, so concurrent appenders can never
    interleave bytes mid-record. Returns the archive path (None when
    archiving is disabled or the directory is unwritable — archive
    failure must never fail the work that produced the record)."""
    if not archive_enabled():
        return None
    path = archive_path()
    data = (json.dumps(rec) + "\n").encode()
    try:
        os.makedirs(archive_dir(), exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        _rotate_if_needed(path)
    except OSError:
        return None
    return path


def append_report(rep: dict, label: str = "", device: str = "") -> Optional[str]:
    """Archive one finalized run report (the CLI's per-run record)."""
    if not archive_enabled():
        return None
    return append_record(summarize_report(rep, label=label, device=device))


def _rotate_if_needed(path: str) -> None:
    # the lock serializes in-process rotations; the re-stat inside it
    # means only the first thread past the limit rotates
    with _ROTATE_LOCK:
        try:
            if os.path.getsize(path) <= MAX_BYTES:
                return
            os.replace(path, path + ".1")  # drops any previous .1
        except OSError:
            pass


def read_window(n: int, path: Optional[str] = None) -> List[dict]:
    """The newest `n` archive records, oldest-first (rotated generation
    included so a window survives a rotation boundary). Unparseable lines
    (a crash mid-append) are skipped, never fatal."""
    path = path or archive_path()
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


def find_request(rid: str, window: int = 0,
                 path: Optional[str] = None) -> Optional[dict]:
    """The newest archive record carrying request id `rid` (the server
    writes one a terminal request; its `trace_file`/`dump_file` name the
    request's Chrome trace and flight dump). `why` resolves ids here; a
    `label` (`req-N`) matches too."""
    for rec in reversed(read_window(window, path=path)):
        if rec.get("request_id") == rid or rec.get("label") == rid:
            return rec
    return None
