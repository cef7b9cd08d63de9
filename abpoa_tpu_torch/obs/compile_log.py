"""Build and load log: the port's counterpart of the compile log.

The JAX package's `abpoa_tpu/obs/compile_log.py` records every XLA compile
of its jitted entry points. The port compiles nothing at run time: its one
equivalent is the kernel library (`kernels/build.py`), which nvcc builds
from `csrc/` when no library of the sources' hash is on disk (a miss) and
which ctypes then loads (a hit when the build was already there). Each
load is one record {fn, bucket, cache_hit, wall_s, nvcc_build_s, path} in
the run's log (the report's `compiles` key), one `compile.misses` or
`compile.hits` count and, for a build, a `compile:<fn>` trace span.
`nvcc_build_s` stands where JAX's records carry `xla_compile_s`.
"""
from __future__ import annotations

import os
import time

RECORDS_CAP = 512  # per-run record bound; counters keep exact totals

# run-scoped (reset by report.start_run via reset_run)
_RECORDS: list = []
_DROPPED = 0


def reset_run() -> None:
    global _RECORDS, _DROPPED
    _RECORDS = []
    _DROPPED = 0


def run_records() -> list:
    """This run's build and load records (the report's `compiles` key)."""
    return list(_RECORDS)


def run_dropped() -> int:
    return _DROPPED


def record_load(name: str, path: str, built: bool, build_s: float,
                t0: float) -> None:
    """One load of a kernel library that started at perf_counter `t0`:
    `built` when nvcc had to build it first (a miss), taking `build_s`."""
    from .report import count
    dt = time.perf_counter() - t0
    rec = {"fn": name, "bucket": {"library": os.path.basename(path)},
           "cache_hit": not built, "wall_s": round(dt, 6),
           "nvcc_build_s": round(build_s, 6) if built else None}
    if built:
        count("compile.misses")
        from . import trace
        trace.add_span("compile:" + name, "compile", t0, dt,
                       args=dict(rec["bucket"]))
    else:
        count("compile.hits")
    global _DROPPED
    if len(_RECORDS) < RECORDS_CAP:
        _RECORDS.append(rec)
    else:
        _DROPPED += 1
