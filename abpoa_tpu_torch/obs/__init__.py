"""Run telemetry of the port: phase timers, counters, the versioned JSON
run report, the MFU model, per-read latency records, the span tracer
(Chrome trace-event export), the kernel library's build and load log,
`torch.profiler` capture (`--profile-dir`), the per-round timeline, the
Prometheus metric registry and exporters, the cross-run report archive,
the perf ledger and the `perf`/`slo`/`top` readers.

Counterpart of `abpoa_tpu/obs/` (same names, schema and families), with
`compile_log` (the kernel library's build and load log) in place of
`compile_watch`: the port has no jit entry point to watch. The server's
parts are here: the request sampling, the request index and the
per-request trace export (`trace`), the flight recorder's schema, reader
and recorder (`flight`, whose writers are the pool's) and `why`, the
postmortem of one request. Every hook is host-side bookkeeping at points
the routes already pass: no host sync and no kernel launch is added for
it.
"""
from . import archive, compile_log, flight, ledger, metrics, rounds, trace
from .capture import device_capture, profile_dir, set_profile_dir
from .report import (SCHEMA, SCHEMA_KEYS, SCHEMA_VERSION, RunReport, count,
                     finalize_report, note_device, observe, phase, record_dp,
                     record_fault, record_read, render_report,
                     render_report_diff, report, start_run,
                     summary, write_report)
from .trace import (export_chrome_trace, export_request_trace, instant,
                    new_request_id, request_ctx, sampled, span, span_totals,
                    tracer)
from .trace import disable as trace_disable
from .trace import enable as trace_enable
from .trace import enabled as trace_enabled

__all__ = [
    "SCHEMA", "SCHEMA_KEYS", "SCHEMA_VERSION", "RunReport",
    "count", "observe", "phase", "record_dp", "record_fault", "record_read",
    "report", "note_device",
    "start_run", "finalize_report", "write_report", "summary",
    "render_report", "render_report_diff",
    "device_capture", "profile_dir", "set_profile_dir",
    "trace", "trace_enable", "trace_disable", "trace_enabled",
    "span", "instant", "span_totals", "export_chrome_trace", "tracer",
    "new_request_id", "request_ctx", "sampled", "export_request_trace",
    "compile_log", "archive", "flight", "ledger", "metrics", "rounds",
]
