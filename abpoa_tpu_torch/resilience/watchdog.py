"""Dispatch watchdog: a wall-clock deadline on device dispatches.

Counterpart of `abpoa_tpu/resilience/watchdog.py`. A kernel can wedge the
card mid-run; the dispatch then runs in a supervised worker thread that is
abandoned past its deadline (a thread cannot be killed, but a call blocked
in the CUDA driver releases the GIL, so the main thread stays live: on the
card the run then stops with `resilience.CardFailure` and makes no further
CUDA call; on `cpu` it goes on down the ladder).

The worker runs with the caller's thread-local state: torch's current
device and current stream (the kernels' wrappers, `fused_loop.timing`'s
CUDA events and the mesh routes' per-card loop see the streams they would
see on the caller's thread) and the tracer's request context.

Host dispatches (`native`, `plain`) never come here: they cannot hang, and
a host run must not pay a thread a read.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Callable


class DispatchTimeout(RuntimeError):
    """A supervised dispatch gave no result within its deadline."""


# abandoned workers (deadline expired, dispatch still running). At exit the
# stragglers get a bounded grace before the interpreter tears down under
# them; a wedged one is then left for real, after the output is written.
_ABANDONED: list = []
_EXIT_GRACE_S = 15.0
# abandoned-thread count past which the leak warning fires
ABANDON_MAX = 8
_WARNED_LEAK = False
_GAUGE = ("abpoa_watchdog_abandoned_threads",
          "Live abandoned watchdog worker threads (deadline expired, "
          "dispatch still running)")


def abandoned_count() -> int:
    """Live abandoned watchdog threads (finished stragglers drop out)."""
    return sum(1 for t in _ABANDONED if t.is_alive())


def _publish_abandoned(reg) -> None:
    """Republished at each exposition, so that the gauge falls back when
    stragglers finish."""
    reg.gauge(*_GAUGE).set(abandoned_count())


def _note_abandoned(t: threading.Thread) -> None:
    global _WARNED_LEAK
    _ABANDONED.append(t)
    n = abandoned_count()
    from ..obs import count, metrics
    metrics.register_global_collector(_publish_abandoned)
    metrics.registry().gauge(*_GAUGE).set(n)
    if n > ABANDON_MAX and not _WARNED_LEAK:
        _WARNED_LEAK = True
        count("watchdog.abandon_warnings")
        print(f"Warning: {n} abandoned watchdog threads exceed "
              f"{ABANDON_MAX}: the process is leaking wedged dispatch "
              "threads.", file=sys.stderr)


def _drain_abandoned() -> None:
    import time
    deadline = time.monotonic() + _EXIT_GRACE_S
    for t in _ABANDONED:
        t.join(max(0.0, deadline - time.monotonic()))


# at threading shutdown, before the atexit handlers of the libraries the
# worker may still be inside (torch's thread pools)
threading._register_atexit(_drain_abandoned)


def deadline_seconds() -> float:
    """The per-dispatch deadline (ABPOA_TPU_WATCHDOG_S, default 900 s: the
    fused route is one dispatch a set, and a deadline must never fire on
    honest work). 0 turns supervision off."""
    return float(os.environ.get("ABPOA_TPU_WATCHDOG_S", "900"))


def supervision_needed(backend: str) -> bool:
    """Does a dispatch on `backend` run in the supervised worker? Always
    on `cuda`; on `cpu` only where an injector is armed or
    ABPOA_TPU_WATCHDOG_FORCE=1 (as the JAX package treats jax on XLA:CPU:
    a CPU dispatch cannot wedge a card); never on the host rungs."""
    if backend == "cuda":
        return True
    if backend != "cpu":
        return False
    if os.environ.get("ABPOA_TPU_WATCHDOG_FORCE") == "1":
        return True
    from .inject import any_armed
    return any_armed()


def _caller_context() -> Callable[[], contextlib.ExitStack]:
    """What the worker must enter to run as the caller's thread would:
    torch's current CUDA device and stream (thread-local), and the
    tracer's request context (thread-local too). No CUDA call is made
    where CUDA is not initialized."""
    import torch
    from ..obs import trace
    req = trace.current_request()
    dev = stream = None
    if torch.cuda.is_initialized():
        dev = torch.cuda.current_device()
        stream = torch.cuda.current_stream(dev)

    def enter() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        if dev is not None:
            stack.enter_context(torch.cuda.device(dev))
            stack.enter_context(torch.cuda.stream(stream))
        if req is not None:
            stack.enter_context(trace.request_ctx(*req))
        return stack
    return enter


def call_with_deadline(fn: Callable, deadline_s: float = None,
                       label: str = "dispatch"):
    """Run fn() in a daemon worker with the caller's context; raise
    DispatchTimeout past the deadline. Exceptions of fn propagate
    unchanged. On a timeout the worker is abandoned (counted), never
    joined, and no CUDA call is made here: the card may be wedged."""
    if deadline_s is None:
        deadline_s = deadline_seconds()
    if deadline_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()
    enter = _caller_context()

    def worker():
        try:
            with enter():
                box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 (raised in the caller)
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True,
                         name=f"abpoa-watchdog:{label}")
    t.start()
    if not done.wait(deadline_s):
        from ..obs import count, instant
        count("watchdog.timeouts")
        count("watchdog.abandoned_threads")
        instant("watchdog_timeout", "fault",
                args={"label": label, "deadline_s": deadline_s})
        _note_abandoned(t)
        raise DispatchTimeout(
            f"{label}: no result within {deadline_s:.1f}s watchdog deadline "
            "(wedged device dispatch?)")
    if "error" in box:
        raise box["error"]
    return box["result"]
