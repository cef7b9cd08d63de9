"""Resilient dispatch: how the port absorbs, reports and routes around
device faults (CUDA out of memory, hangs, garbage output, sticky CUDA
errors) and malformed input.

Counterpart of `abpoa_tpu/resilience/`. The dispatch sites (the fused route
in `pipeline._run_fused_device`, the per-read and window dispatches in
`align/dispatch.py`, `-l` groups in `parallel/runner.py`, `msa_batch`)
wire these modules together:

- inject.py     deterministic fault injectors (ABPOA_TPU_INJECT=...)
- watchdog.py   a wall-clock deadline on device dispatches
- breaker.py    the per-backend circuit breaker and the ladder
                cpu -> native -> plain (the card is never demoted)
- guards.py     output sanity invariants (scores, cigar, alphabet)
- memory.py     admission priced on the card's free memory
- quarantine.py per-set isolation of `-l` and batch runs

`guarded_device_call` is the envelope: the injection points, the
watchdog, classified fault records, the breaker's bookkeeping and a
bounded retry with exponential backoff. Unclassified exceptions (real
bugs, an unknown RuntimeError included) propagate.

The port's rule is that no fallback hides the card or a kernel. The
envelope keeps it in four points:

1. A missing or wrong card raises (`device.resolve_device`); there is no
   `auto` device, and the port never picks the host on its own. On
   `cuda` nothing falls to the host either: the recovery stays on the
   card (the OOM retry, the fused route's fallback to the per-read route,
   the device lockstep's set-by-set rerun and plane groups, admission's
   per-read route), and where it is used up the run raises `CardFailure`
   (rc 1). A hang or a sticky CUDA error (an illegal address, a launch
   failure, a device-side assert) raises at once and marks the card lost:
   no later call of the run goes to it. The host DP runs only where the
   user asks for it (`--device native`); the ladder `cpu -> native ->
   plain` is the CPU device's.
2. A kernel library that cannot be built or loaded raises
   `kernels.build.KernelBuildError`, which `classify` does not absorb: the
   run exits non-zero. The library is loaded in the `backend_init` phase,
   before the first guarded dispatch and outside the envelope.
   `compile_fail` is a kind only for injection: the port compiles nothing
   a dispatch.
3. Every absorbed fault is loud: a stderr line (`note_absorbed`), a
   `faults` record (kind, backend, action), the `degraded` block while a
   breaker is open, and the counters `fallback.*`, `breaker.*`,
   `resilience.*`, `watchdog.*`, `admission.*` and `guard.*`. A degraded
   run whose output is correct still exits 0.
4. `chip_smoke.py` fails when anything is absorbed that it did not
   inject, so a kernel that starts to fail on the card fails the smoke.

With injection disarmed, a `cpu` or `native` run takes the direct-call
path (no worker thread, no host sync); ABPOA_TPU_RESILIENCE=0 (or
`set_enabled(False)`) bypasses the envelope for A/B measurement.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Tuple

from . import guards, inject, memory, watchdog
from .breaker import DEMOTION, FLOOR, CircuitBreaker, breaker
from .guards import GarbageOutput
from .inject import (InjectedCompileFailure, InjectedDeviceOOM,
                     InjectedFault, InjectedNativeCrash)
from .quarantine import (PoisonedSetError, QUARANTINE_EXCEPTIONS,
                         quarantine_set, validate_records)
from .watchdog import DispatchTimeout

__all__ = [
    "guards", "inject", "memory", "watchdog",
    "DEMOTION", "FLOOR", "CircuitBreaker", "breaker",
    "GarbageOutput", "DispatchTimeout", "DispatchFailed",
    "InjectedFault", "InjectedCompileFailure", "InjectedDeviceOOM",
    "InjectedNativeCrash",
    "PoisonedSetError", "QUARANTINE_EXCEPTIONS", "quarantine_set",
    "validate_records",
    "CardFailure", "check_card", "note_absorbed", "note_abort",
    "classify", "guarded_device_call", "enabled", "set_enabled",
]


class DispatchFailed(RuntimeError):
    """Every attempt of a guarded dispatch failed; `kind` is the last
    classified fault."""

    def __init__(self, kind: str, msg: str) -> None:
        super().__init__(msg)
        self.kind = kind


class CardFailure(RuntimeError):
    """The card failed and its recovery is used up, or it was lost (a hang,
    a sticky CUDA error): the run stops with rc 1 instead of moving the
    work to the host. `kind` is the fault's kind."""

    def __init__(self, kind: str, msg: str) -> None:
        super().__init__(msg)
        self.kind = kind


_ENABLED = os.environ.get("ABPOA_TPU_RESILIENCE", "1") not in ("0", "off")

# the wrappers' error of a sticky CUDA fault (kernels/build.py `check`):
# the context is lost, nothing on this card can be retried or run again
_STICKY = ("illegal memory access", "illegal address",
           "unspecified launch failure", "device-side assert",
           "misaligned address", "illegal instruction", "hardware stack error")


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """The kill switch (the A/B measurement's control arm)."""
    global _ENABLED
    _ENABLED = bool(flag)


def classify(exc: BaseException) -> Optional[Tuple[str, bool, bool]]:
    """(kind, retryable, counts against the breaker) of a dispatch
    exception; None for what the envelope does not absorb: a kernel build
    or load failure, and any exception it does not know (a real bug), an
    unknown RuntimeError included, propagate. A retry is made only where a
    second attempt is cheap and could differ (an allocation race); a hang
    already cost a deadline, and a guard violation or a sticky CUDA error
    repeats."""
    from ..kernels.build import KernelBuildError
    if isinstance(exc, (KernelBuildError, CardFailure)):
        # a CardFailure from a nested dispatch (the split driver's window
        # launches inside a guarded lockstep piece) ends the run as well
        return None
    if isinstance(exc, InjectedFault):
        return exc.kind, exc.kind in ("compile_fail", "oom"), True
    if isinstance(exc, DispatchTimeout):
        return "hang", False, True
    if isinstance(exc, GarbageOutput):
        return "garbage_output", False, True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        low = msg.lower()
        if msg.startswith(("fused loop", "fused lockstep",
                           "device lockstep")):
            # the fused drivers' own structural bails: a fallback of a
            # healthy run, not a backend fault
            return "fused_bail", False, False
        if any(s in low for s in _STICKY):
            return "dispatch_error", False, True
        if "out of memory" in low or "resource_exhausted" in low:
            # torch.cuda.OutOfMemoryError, the wrappers' "CUDA error 2
            # (out of memory)"
            return "oom", True, True
        if "native dp kernel failed" in low:
            return "native_crash", False, True
    return None


# the kinds after which nothing more may go to the card: a wedged stream
# (hang) or a lost context (a sticky CUDA error)
_LOSES_CARD = ("hang", "dispatch_error")


def note_absorbed(kind: str, backend: str, action: str, detail: str = "",
                  label: str = "dispatch", **extra) -> None:
    """One absorbed fault: its `faults` record and its stderr line."""
    from ..obs import report
    report().record_fault(kind, backend=backend, detail=detail[:300],
                          action=action, **extra)
    print(f"Warning: {label}: {kind} on '{backend}' absorbed ({action}): "
          f"{detail[:160]}", file=sys.stderr)


def note_abort(kind: str, backend: str, detail: str = "", **extra) -> None:
    """The `faults` record of a fault that ends the run (action "abort");
    the caller raises, and the CLI prints the error line."""
    from ..obs import report
    report().record_fault(kind, backend=backend, detail=detail[:300],
                          action="abort", **extra)


def check_card(backend: str) -> None:
    """Raise CardFailure where `backend`'s card was lost earlier in this
    run, before any call to it (admission's free-memory read included)."""
    kind = breaker().lost.get(backend)
    if kind is not None:
        raise CardFailure(kind, f"the card ('{backend}') was lost earlier "
                          f"in this run ({kind}); no further call goes to it")


def _retries() -> int:
    return max(0, int(os.environ.get("ABPOA_TPU_DISPATCH_RETRIES", "1")))


def _backoff_base_s() -> float:
    return float(os.environ.get("ABPOA_TPU_BACKOFF_S", "0.05"))


def guarded_device_call(label: str, backend: str, fn: Callable,
                        deadline_s: float = None, fallback: bool = True):
    """Run one dispatch on `backend` ("cuda", "cpu" or "native") under the
    envelope. Supervised backends (`watchdog.supervision_needed`) run in
    the watchdog's worker with the injection points armed; the others run
    inline. Classified failures are recorded (`faults`, a stderr line, the
    breaker) and retried with exponential backoff while a retry could
    help; exhaustion raises DispatchFailed(kind) for the caller's
    fallback, or CardFailure where the caller has none (`fallback=False`:
    the card's last rung). A hang or a sticky CUDA error on `cuda` raises
    CardFailure at once and marks the card lost: the caller must not touch
    it again."""
    if not _ENABLED:
        return fn()
    from ..obs import count
    check_card(backend)
    br = breaker()
    # the half-open gate: "closed" dispatches, "probe" is the one probe
    # of an open breaker, None means the demotion stands
    permit = br.acquire(backend)
    if permit is None:
        count("breaker.short_circuit")
        raise DispatchFailed(
            "breaker_open",
            f"{label}: circuit breaker open for '{backend}' "
            f"(serving as '{br.effective(backend)}')")
    is_probe = permit == "probe"
    supervised = watchdog.supervision_needed(backend)

    def attempt():
        inject.pre_dispatch(backend)
        return fn()

    tries = 1 + _retries()
    delay = _backoff_base_s()
    last_exc: BaseException = None
    last_kind = "dispatch_error"
    for i in range(tries):
        try:
            if supervised:
                result = watchdog.call_with_deadline(attempt, deadline_s,
                                                     label=label)
            else:
                result = attempt()
            br.record_success(backend, probe=is_probe)
            return result
        except Exception as e:  # noqa: BLE001 (classified; the rest re-raise)
            cls = classify(e)
            if cls is None:
                if is_probe:
                    br.abort_probe(backend)
                raise
            kind, retryable, breaks = cls
            last_exc, last_kind = e, kind
            if backend == "cuda" and kind in _LOSES_CARD:
                note_abort(kind, backend, str(e))
                br.mark_lost(backend, kind)
                raise CardFailure(kind, f"{label}: {kind}: {e}") from e
            if breaks:
                br.record_failure(backend, kind, probe=is_probe)
            elif is_probe:
                br.abort_probe(backend)
            retrying = retryable and i + 1 < tries and not br.is_open(backend)
            if kind == "fused_bail":
                count("resilience.fused_bail")
            elif retrying or fallback:
                note_absorbed(kind, backend,
                              "retry" if retrying else "fallback", str(e),
                              label=label)
            else:
                note_abort(kind, backend, str(e))
            if not retrying:
                break
            count("resilience.retries")
            time.sleep(delay)
            delay *= 2
    if not fallback:
        raise CardFailure(last_kind, f"{label}: {last_kind}: {last_exc}; "
                          "no recovery on the card is left") from last_exc
    raise DispatchFailed(
        last_kind, f"{label}: {last_kind}: {last_exc}") from last_exc
