"""Fault-injection harness: every failure the dispatch layer defends
against, armable on any host, the CPU included (no broken card needed).

Counterpart of `abpoa_tpu/resilience/inject.py`, with the same spec grammar
and kinds. Arm it through the environment (read once a process, at first
use):

    ABPOA_TPU_INJECT=compile_fail             # fire on every device dispatch
    ABPOA_TPU_INJECT=oom:2,hang               # oom twice, then hang forever
    ABPOA_TPU_INJECT=garbage:1                # corrupt one dispatch result

or with `configure("kind[:count],...")`. A bare kind fires on every
matching dispatch; `kind:N` fires N times and then disarms itself. Each
firing is counted (`inject.<kind>` in the run report).

Kinds and where they fire:

- ``compile_fail``  device dispatch (`cuda`, `cpu`): a compile-shaped
                    RuntimeError before the work runs. The port builds its
                    kernels once, outside every dispatch, so only this
                    injector produces the kind
- ``oom``           device dispatch: the message of
                    `torch.cuda.OutOfMemoryError` ("CUDA out of memory")
- ``hang``          device dispatch: sleeps ABPOA_TPU_INJECT_HANG_S
                    (default 30 s) inside the watchdog's worker, so the
                    deadline trips as on a wedged kernel
- ``garbage``       after a dispatch: corrupts the result (an absurd score
                    and a truncated cigar, or an out-of-alphabet graph
                    base) for the output guards to catch
- ``native_crash``  native host DP dispatch: the error of a non-zero
                    ``apg_align`` return
- ``poison_set``    set ingestion: raises PoisonedSetError (the per-set
                    quarantine)
- ``worker_kill``, ``worker_sigsegv``  parse; they fire from the process
                    pool's supervisor, which the port does not have yet

Disarmed, everything here is one boolean check (`_ANY`).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional


class InjectedFault(RuntimeError):
    """Base of the injected failures; `kind` routes classification."""
    kind = "injected"


class InjectedCompileFailure(InjectedFault):
    kind = "compile_fail"


class InjectedDeviceOOM(InjectedFault):
    kind = "oom"


class InjectedNativeCrash(InjectedFault):
    kind = "native_crash"


class InjectedHang(InjectedFault):
    kind = "hang"


KINDS = ("compile_fail", "oom", "hang", "garbage", "native_crash",
         "poison_set", "worker_kill", "worker_sigsegv")

# the backends whose dispatches are device dispatches (resilience/breaker.py)
DEVICE_BACKENDS = ("cuda", "cpu")

# kind -> remaining shots (-1 = unlimited); absent = disarmed
_SPEC: Dict[str, int] = {}
_ANY = False
_CONFIGURED = False
# every read-modify-write of _SPEC: a dispatch in a watchdog worker and the
# main thread may fire at once, and a ':1' spec must fire once
_LOCK = threading.Lock()


def configure(spec: Optional[str] = None) -> None:
    """Parse an injection spec ("kind[:count],..."); None reads
    ABPOA_TPU_INJECT. An unknown kind raises (a mistyped spec must not
    test nothing)."""
    global _ANY, _CONFIGURED
    if spec is None:
        spec = os.environ.get("ABPOA_TPU_INJECT", "")
    parsed = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, cnt = part.partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown fault-injection kind: {kind!r} "
                             f"(known: {', '.join(KINDS)})")
        parsed[kind] = int(cnt) if cnt else -1
    with _LOCK:
        _SPEC.clear()
        _SPEC.update(parsed)
        _ANY = bool(_SPEC)
        _CONFIGURED = True


def reset() -> None:
    """Disarm every injector."""
    configure("")


def _ensure_configured() -> None:
    if not _CONFIGURED:
        configure(None)


def armed(kind: str) -> bool:
    _ensure_configured()
    return _SPEC.get(kind, 0) != 0


def any_armed() -> bool:
    _ensure_configured()
    return _ANY


def snapshot() -> Dict[str, int]:
    """The spec as {kind: remaining} (-1 = unlimited)."""
    _ensure_configured()
    with _LOCK:
        return dict(_SPEC)


def fire(kind: str) -> bool:
    """Take one shot of `kind` if it is armed (counted as `inject.<kind>`
    in the run report)."""
    if not _CONFIGURED:
        configure(None)
    if not _ANY:
        return False
    with _LOCK:
        left = _SPEC.get(kind, 0)
        if left == 0:
            return False
        if left > 0:
            _SPEC[kind] = left - 1
    from ..obs import count
    count(f"inject.{kind}")
    return True


def hang_seconds() -> float:
    return float(os.environ.get("ABPOA_TPU_INJECT_HANG_S", "30"))


def pre_dispatch(backend: str) -> None:
    """The injection point at the top of a dispatch attempt; it runs inside
    the watchdog's worker for supervised dispatches, so an injected hang
    trips the deadline as a wedged kernel would."""
    if not _CONFIGURED:
        configure(None)
    if not _ANY:
        return
    if backend in DEVICE_BACKENDS:
        if fire("compile_fail"):
            raise InjectedCompileFailure(
                f"injected kernel compilation failure ({backend})")
        if fire("oom"):
            raise InjectedDeviceOOM(
                "CUDA out of memory. Tried to allocate the DP planes "
                "(injected)")
        if fire("hang"):
            # sleep past the deadline, then raise: the abandoned worker
            # must not go on with work whose result is discarded
            time.sleep(hang_seconds())
            raise InjectedHang(
                f"injected dispatch hang ({hang_seconds():.1f}s)")
    elif backend == "native":
        if fire("native_crash"):
            raise InjectedNativeCrash(
                "native DP kernel failed (rc=-11, injected crash)")


def corrupt_result(res):
    """The garbage injector of a per-read result: an absurd score and a
    truncated cigar, both invariants the output guards check."""
    if fire("garbage"):
        res.best_score = 1 << 40
        res.cigar = list(res.cigar)[: max(0, len(res.cigar) // 2)]
        res.cigar_arr = None  # the guards must see the corrupted list
    return res


def corrupt_graph_base(base_arr) -> bool:
    """The garbage injector of the fused routes: one downloaded graph base
    out of the alphabet (a corrupted kernel output). Mutates the host array
    in place; True when it fired."""
    if fire("garbage") and base_arr.size > 2:
        base_arr[2] = 99
        return True
    return False


def check_poison_set() -> None:
    """The set-ingestion injection point (the quarantine path without a
    malformed file on disk)."""
    if fire("poison_set"):
        from .quarantine import PoisonedSetError
        raise PoisonedSetError("injected poisoned read set")
