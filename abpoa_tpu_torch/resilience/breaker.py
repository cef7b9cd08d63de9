"""Per-backend circuit breaker: the degradation ladder's memory.

Counterpart of `abpoa_tpu/resilience/breaker.py`, with the same state
machine: every classified dispatch failure counts against the backend that
failed; past a threshold the breaker OPENS and the backend is demoted down
the ladder for the rest of the run instead of failing (and paying retries
and watchdog deadlines) on every later dispatch. After
``ABPOA_TPU_BREAKER_COOLDOWN_S`` (default 300 s) it goes HALF-OPEN: one
dispatch is let through as a probe; a success recloses the breaker, a
failure reopens it and restarts the cooldown.

The port's ladder is ``cpu -> native -> plain``: `native` is the C++
host DP (`align/native_backend.py`) and `plain` the per-read DP on B2's
and X1w's plain versions on CPU tensors, the port's correctness reference,
which is never demoted. `cpu` demotes as the JAX package demotes jax on
XLA:CPU, so the CPU tests walk the whole ladder. `cuda` is not on it: the
card is never demoted to the host. Its failures are counted
(`breaker.failures.cuda`), and a hang or a sticky CUDA error marks it
lost (`mark_lost`, `breaker.lost.cuda`): `resilience.check_card` then
refuses every later call to it in the run.

Transitions are never silent: opens and recloses warn on stderr once,
count `breaker.open.<backend>` / `breaker.reclose.<backend>` /
`breaker.half_open.<backend>`, set the `abpoa_breaker_open` gauge and show
in the run report's `degraded` block. `obs.start_run()` resets the
breaker. All transitions hold one lock.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional

# who serves when a backend is demoted; "plain" is the floor, and "cuda"
# has no rung below it
DEMOTION = {"cpu": "native", "native": "plain"}
FLOOR = "plain"


def _threshold() -> int:
    return max(1, int(os.environ.get("ABPOA_TPU_BREAKER_THRESHOLD", "3")))


def cooldown_s() -> float:
    """Seconds an open breaker waits before it lets the half-open probe
    through; <= 0 allows a probe at once."""
    return float(os.environ.get("ABPOA_TPU_BREAKER_COOLDOWN_S", "300"))


class CircuitBreaker:
    def __init__(self) -> None:
        self.failures: Dict[str, int] = {}
        # backend -> {"to", "kind", "failures", "opened_t", "probing"}
        self.open: Dict[str, dict] = {}
        # backend -> the kind that lost its card (a hang, a sticky error)
        self.lost: Dict[str, str] = {}
        self._lock = threading.RLock()

    def reset(self) -> None:
        from ..obs import metrics
        with self._lock:
            for backend in self.open:
                metrics.set_breaker_state(backend, False)
            self.failures.clear()
            self.open.clear()
            self.lost.clear()

    def _demoted_now_locked(self, backend: str) -> bool:
        """Is `backend` demoted now (cooldown-aware)? False once the
        cooldown elapsed with no probe in flight. Callers hold the lock."""
        st = self.open.get(backend)
        if st is None:
            return False
        if st["probing"]:
            return True
        return (time.monotonic() - st["opened_t"]) < cooldown_s()

    def is_open(self, backend: str) -> bool:
        with self._lock:
            return self._demoted_now_locked(backend)

    def acquire(self, backend: str) -> Optional[str]:
        """"closed" (dispatch), "probe" (this caller holds the one
        half-open permit) or None (open: short-circuit to the demotion)."""
        with self._lock:
            st = self.open.get(backend)
            if st is None:
                return "closed"
            if st["probing"]:
                return None
            if (time.monotonic() - st["opened_t"]) >= cooldown_s():
                st["probing"] = True
                from ..obs import count
                count(f"breaker.half_open.{backend}")
                return "probe"
            return None

    def effective(self, backend: str) -> str:
        """The backend that serves for `backend` now: down the ladder past
        every breaker open at this moment (cooldown-aware, so that a
        backend whose cooldown elapsed is named again and its next guarded
        dispatch can claim the probe)."""
        with self._lock:
            seen = set()
            while self._demoted_now_locked(backend) and backend not in seen:
                seen.add(backend)
                backend = DEMOTION.get(backend, FLOOR)
            return backend

    def abort_probe(self, backend: str) -> None:
        """Release a claimed probe permit without a verdict (the probe died
        on an unclassified exception); the breaker stays open and its
        cooldown restarts."""
        with self._lock:
            st = self.open.get(backend)
            if st is not None and st["probing"]:
                st["probing"] = False
                st["opened_t"] = time.monotonic()

    def record_success(self, backend: str, probe: bool = False) -> None:
        """A healthy dispatch; with `probe=True` (the caller holds the
        half-open permit) it recloses the breaker."""
        if not probe:
            return
        with self._lock:
            st = self.open.get(backend)
            if st is None or not st["probing"]:
                return
            del self.open[backend]
            self.failures[backend] = 0
        from ..obs import count, metrics, report
        count(f"breaker.reclose.{backend}")
        report().mark_reclosed(backend)
        metrics.set_breaker_state(backend, False)
        print(f"Warning: backend '{backend}' circuit breaker reclosed "
              "(half-open probe succeeded); resuming normal dispatch.",
              file=sys.stderr)

    def mark_lost(self, backend: str, kind: str) -> None:
        """The card of `backend` is lost for the run (`kind`: a hang or a
        sticky CUDA error); `resilience.check_card` refuses it from now."""
        from ..obs import count
        with self._lock:
            self.lost[backend] = kind
        count(f"breaker.lost.{backend}")

    def record_failure(self, backend: str, kind: str,
                       probe: bool = False) -> None:
        """A classified failure on `backend`; a backend with no rung below
        it (`cuda`) is counted and never opened."""
        from ..obs import count, report
        with self._lock:
            if backend not in DEMOTION:
                count(f"breaker.failures.{backend}")
                return
            st = self.open.get(backend)
            if st is not None:
                if probe:
                    st["probing"] = False
                    st["opened_t"] = time.monotonic()
                    st["kind"] = kind
                    st["failures"] += 1
                    count(f"breaker.probe_fail.{backend}")
                    report().mark_degraded(backend, st["to"], kind,
                                           st["failures"])
                else:
                    count(f"breaker.failures.{backend}")
                return
            n = self.failures[backend] = self.failures.get(backend, 0) + 1
            count(f"breaker.failures.{backend}")
            if n < _threshold():
                return
            to = self.effective(DEMOTION[backend])
            self.open[backend] = {"to": to, "kind": kind, "failures": n,
                                  "opened_t": time.monotonic(),
                                  "probing": False}
        from ..obs import metrics
        count(f"breaker.open.{backend}")
        report().mark_degraded(backend, to, kind, n)
        metrics.set_breaker_state(backend, True)
        print(f"Warning: backend '{backend}' circuit breaker opened "
              f"after {n} dispatch failures (last: {kind}); using "
              f"'{to}' until the {cooldown_s():.0f}s cooldown allows a "
              "probe.", file=sys.stderr)


_BREAKER = CircuitBreaker()


def breaker() -> CircuitBreaker:
    return _BREAKER
