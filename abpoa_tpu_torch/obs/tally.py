"""Counters that several threads add to.

The routes keep their counters in module dicts (`fused_loop.stats`,
`banded.stats`, `lockstep.stats`, `map_driver.stats`, `dp_chunk.stats`).
A server runs requests on worker threads that share one card, and
``d[k] += n`` is a read and a write the interpreter may interleave, so the
dicts are `Tally`s: `add` and `add_in` are one locked read-modify-write,
and readers keep reading them as dicts. The kernel wrappers' launch
counters (`wrapper.launches`) go up through `count_launch`, under one lock
for the same reason.
"""
from __future__ import annotations

import threading
from typing import Callable


class Tally(dict):
    """A dict of counters; `zero()` gives its keys at their start values."""

    def __init__(self, zero: Callable[[], dict]) -> None:
        super().__init__(zero())
        self._zero = zero
        self._lock = threading.Lock()

    def add(self, key: str, n=1) -> None:
        with self._lock:
            self[key] = self[key] + n

    def add_in(self, key: str, sub, n=1) -> None:
        """Add `n` to the counter `sub` of the nested dict `self[key]`."""
        with self._lock:
            d = self[key]
            d[sub] = d.get(sub, 0) + n

    def high(self, key: str, n) -> None:
        """Raise `self[key]` to `n` where `n` is larger."""
        with self._lock:
            if n > self[key]:
                self[key] = n

    def reset(self) -> None:
        with self._lock:
            self.clear()
            self.update(self._zero())


_launch_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches") -> None:
    """One launch on a kernel wrapper's counter (`wrapper.<attr> += 1`,
    locked: two server threads may launch at once)."""
    with _launch_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
