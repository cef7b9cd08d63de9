"""Counterpart of `abpoa_tpu/obs/rounds.py`.

Per-round timeline: a bounded ring of one sample a driver round.

The port's batched drivers all advance in rounds: the split lockstep
driver (`parallel/lockstep.py`, one K-lane B2 chunk a round), the map
driver (`parallel/map_driver.py`, the same chunk over a static graph) and
the device lockstep (`align/fused_lanes.py`, B1, X1, S1 and K1 once a
round over the lanes). Their counters (`lockstep.chunks`, `map.rounds`)
say how many rounds ran; this ring says how long each took and how full
it was. Every round lands one sample carrying the round wall, the wall of
its K-lane chunks alone (`dp_chunk._chunk` notes it, around the same code
the `dp_chunk` trace span brackets), the live lanes, the group's capacity
and, when the chunk ran over a mesh (`--mesh N`), the live lanes of each
slot.

Per-slot walls are estimates, and say so: the host times a sharded chunk
as a whole, ending at its last slot's sync, so each slot's wall is the
chunk's wall scaled by its live lanes over the fullest slot's. The skew
ratio (max/min over slots with live lanes) is exact in lanes.

Surfaces: `/metrics` (the `abpoa_round_wall_seconds` histogram and the
`abpoa_shard_skew_ratio`, `abpoa_shard_round_wall_seconds{shard=}` and
`abpoa_shard_straggler` gauges), extra Chrome trace tracks when tracing is
on (tid 900 = rounds, 910+i = slot estimates) and `top`'s shard-skew row.

A sample is taken after the round's last host sync, from clocks the
driver already reads; the hook is one lock and one tuple store a round,
and the ring keeps the newest DEFAULT_CAPACITY samples, counting the
older ones it overwrites in `dropped()`.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

DEFAULT_CAPACITY = 4096

# reserved Chrome-trace track ids: the round timeline and per-shard
# estimate tracks must not collide with live thread tids (dense from 1)
# or foreign worker pids
ROUNDS_TID = 900
SHARD_TID_BASE = 910


class RoundSample(NamedTuple):
    route: str                  # "lockstep" | "sharded" | "map"
    t_start: float              # perf_counter at round start
    wall_s: float               # full round wall (host fusion included)
    dp_wall_s: float            # fused dispatch bracket(s) only
    lanes: int                  # live lanes this round
    k_cap: int                  # group capacity (global lanes if sharded)
    mesh: int                   # mesh size (1 = unsharded)
    shard_live: Optional[Tuple[int, ...]]  # per-shard live lanes


# per-thread accumulation between begin_round() and record_round(): the
# chunk (align/dp_chunk.py) notes its wall here without knowing which
# driver's round it serves
_TLS = threading.local()


class RoundRing:
    """Bounded ring of RoundSamples (trace.Tracer's ring discipline)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity or DEFAULT_CAPACITY
        self._lock = threading.Lock()
        self._buf: List[RoundSample] = []
        self._n = 0

    def add(self, s: RoundSample) -> None:
        with self._lock:
            if self._n < self.capacity:
                self._buf.append(s)
            else:
                self._buf[self._n % self.capacity] = s
            self._n += 1

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    @property
    def total(self) -> int:
        return self._n

    def samples(self) -> List[RoundSample]:
        with self._lock:
            if self._n <= self.capacity:
                return list(self._buf)
            k = self._n % self.capacity
            return self._buf[k:] + self._buf[:k]


_RING = RoundRing()


def ring() -> RoundRing:
    return _RING


def reset(capacity: Optional[int] = None) -> None:
    global _RING
    _RING = RoundRing(capacity)
    _TLS.dp_wall = 0.0
    _TLS.shard_live = None


def dropped() -> int:
    return _RING.dropped


# ------------------------------------------------------------- recording

def begin_round() -> None:
    """Zero this thread's dispatch accumulation — called by the drivers
    where they stamp the round start, so a warmer's stray dispatch on
    the same thread can never leak into the next round's dp wall."""
    _TLS.dp_wall = 0.0
    _TLS.shard_live = None


def note_dispatch(wall_s: float,
                  shard_live: Optional[Sequence[int]] = None) -> None:
    """One K-lane chunk completed on this thread: accumulate its wall
    (the reverse-complement chunk of `-s` adds to the round's) and, over a
    mesh, keep the live lanes of each slot."""
    _TLS.dp_wall = getattr(_TLS, "dp_wall", 0.0) + float(wall_s)
    if shard_live is not None:
        _TLS.shard_live = tuple(int(x) for x in shard_live)


def record_round(route: str, lanes: int, k_cap: int, wall_s: float,
                 mesh: int = 1) -> RoundSample:
    """Seal one round into the ring and fan it out to /metrics and the
    trace. Called by the drivers after the round's last host sync, with
    the wall they already measure for the round's amortized share."""
    dp_wall = getattr(_TLS, "dp_wall", 0.0)
    shard_live = getattr(_TLS, "shard_live", None)
    begin_round()
    s = RoundSample(route=route, t_start=time.perf_counter() - wall_s,
                    wall_s=float(wall_s), dp_wall_s=dp_wall,
                    lanes=int(lanes), k_cap=int(k_cap), mesh=int(mesh),
                    shard_live=shard_live)
    _RING.add(s)
    from . import metrics, trace
    metrics.publish_round(route, s.wall_s, s.lanes, s.k_cap)
    if s.shard_live and s.mesh > 1:
        walls = shard_wall_estimates(s)
        ratio, straggler = skew_of(s)
        metrics.publish_shard_skew(ratio, straggler, walls)
    if trace.enabled():
        _trace_round(s)
    return s


def shard_wall_estimates(s: RoundSample) -> Dict[int, float]:
    """Per-slot wall estimates for one sharded round: the chunks' wall
    scaled by each slot's live lanes over the fullest slot's."""
    live = s.shard_live or ()
    peak = max(live) if live else 0
    if peak <= 0:
        return {i: 0.0 for i in range(len(live))}
    return {i: s.dp_wall_s * n / peak for i, n in enumerate(live)}


def skew_of(s: RoundSample) -> Tuple[float, int]:
    """(skew ratio, straggler slot) of one sharded round: max/min live
    lanes over the slots that had any (an empty slot would make every
    ratio infinite); the straggler is the fullest slot, whose estimated
    wall is the measured one."""
    live = s.shard_live or ()
    if not live:
        return 1.0, 0
    peak = max(live)
    straggler = live.index(peak)
    floor = min((n for n in live if n > 0), default=peak)
    return (peak / floor if floor else 1.0), straggler


def _trace_round(s: RoundSample) -> None:
    from . import trace
    t = trace.tracer()
    args = {"route": s.route, "lanes": s.lanes, "k_cap": s.k_cap,
            "dp_wall_ms": round(s.dp_wall_s * 1e3, 3)}
    if s.mesh > 1:
        args["mesh"] = s.mesh
    t.add_foreign("X", f"round[{s.route}]", "round", s.t_start, s.wall_s,
                  ROUNDS_TID, args, None)
    if s.shard_live and s.mesh > 1:
        for i, w in shard_wall_estimates(s).items():
            t.add_foreign("X", f"shard{i}", "round", s.t_start, w,
                          SHARD_TID_BASE + i,
                          {"live": s.shard_live[i], "est": True}, None)


# --------------------------------------------------------------- reading

def snapshot(n: int = 0) -> List[dict]:
    """Newest `n` round samples (0 = all retained), oldest-first, as
    plain dicts."""
    out = [s._asdict() for s in _RING.samples()]
    return out[-n:] if n else out


def skew_summary() -> Optional[dict]:
    """The newest sharded round's skew verdict, None when no sharded
    round ran."""
    for s in reversed(_RING.samples()):
        if s.mesh > 1 and s.shard_live:
            ratio, straggler = skew_of(s)
            walls = shard_wall_estimates(s)
            return {
                "slowest_shard": straggler,
                "shard_skew": round(ratio, 3),
                "round_wall_ms": round(s.wall_s * 1e3, 3),
                "shard_wall_ms": {str(i): round(w * 1e3, 3)
                                  for i, w in walls.items()},
                "shard_live": list(s.shard_live),
            }
    return None
