"""The batch route decision of the `-l` runner and `map`.

Counterpart of the part of `abpoa_tpu/parallel/scheduler.py` these routes
need: `Route` (:46), `lockstep_impl` (:190) and `plan_route` (:203) with
`_plan` (:273) and `_plan_map` (:247), the `sharded` route included
(:203-305).

Routes of the port: `serial` (one set after another on the single-set
routes), `lockstep` (K sets in one of two implementations, `lockstep_impl`:
the device lockstep, `align/fused_lanes.py`, every set's graph on the card
and every kernel launched once a round over the sets; or the split driver,
`parallel/lockstep.py`, one K-lane B2 launch a round and each set's fusion
on the host) and `map` (K reads against one graph,
`parallel/map_driver.py`). Lockstep runs on `cuda`, and on `cpu` when asked
for (`--lockstep on`); map runs on either. K is
`runner.lockstep_group_size()`, fixed for the run. A mesh of two or more
devices (`--mesh N`, ABPOA_TPU_MESH; `shard.requested_mesh_size`) turns a
lockstep or map plan into `sharded` (`parallel/shard.py`): the same
drivers with each round split over the mesh, K = mesh x the per-card K,
`workers` the mesh size. Unlike JAX, whose `run_batch` never passes its
mesh to the device lockstep, both lockstep implementations take it.

The server's part (`abpoa_tpu/parallel/scheduler.py:91-187`): the
query-length crossover `lockstep_min_qlen` (below it a request runs on its
own), the per-route EWMAs of the idle-lane share and the lane occupancy
(`observe_noop_fraction`, fed by the device lockstep each round, and
`observe_lane_occupancy`, fed by the split driver's and map's lane tables)
and `noop_k_cap`, which halves a group's K per 0.25 of idle lanes. Only
`plan_route(..., serve=True)` and the server's coalescer read the cap: the
`-l` runner and `map` keep their fixed K (`runner.lockstep_group_size()`,
the K both lockstep implementations were measured at: C9's and C10's
walls). The JAX scheduler's `pool` and `hybrid` kinds come with the pool.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional

from .. import constants as C


class Route(NamedTuple):
    kind: str       # "serial" | "lockstep" | "map" | "sharded"
    k_cap: int      # sets (lockstep) or reads (map) per group
    reason: str
    code: str = "unspecified"   # "eligible" | "ineligible" | "empty" | "mesh"
    workers: int = 1            # devices of the mesh ("sharded")


# the measured-feedback state, a route each: the idle-lane (noop) EWMA that
# caps K and the lane-occupancy estimators. Keyed by the observing route,
# so the map stream's occupancy (near 1.0 by construction) cannot hide the
# consensus drain's idle lanes from the lockstep cap, or the reverse.
ROUTES = ("lockstep", "map", "sharded")
NOOP_HALVING_STEP = 0.25

# below this query length a request runs on its own rather than in a
# lockstep group (the JAX package's measured crossover, kept as its knob)
LOCKSTEP_MIN_QLEN = 1500

_LOCK = threading.Lock()


def _new_noop() -> dict:
    return {"ewma": 0.0, "seen": False}


def _new_occ() -> dict:
    return {"ewma": 1.0, "seen": False, "sum": 0.0, "n": 0}


_NOOP = {r: _new_noop() for r in ROUTES}
_OCC = {r: _new_occ() for r in ROUTES}


def reset() -> None:
    with _LOCK:
        for r in ROUTES:
            _NOOP[r] = _new_noop()
            _OCC[r] = _new_occ()


def observe_noop_fraction(f: float, route: str = "lockstep") -> None:
    """One round's idle-lane share into `route`'s EWMA (a half each), and
    the `abpoa_lockstep_noop_fraction` gauge."""
    f = min(max(float(f), 0.0), 1.0)
    with _LOCK:
        st = _NOOP[route]
        st["ewma"] = f if not st["seen"] else 0.5 * st["ewma"] + 0.5 * f
        st["seen"] = True
        ewma = st["ewma"]
    from ..obs import metrics
    metrics.publish_noop_fraction(ewma)


def noop_ewma(route: str = "lockstep") -> float:
    return _NOOP[route]["ewma"]


def observe_lane_occupancy(occ: float, route: str = "lockstep") -> None:
    """One round's live lanes over the group's capacity: `route`'s
    occupancy EWMA and mean, the `abpoa_lockstep_lane_occupancy` gauge, and
    1 - occ into the idle-lane EWMA."""
    occ = min(max(float(occ), 0.0), 1.0)
    with _LOCK:
        st = _OCC[route]
        st["ewma"] = occ if not st["seen"] else 0.5 * st["ewma"] + 0.5 * occ
        st["seen"] = True
        st["sum"] += occ
        st["n"] += 1
        ewma = st["ewma"]
    from ..obs import metrics
    metrics.publish_lane_occupancy(ewma)
    observe_noop_fraction(1.0 - occ, route=route)


def occupancy_ewma(route: str = "lockstep") -> float:
    return _OCC[route]["ewma"]


def lockstep_min_qlen() -> int:
    """The crossover in query bp (ABPOA_TPU_LOCKSTEP_MIN_QLEN; 0 turns the
    gate off)."""
    try:
        return int(os.environ.get("ABPOA_TPU_LOCKSTEP_MIN_QLEN",
                                  str(LOCKSTEP_MIN_QLEN)))
    except ValueError:
        return LOCKSTEP_MIN_QLEN


def noop_k_cap(base_k: int, noop: Optional[float] = None,
               route: str = "lockstep") -> int:
    """A group's K from `route`'s idle-lane EWMA (or `noop`): halved per
    NOOP_HALVING_STEP of idle lanes, at least 1."""
    f = _NOOP[route]["ewma"] if noop is None else noop
    k = max(1, int(base_k))
    while f >= NOOP_HALVING_STEP and k > 1:
        k //= 2
        f -= NOOP_HALVING_STEP
    return k


def lockstep_impl(abpt) -> str:
    """The lockstep implementation of a run. On the card, "device" in
    global and extend mode (C9: it won all of 10 alternating pairs against
    the split driver, medians 15.37 against 17.99 s) and "split" in local
    mode (C9 with `-m 1`: 324.35 s against 17.95 s, B3 being one block a
    lane at W 16384 where the split driver's B2u takes a cluster of blocks
    a lane; one H100 80GB HBM3 at 700 W, PERF.md §6); "split" on the
    CPU. ABPOA_TPU_LOCKSTEP_IMPL ("split" or "device") overrides, so the
    CPU tests can run the device lockstep on the plain versions."""
    forced = os.environ.get("ABPOA_TPU_LOCKSTEP_IMPL", "").strip().lower()
    if forced in ("split", "device"):
        return forced
    if abpt.torch_device.type != "cuda" or abpt.align_mode == C.LOCAL_MODE:
        return "split"
    return "device"


def plan_route(abpt, n_sets: int, workload: str = "consensus",
               mesh=None, serve: bool = False) -> Route:
    """The route of a batch of `n_sets` read sets (or, with
    workload="map", of `n_sets` reads against one graph). `mesh`, the
    number of devices (default `shard.requested_mesh_size()`), turns a
    lockstep or map plan into `sharded` when it is 2 or more. With
    `serve`, the server's coalescing plan: K is `noop_k_cap`'s, a card's
    worth times the mesh."""
    route = _plan(abpt, n_sets, workload, mesh, serve)
    # the decision on the report, the metrics and the trace
    # (abpoa_tpu/parallel/scheduler.py:238-243)
    from ..obs import count, metrics, trace
    count(f"scheduler.{route.kind}.{route.code}")
    metrics.publish_route(route)
    trace.instant("route", "sched", args=route._asdict())
    return route


def _plan(abpt, n_sets: int, workload: str, mesh, serve: bool) -> Route:
    from .runner import _lockstep_ok, lockstep_group_size
    from .shard import requested_mesh_size
    if n_sets <= 0:
        return Route("serial", 1, "empty batch", "empty")
    k = lockstep_group_size()
    n = requested_mesh_size() if mesh is None else max(0, int(mesh))
    if serve:
        k = noop_k_cap(k, route="sharded" if n >= 2 else
                       "map" if workload == "map" else "lockstep")
    if workload == "map":
        if n >= 2:
            return Route("sharded", n * k, f"sharded map K={n * k} over "
                         f"mesh={n} ({n} x per-chip k_cap {k})", "mesh", n)
        return Route("map", k, f"map split k={k}", "eligible")
    if not _lockstep_ok(abpt):
        return Route("serial", 1, "lockstep ineligible", "ineligible")
    if n >= 2:
        return Route("sharded", n * k, f"sharded K={n * k} over mesh={n} "
                     f"({n} x per-chip k_cap {k})", "mesh", n)
    return Route("lockstep", k, f"{lockstep_impl(abpt)} k={k}", "eligible")
