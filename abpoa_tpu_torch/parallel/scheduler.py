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
mesh to the device lockstep, both lockstep implementations take it. The
JAX scheduler's other kinds (`pool`, `hybrid`), its query-length
crossover and its K cap from the idle-lane share have no twin yet: they
come back only where a card cell with more than K sets shows they pay.
"""
from __future__ import annotations

import os
from typing import NamedTuple

from .. import constants as C


class Route(NamedTuple):
    kind: str       # "serial" | "lockstep" | "map" | "sharded"
    k_cap: int      # sets (lockstep) or reads (map) per group
    reason: str
    code: str = "unspecified"   # "eligible" | "ineligible" | "empty" | "mesh"
    workers: int = 1            # devices of the mesh ("sharded")


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
               mesh=None) -> Route:
    """The route of a batch of `n_sets` read sets (or, with
    workload="map", of `n_sets` reads against one graph). `mesh`, the
    number of devices (default `shard.requested_mesh_size()`), turns a
    lockstep or map plan into `sharded` when it is 2 or more."""
    route = _plan(abpt, n_sets, workload, mesh)
    # the decision on the report, the metrics and the trace
    # (abpoa_tpu/parallel/scheduler.py:238-243)
    from ..obs import count, metrics, trace
    count(f"scheduler.{route.kind}.{route.code}")
    metrics.publish_route(route)
    trace.instant("route", "sched", args=route._asdict())
    return route


def _plan(abpt, n_sets: int, workload: str, mesh) -> Route:
    from .runner import _lockstep_ok, lockstep_group_size
    from .shard import requested_mesh_size
    if n_sets <= 0:
        return Route("serial", 1, "empty batch", "empty")
    k = lockstep_group_size()
    n = requested_mesh_size() if mesh is None else max(0, int(mesh))
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
