"""The batch route decision of the `-l` runner and `map`.

Counterpart of the part of `abpoa_tpu/parallel/scheduler.py` these routes
need: `Route` (:46) and `plan_route` (:203) with `_plan` (:273) and
`_plan_map` (:247).

Routes of the port: `serial` (one set after another on the single-set
routes), `lockstep` (K sets in the split driver, `parallel/lockstep.py`)
and `map` (K reads against one graph, `parallel/map_driver.py`). Lockstep
runs on `cuda`, and on `cpu` when asked for (`--lockstep on`); map runs on
either. K is `runner.lockstep_group_size()`, fixed for the run. The JAX
scheduler's other kinds (`pool`, `hybrid`, `sharded`), its pick between
two lockstep implementations, its query-length crossover and its K cap
from the idle-lane share have no twin yet: they come with the device
lockstep, once a card measurement sets them.
"""
from __future__ import annotations

from typing import NamedTuple


class Route(NamedTuple):
    kind: str       # "serial" | "lockstep" | "map"
    k_cap: int      # sets (lockstep) or reads (map) per group
    reason: str
    code: str = "unspecified"   # "eligible" | "ineligible" | "empty"


def plan_route(abpt, n_sets: int, workload: str = "consensus") -> Route:
    """The route of a batch of `n_sets` read sets (or, with
    workload="map", of `n_sets` reads against one graph)."""
    from .runner import _lockstep_ok, lockstep_group_size
    if n_sets <= 0:
        return Route("serial", 1, "empty batch", "empty")
    k = lockstep_group_size()
    if workload == "map":
        return Route("map", k, f"map split k={k}", "eligible")
    if not _lockstep_ok(abpt):
        return Route("serial", 1, "lockstep ineligible", "ineligible")
    return Route("lockstep", k, f"split k={k}", "eligible")
