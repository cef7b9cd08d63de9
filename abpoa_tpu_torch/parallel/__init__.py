"""The routes that batch read sets or reads: lockstep (`-l`, `msa_batch`;
the device lockstep, `align/fused_lanes.py`, or the split driver,
`lockstep.py`) and map (`map`), with their scheduler. Counterpart of
`abpoa_tpu/parallel/` without the pool, hybrid and sharded routes."""
from .lockstep import ChurnHook, progressive_poa_split_batch
from .map_driver import (MapHook, load_static_graph, map_read_host,
                         map_reads_split)
from .runner import (flush_lockstep_group, lockstep_covers,
                     lockstep_enabled, lockstep_group_size, run_batch)
from .scheduler import Route, lockstep_impl, plan_route
