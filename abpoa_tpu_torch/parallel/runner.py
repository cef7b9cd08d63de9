"""`-l` file lists: lockstep groups of read sets, or one set after another.

Counterpart of the parts of `abpoa_tpu/parallel/runner.py` the lockstep
route needs: `lockstep_group_size` (:35), `lockstep_enabled` (:44),
`_lockstep_ok` (:79), `flush_lockstep_group` (:89) and `run_batch` (:237),
with the scheduler's `sharded` route (:281-300, :345-361): the mesh is
found once before the first group, and each group holds mesh x K sets.
Segments of K sets that the fused route would take run in lockstep, on the
implementation `scheduler.lockstep_impl` picks (the device lockstep,
`align/fused_lanes.py`, or the split driver, `parallel/lockstep.py`);
every other set takes its single-set
route (`pipeline.msa_from_file`). Output comes in file order, and a set
that fails its input checks or cannot be read is quarantined (one stderr
line) while the others go on. Left for later items: the memory admission
and the guarded dispatch with its sequential fallback (item 11; a failed
launch raises) and the pool and hybrid routes (item 12).
"""
from __future__ import annotations

import os
from typing import IO, List, Sequence

from ..params import Params


def lockstep_group_size() -> int:
    """Sets per lockstep group: ABPOA_TPU_LOCKSTEP_K, default 8."""
    return max(1, int(os.environ.get("ABPOA_TPU_LOCKSTEP_K", "8")))


def lockstep_enabled(abpt: Params) -> bool:
    """Should `-l` and `msa_batch` run sets in lockstep? `abpt.lockstep`
    "on"/"off" decides; "auto" turns lockstep on where the run's device is
    the card."""
    if abpt.lockstep in ("on", "off"):
        return abpt.lockstep == "on"
    return abpt.torch_device.type == "cuda"


def _lockstep_ok(abpt: Params) -> bool:
    """Lockstep covers the configurations of the fused route without `-i`
    on the plain route (no seeding, no guide tree), on cuda, and on cpu
    when asked for (`lockstep_enabled`). Z-drop joins the device lockstep,
    whose output is the fused route's, as in JAX; with the split driver it
    stays set by set, since that driver gives it the per-read route's
    output, which differs from the fused route's (ROADMAP.md §C)."""
    from ..align.eligibility import fused_config_eligible
    from ..params import plain_route
    from .scheduler import lockstep_impl
    return (not abpt.incr_fn
            and (abpt.zdrop <= 0 or lockstep_impl(abpt) == "device")
            and lockstep_enabled(abpt)
            and plain_route(abpt)
            and fused_config_eligible(abpt))


def lockstep_covers(abpt: Params, n_reads: int) -> bool:
    """Does a set of `n_reads` reads run in lockstep (`run_batch`,
    `msa_batch`)? Where the configuration allows it, the sets the fused
    route would take."""
    from ..align.eligibility import fused_eligible
    return _lockstep_ok(abpt) and fused_eligible(abpt, n_reads)


def flush_lockstep_group(group: List, abpt: Params, mesh=None) -> dict:
    """Run one lockstep group of (idx, ab, seqs, weights) entries, in
    groups of one `qp_rung` each, on the implementation
    `scheduler.lockstep_impl` picks ("device": the device lockstep,
    `fused_lanes.progressive_poa_fused_batch`; "split": the split driver),
    over `mesh` (a tuple of devices, `shard.discover_mesh`) where given;
    returns {idx: Abpoa with its set's graph and strand flags}. A failed
    group raises: neither implementation stands in for the other."""
    from ..align.buckets import partition_by_length_bucket
    from ..align.fused_lanes import progressive_poa_fused_batch
    from .lockstep import progressive_poa_split_batch
    from .scheduler import lockstep_impl
    drive = (progressive_poa_fused_batch if lockstep_impl(abpt) == "device"
             else progressive_poa_split_batch)
    results: dict = {}
    for sub in partition_by_length_bucket(
            [(e[0], e[2], e[3], e[1]) for e in group]):
        outs = drive([e[1] for e in sub], [e[2] for e in sub], abpt,
                     mesh=mesh)
        for (idx, _seqs, _w, ab), (graph, is_rc) in zip(sub, outs):
            ab.graph = graph
            if abpt.amb_strand:
                ab.is_rc[:len(is_rc)] = is_rc
            results[idx] = ab
    return results


def run_batch(files: Sequence[str], abpt: Params, out_fp: IO[str],
              mesh=None) -> dict:
    """The `-l` run over `files`: groups of K = `lockstep_group_size()`
    sets in lockstep where `plan_route` grants it, one set after another
    otherwise, each set's output in file order and byte-identical either
    way. On the `sharded` route (a mesh asked for: `--mesh N`,
    ABPOA_TPU_MESH) the mesh is found once before the first group
    (`shard.discover_mesh`, which raises where fewer devices are attached)
    and a group holds mesh x K sets. `mesh`, a tuple of devices, stands in
    for the one asked for (the route is planned for its size). Returns
    {"sets", "quarantined"}."""
    from ..io.fastx import read_fastx
    from ..pipeline import Abpoa, _ingest_records, msa_from_file, output
    from ..quarantine import (QUARANTINE_EXCEPTIONS, quarantine_set,
                              validate_records)
    from . import scheduler
    from .shard import discover_mesh, mesh_size
    stats = {"sets": len(files), "quarantined": 0}
    if not (abpt.out_msa or abpt.out_cons or abpt.out_gfa):
        return stats  # as msa_from_file: nothing to compute or emit
    route = scheduler.plan_route(
        abpt, len(files), mesh=None if mesh is None else mesh_size(mesh))
    if route.kind == "sharded" and mesh is None:
        mesh = discover_mesh(route.workers, abpt.torch_device)
    elif route.kind != "sharded":
        mesh = None

    def run_one(ab, i, fn):
        abpt.batch_index = i + 1
        try:
            msa_from_file(ab, abpt, fn, out_fp)
        except QUARANTINE_EXCEPTIONS as e:
            quarantine_set(i, fn, e)
            stats["quarantined"] += 1

    ab_seq = Abpoa()
    if route.kind not in ("lockstep", "sharded"):
        for i, fn in enumerate(files):
            run_one(ab_seq, i, fn)
        return stats

    K = route.k_cap
    seg: List = []    # [(file_idx, fn)] of the current segment
    group: List = []  # [(file_idx, ab, seqs, weights)], its lockstep sets

    def emit_segment() -> None:
        results = flush_lockstep_group(group, abpt, mesh)
        for idx, fn in seg:
            if idx in results:
                abpt.batch_index = idx + 1
                output(results[idx], abpt, out_fp)
            else:  # its single-set route (reads the file again)
                run_one(ab_seq, idx, fn)
        seg.clear()
        group.clear()

    for i, fn in enumerate(files):
        try:
            records = read_fastx(fn)
            validate_records(records)
            ab = Abpoa()
            seqs, weights = _ingest_records(ab, abpt, records)
        except QUARANTINE_EXCEPTIONS as e:
            quarantine_set(i, fn, e)
            stats["quarantined"] += 1
            continue
        seg.append((i, fn))
        if lockstep_covers(abpt, len(seqs)):
            group.append((i, ab, seqs, weights))
        if len(group) == K:
            emit_segment()
    emit_segment()
    return stats
