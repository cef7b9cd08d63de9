"""The sharded route: a batch's lanes split over a mesh of cards.

Counterpart of `abpoa_tpu/parallel/shard.py` (`requested_mesh_size` :72,
`mesh_size` :88, `discover_mesh` :93, `shard_dp_round` :189) and of
`abpoa_tpu/parallel/runner.py:448` `shard_dp_batch`. A mesh here is a
tuple of `torch.device`s, one a slot: `cuda:0 ... cuda:n-1` on the card
machine, or n x `cpu` on the CPU (the twin of JAX's virtual CPU mesh; there
is nothing to pin). The same device may be listed more than once: a
one-card mesh of repeated devices runs the split, the per-card packs and
the order of launches and syncs on one card.

The lanes of a round (the split driver's and map's K-lane chunk, a seeded
read's windows, the device lockstep's sets) are cut into contiguous,
balanced slices, one a slot (`split_lanes`). Each slot's lanes run on its
device with the kernels the unsharded route launches; there are no
collectives, and each lane's result is the one it gets unsharded. Every
slot's launches are queued before the first host sync of the round
(`align/banded.py` `align_windows_banded`, `align/fused_lanes.py`
`progressive_poa_fused_batch`). The port pads no lane, so it needs no K
rung divisible by the mesh (JAX: `shard.py:209-212`); an empty slice
launches nothing.

JAX's `pin_virtual_cpu_mesh`, `shard_vmap` and `_sharded_jit` have no twin:
they are jax plumbing (the XLA flag of the virtual mesh, the shard_map spec
and the jit cache of the sharded entry).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import Params


def requested_mesh_size(cli: Optional[int] = None) -> int:
    """The mesh size asked for: an explicit CLI value wins, else
    ABPOA_TPU_MESH. 0 or 1 (or unset, or not a number) mean off."""
    if cli is not None:
        return max(0, int(cli))
    raw = os.environ.get("ABPOA_TPU_MESH", "").strip()
    try:
        return max(0, int(raw)) if raw else 0
    except ValueError:
        return 0


def mesh_size(mesh) -> int:
    """Slots of a mesh; 1 for the unsharded path (mesh=None)."""
    return len(mesh) if mesh is not None else 1


def discover_mesh(n: Optional[int] = None,
                  device="cuda") -> Optional[Tuple[torch.device, ...]]:
    """The mesh of `n` devices (default: `requested_mesh_size()`) of the
    run's device type, or None when n < 2. On cuda: cuda:0 ... cuda:n-1,
    each checked as `resolve_device` checks; RuntimeError when fewer cards
    are attached than asked for (no smaller mesh, no unsharded fallback).
    On cpu: n x cpu."""
    from ..device import resolve_device
    size = requested_mesh_size() if n is None else max(0, int(n))
    if size < 2:
        return None
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * size
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < size:
        raise RuntimeError(f"mesh of {size} devices requested but {have} "
                           f"CUDA device(s) are attached")
    return tuple(resolve_device(f"cuda:{i}") for i in range(size))


def split_lanes(k: int, n: int) -> List[Tuple[int, int]]:
    """k lanes cut into n contiguous, balanced slices [lo, hi), one a mesh
    slot in order: the first k % n slices hold one lane more. A slice may
    be empty (k < n)."""
    q, r = divmod(k, n)
    out, lo = [], 0
    for s in range(n):
        hi = lo + q + (s < r)
        out.append((lo, hi))
        lo = hi
    return out


def mesh_parts(k: int, mesh, default: torch.device) -> list:
    """(device, lane ids) of each non-empty slice of k lanes over `mesh`;
    one part of every lane on `default` without a mesh (or with one
    slot)."""
    if mesh_size(mesh) < 2:
        return [(default, list(range(k)))]
    return [(dev, list(range(lo, hi)))
            for dev, (lo, hi) in zip(mesh, split_lanes(k, len(mesh)))
            if hi > lo]


def note_shards(k: int, mesh, default: torch.device) -> Optional[list]:
    """The live lanes of each slot of a sharded chunk of `k` lanes, also
    published as the mesh and per-shard occupancy gauges
    (abpoa_tpu/parallel/shard.py:246-251); None without a mesh."""
    if mesh_size(mesh) <= 1:
        return None
    from ..obs import metrics
    S = mesh_size(mesh)
    k_per = -(-k // S)
    metrics.publish_mesh(S, torch.device(mesh[0]).type)
    live = [0] * S
    for i, (_, ids) in enumerate(mesh_parts(k, mesh, default)):
        live[i] = len(ids)
    for i, n in enumerate(live):
        metrics.publish_shard_occupancy(i, n / k_per)
    return live


def shard_dp_round(g, abpt: Params, queries: Sequence[np.ndarray], mesh,
                   static=None) -> list:
    """The sharded twin of the K-lane chunk (`dp_chunk.run_dp_chunk`,
    JAX's `shard_dp_round`): query i aligned to the whole of g[i] (`g` a
    list of graphs), or, with `static` (`dp_chunk.StaticGraphTables`), to
    its one graph, whose tables every slot reads from its own device. The
    lanes split over `mesh` as `split_lanes` cuts them; one AlignResult a
    lane, in lane order, each the unsharded chunk's."""
    from ..align.dp_chunk import run_dp_chunk
    if static is not None:
        return static.align(list(queries), mesh=mesh)
    return run_dp_chunk(list(g), abpt, list(queries), mesh=mesh)


def shard_dp_batch(mesh_devices: Optional[int] = None, device="cuda"):
    """A sharded step of kernel B2 over a mesh of `mesh_devices` devices
    (default: every attached card; JAX's `runner.shard_dp_batch`). Returns
    (mesh, step): `step(abpt, tabs, queries, W)` takes per-set row tables
    (`tables.build_row_tables`, stacked along the set axis) and queries,
    queues one B2 launch a slot over its slice of the sets, at band width
    W, and returns each set's H plane (gn x W, on its slot's device), in
    set order. With fewer than two devices the mesh is None and one launch
    takes every set."""
    from ..align.banded import _read_events, run_windows
    if mesh_devices is None:
        mesh_devices = (torch.cuda.device_count()
                        if torch.device(device).type == "cuda" else 1)
    mesh = discover_mesh(mesh_devices, device)

    def step(abpt: Params, tabs: list, queries: list, W: int) -> list:
        events, planes = [], []
        for dev, ids in mesh_parts(len(tabs), mesh, abpt.torch_device):
            _, out = run_windows(abpt, [tabs[i] for i in ids],
                                 [queries[i] for i in ids], W,
                                 dev=dev if mesh else None, events=events)
            roff = np.cumsum([0] + [tabs[i].gn for i in ids])
            planes += [out[0][roff[b]:roff[b + 1]] for b in range(len(ids))]
        _read_events(events)
        return planes

    return mesh, step
