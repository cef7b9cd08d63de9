"""Capacity and width rungs of the fused route.

Counterpart of `abpoa_tpu/compile/buckets.py` (`bucket`, `bucket_pow2`,
`grow_node_cap`, `geom_chain`, `snap`), of the planner helpers of
`abpoa_tpu/compile/ladder.py:93-151` (`qp_rung`, `k_rung`,
`plan_chunk_buckets`, `chunk_node_cap`) and of
`abpoa_tpu/align/fused_loop.py:1639` `partition_by_length_bucket`, copied
so the port never imports the JAX package. The port compiles nothing per
shape; it keeps the same rungs so that its capacities, op-stream caps and
error codes are those of the JAX fused loop, and so that the lockstep and
map routes group sets and refuse reads as the JAX drivers do (`qp_rung`).
"""
from __future__ import annotations

from typing import Tuple

from .. import constants as C


def bucket(n: int, step: int) -> int:
    """Smallest rung of the `step`-chain (x1.3, rounded up to `step`) that
    is >= n."""
    b = step
    while b < n:
        b = ((int(b * 1.3) + step - 1) // step) * step
    return b


def bucket_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p <<= 1
    return p


def grow_node_cap(n: int) -> int:
    """Node-capacity growth rung: x1.7 snapped onto the 1024-step chain."""
    return bucket(int(n * 1.7), 1024)


def geom_chain(step: int, cap: int) -> Tuple[int, ...]:
    rungs = [step]
    while rungs[-1] < cap:
        rungs.append(((int(rungs[-1] * 1.3) + step - 1) // step) * step)
    return tuple(rungs)


GEOM_128 = geom_chain(128, 1 << 18)


def snap(n: int, rungs: Tuple[int, ...]) -> int:
    """Smallest declared rung >= n; raises past the last one."""
    for r in rungs:
        if r >= n:
            return r
    raise ValueError(f"value {n} beyond the declared ladder cap {rungs[-1]}")


def qp_rung(qmax: int) -> int:
    """Padded query columns for a read set whose longest read is qmax."""
    return snap(qmax + 2, GEOM_128)


def k_rung(k: int) -> int:
    """Lane-axis rung of a lockstep or map group of k lanes (a power of
    two). The port launches one block a live lane and pads no lane; the
    rung only names the group's size class."""
    return bucket_pow2(max(k, 1))


def partition_by_length_bucket(entries):
    """Group (key, seqs, ...) entries by the `qp_rung` of their longest
    read, in ascending rung order: a lockstep group holds the sets of one
    rung, as the JAX drivers group them."""
    parts: dict = {}
    for entry in entries:
        qmax = max((len(s) for s in entry[1]), default=0)
        parts.setdefault(qp_rung(qmax), []).append(entry)
    return [parts[k] for k in sorted(parts)]


def plan_chunk_buckets(abpt, qmax: int) -> Tuple[int, int, bool]:
    """(Qp, W, local_mode): padded query width, starting band window and
    whether the run is local (unbanded: every row spans the query)."""
    Qp = qp_rung(qmax)
    local_m = abpt.align_mode == C.LOCAL_MODE
    if local_m:
        W = max(128, bucket_pow2(qmax + 2))
    else:
        w_full = abpt.wb + int(abpt.wf * qmax)
        W = max(128, bucket_pow2(2 * w_full + 4))
    return Qp, W, local_m


def chunk_node_cap(qmax: int, n0: int = 0) -> int:
    """Starting node capacity of a fused run from a graph of n0 nodes (0:
    the empty graph; abpoa_tpu/align/fused_loop.py:1805)."""
    return bucket(n0 + 2 * (qmax + 2) + 64, 1024)
