"""Output sanity guards: cheap invariant checks on dispatch results.

Counterpart of `abpoa_tpu/resilience/guards.py`, with the same checks and
violation strings.

A kernel that silently produces garbage (mis-DMA'd planes, a bad compile,
bit-flipped HBM) is worse than one that crashes: the run "succeeds" with a
wrong consensus. These guards check invariants every correct backend
satisfies by construction, on host-side data the driver already holds —
no device syncs, O(|cigar|) / O(nodes) host arithmetic:

- scores are finite int32 (the kernels' own plane width);
- the CIGAR consumes the query exactly once (global mode) and never more
  bases/nodes than exist;
- graph and consensus bases stay inside the alphabet.

A violation raises/returns so the dispatch layer can record a `faults`
entry and re-run the work once on a host kernel (`align/dispatch.py`,
`pipeline._run_fused_device`) — the "one-shot native re-run" of the
resilient-dispatch contract.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import constants as C


class GarbageOutput(RuntimeError):
    """A dispatch result failed an output sanity guard."""


_INT32_BOUND = 1 << 31


def align_result_violation(res, qlen: int, node_n: int,
                           abpt) -> Optional[str]:
    """Invariant check for one AlignResult; None when sane, else a short
    reason string. Never raises. Vectorized: a Python per-op walk over a
    2 kb read's cigar measured ~10% of the warm sim2k wall — the numpy
    pass is three masked reductions."""
    s = res.best_score
    try:
        s = int(s)
    except (TypeError, ValueError):
        return f"non-integer best_score {s!r}"
    if not -_INT32_BOUND < s < _INT32_BOUND:
        return f"best_score {s} outside int32 plane range"
    if res.cigar:
        # prefer the backend-attached ndarray (op totals are order-
        # independent, so a reversed list view is equally valid)
        cig = getattr(res, "cigar_arr", None)
        if cig is None:
            try:
                cig = np.asarray(res.cigar, dtype=np.uint64)
            except (OverflowError, ValueError, TypeError) as e:
                # negative / out-of-range entries are themselves garbage
                # (the bit-flip threat model): a violation, not a crash
                return f"cigar not packable as uint64: {e}"
        ops = (cig & np.uint64(0xF)).astype(np.int64)
        if int(ops.max()) > C.CHARD_CLIP:
            return f"unknown cigar op {int(ops.max())}"
        runs = ((cig >> np.uint64(4)) & np.uint64(0x3FFFFFFF)).astype(
            np.int64)
        is_base = (ops == C.CMATCH) | (ops == C.CDIFF)
        is_qrun = ((ops == C.CINS) | (ops == C.CSOFT_CLIP)
                   | (ops == C.CHARD_CLIP))
        consumed_q = int(is_base.sum() + runs[is_qrun].sum())
        consumed_n = int(is_base.sum() + runs[ops == C.CDEL].sum())
        if consumed_q > qlen:
            return f"cigar consumes {consumed_q} query bases of {qlen}"
        if consumed_n > node_n:
            return f"cigar consumes {consumed_n} graph nodes of {node_n}"
        if abpt.align_mode == C.GLOBAL_MODE and consumed_q != qlen:
            return (f"global-mode cigar consumes {consumed_q} of {qlen} "
                    "query bases")
    return None


def check_graph_bases(base_arr: np.ndarray, m: int) -> None:
    """Alphabet guard over a downloaded fused-loop graph (host array, one
    vectorized min/max). Raises GarbageOutput on violation."""
    if base_arr.size == 0:
        return
    lo, hi = int(base_arr.min()), int(base_arr.max())
    if lo < 0 or hi >= max(m, 5):
        raise GarbageOutput(
            f"graph base range [{lo}, {hi}] outside alphabet of {m}")


def consensus_violation(abc, m: int) -> Optional[str]:
    """Alphabet/shape guard over a ConsensusResult; None when sane."""
    for i, row in enumerate(abc.cons_base):
        arr = np.asarray(row)
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= max(m, 5)):
            return (f"consensus {i} base range [{int(arr.min())}, "
                    f"{int(arr.max())}] outside alphabet of {m}")
    return None
