"""`warm`: build or load the kernel library and launch each of its entry
points once at a tier's shapes.

Counterpart of `abpoa_tpu/compile/warm.py` with the tiers of
`abpoa_tpu/compile/ladder.py`. The JAX package precompiles its jit
signatures into XLA's persistent cache; the port compiles nothing at run
time, and its one cache is the library `kernels/build.py` names by the
sources' hash. So warming means: build the library if it is not on disk
(or load it), then launch every C entry point once on seeded synthetic
reads, so that the CUDA context, the module load and each kernel's first
launch are paid before the run that matters.

Tiers (`TIERS`):

- quick: 2 kb reads (tests/data/sim2k.fa's shape): B1 (`abpoa_fused_dp`),
  X1 (`abpoa_backtrack`), F1 (`abpoa_fuse_alignment`), S1
  (`abpoa_finish_fusion`) and K1 (`abpoa_topo_sort`) along the fused
  loop's collision path on a one-read graph, B2 (`abpoa_banded_dp`) and
  X1w (`abpoa_backtrack_windows`) for the per-read route, B2u
  (`abpoa_unbanded_dp`) with `-b -1`: one launch each.
- full: the quick steps at the 10 kb headline's shape (W 512), the lane
  forms (a device lockstep of two sets: B1, X1 and S1 over two lanes) and
  the window form (one B2 launch over 8 windows of a read).

Each launch is counted by its wrapper's `.launches`; the summary gives
them by entry point. The library's load is the report's build and load log
record (`obs/compile_log.py`): a miss with nvcc's seconds when it was
built, a hit when it was on disk. The summary keeps JAX's keys, with
`nvcc_build_s` where JAX has `xla_compile_s`.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np


class WarmAnchor(NamedTuple):
    """One shape to warm: its name, the read length, the steps to run
    there (`_STEPS`) and the fused step's band width (None: the
    planner's)."""
    name: str
    qmax: int
    steps: Tuple[str, ...]
    W: Optional[int] = None


_SINGLE = ("fused", "per_read", "unbanded")

QUICK_TIER = (WarmAnchor("sim2k", 2000, _SINGLE),)
FULL_TIER = QUICK_TIER + (
    WarmAnchor("headline10k", 10000, _SINGLE + ("lanes", "windows"),
               W=512),)
TIERS = {"quick": QUICK_TIER, "full": FULL_TIER}

def launch_counts() -> dict:
    """Launches so far by C entry point: the sum of the `.launches` of the
    wrappers that launch it (single-set and lane forms)."""
    from ..align import backtrack_kernel as x1
    from ..align import banded_kernel as b2
    from ..align import edge_sort_kernel as s1
    from ..align import fuse_kernel as f1
    from ..align import fused_dp_kernel as b1
    from ..align import topo_kernel as k1
    return {
        "abpoa_fused_dp": b1.fused_dp.launches + b1.fused_dp_lanes.launches,
        "abpoa_backtrack": x1.backtrack.launches + x1.backtrack_lanes.launches,
        "abpoa_fuse_alignment": f1.fuse_alignment_lanes.launches,
        "abpoa_finish_fusion": (s1.edge_sort.launches
                                + s1.finish_fusion_lanes_.launches),
        "abpoa_topo_sort": k1.topo_sort.launches + k1.topo_sort_lanes.launches,
        "abpoa_banded_dp": b2.banded_dp.launches,
        "abpoa_unbanded_dp": b2.unbanded_dp.launches,
        "abpoa_backtrack_windows": x1.backtrack_windows.launches,
    }


def synthetic_reads(qmax: int, n: int, seed: int = 7, err: float = 0.05):
    """n reads of a random reference of length qmax, as 0..3 codes, with
    substitutions, insertions and deletions at rate `err`."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, qmax)
    reads = []
    for _ in range(n):
        x = rng.random(qmax)
        is_sub = x < err * 0.4
        is_ins = (x >= err * 0.4) & (x < err * 0.7)
        is_del = (x >= err * 0.7) & (x < err)
        first = np.where(is_sub, (ref + rng.integers(1, 4, qmax)) % 4, ref)
        pair = np.stack([first, rng.integers(0, 4, qmax)], 1)
        keep = np.stack([~is_del, is_ins], 1)
        reads.append(pair[keep].astype(np.uint8))
    return reads


def _chain_graph(abpt, read):
    """The graph of one read (node id = position + 2), sorted."""
    from ..graph import POAGraph
    pg = POAGraph()
    pg.add_alignment(abpt, read, np.ones(len(read), dtype=np.int64), [],
                     True, 0)
    pg.topological_sort(abpt)
    return pg


def _fused_step(abpt, reads, W: Optional[int] = None) -> None:
    """The fused loop's collision path for the second read against the
    first read's graph: B1, X1, F1, S1 and K1, one launch each, at band
    width W (default the planner's)."""
    import torch

    from ..align import fused_loop as fl
    from ..align.buckets import plan_chunk_buckets
    from ..align.fuse_kernel import fuse_alignment_lanes, lane_graph
    from ..align.oracle import (INT16_MIN, INT32_MIN, dp_inf_min,
                                int16_score_limit, max_score_bound)
    dev = abpt.torch_device
    qmax = max(len(r) for r in reads)
    Qp, W_plan, local = plan_chunk_buckets(abpt, qmax)
    W = W or W_plan
    pg = _chain_graph(abpt, reads[0])
    N, E, A = fl.restored_caps(pg, qmax)
    st = fl.state_from_host_graph(pg, N, E, A, dev)
    mat = np.ascontiguousarray(abpt.mat.astype(np.int32))
    seqs, wgts, lens, qp = fl._pad_read_set(
        reads, [np.ones(len(r), dtype=np.int64) for r in reads], Qp, mat,
        abpt.m)
    plane16 = max_score_bound(abpt, qmax, 2) <= int16_score_limit(abpt)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    run = fl._Run(abpt=abpt, seqs=to(seqs), wgts=to(wgts),
                  lens=lens.tolist(), qp=to(qp), mat=to(mat), W=W,
                  max_ops=N + Qp + 8, plane16=plane16,
                  inf=dp_inf_min(abpt, INT16_MIN if plane16 else INT32_MIN),
                  local=local, extend=False, zdrop_on=False,
                  int16_limit=int16_score_limit(abpt))
    tables = fl._build_tables(st.g, st.order, st.n2i, st.remain)
    qlen = int(lens[1])
    fwd_op, fwd_arg, n_fwd, *_ = fl._align_strand(run, st, tables,
                                                  run.seqs[1], run.qp[1],
                                                  qlen)
    g1, _, _ = fuse_alignment_lanes(
        fl._stacked(st.g), fwd_op[None], fwd_arg[None], n_fwd.reshape(1),
        run.seqs[1][None], run.wgts[1][None], fl._host_ints([qlen], dev), 1)
    g2 = fl._finish_fusion(lane_graph(g1, 0), st.g)
    ok = fl._kahn(g2)[7]
    if not fl._sync_read(ok)[0]:
        raise RuntimeError("warm: the Kahn repair of the warm graph failed")


def _per_read_step(abpt, reads) -> None:
    """The per-read route's DP of the second read against the first read's
    graph: B2 and X1w."""
    from ..align.dispatch import align_sequence_to_graph
    align_sequence_to_graph(_chain_graph(abpt, reads[0]), abpt, reads[1])


def _unbanded_step(abpt, reads) -> None:
    """B2u (`-b -1`) on the same read and graph: one whole-row launch (its
    walk is X1w's, which the per-read step launched already)."""
    from .. import constants as C
    from ..align.banded import run_windows
    from ..align.banded_kernel import check_ok
    from ..align.tables import build_row_tables, initial_band_width
    from ..params import Params
    p = Params()
    p.device, p.wb = abpt.device, -1
    p = p.finalize()
    g = _chain_graph(p, reads[0])
    tabs = [build_row_tables(g, C.SRC_NODE_ID, C.SINK_NODE_ID, p)]
    _, out = run_windows(p, tabs, [reads[1]],
                         initial_band_width(p, len(reads[1])))
    if not check_ok(out[7])[0]:
        raise RuntimeError("warm: the whole-row launch overflowed")


def _lanes_step(abpt, reads) -> None:
    """The device lockstep of two sets of two reads: B1, X1 and S1 over
    two lanes."""
    from ..align.fused_lanes import progressive_poa_fused_batch
    ones = [np.ones(len(r), dtype=np.int64) for r in reads]
    progressive_poa_fused_batch([reads[:2], reads[2:4]],
                                [ones[:2], ones[2:4]], abpt)


def _windows_step(abpt, reads, n_win: int = 8) -> None:
    """One B2 launch over n_win windows of the second read, each against
    the first read's graph between the nodes around its span (the seeded
    route's window form), and X1w over them."""
    from .. import constants as C
    from ..align.dispatch import align_windows
    ref, q = reads[0], reads[1]
    cuts = np.linspace(0, len(ref), n_win + 1).astype(int)
    qcuts = np.linspace(0, len(q), n_win + 1).astype(int)
    windows = []
    for i in range(n_win):
        lo, hi = cuts[i], cuts[i + 1]
        beg = C.SRC_NODE_ID if lo == 0 else int(lo) + 1
        end = C.SINK_NODE_ID if hi == len(ref) else int(hi) + 2
        windows.append((beg, end, q[qcuts[i]:qcuts[i + 1]]))
    align_windows(_chain_graph(abpt, ref), abpt, windows)


_STEPS = {
    "fused": lambda abpt, reads, a: _fused_step(abpt, reads, a.W),
    "per_read": lambda abpt, reads, a: _per_read_step(abpt, reads),
    "unbanded": lambda abpt, reads, a: _unbanded_step(abpt, reads),
    "lanes": lambda abpt, reads, a: _lanes_step(abpt, reads),
    "windows": lambda abpt, reads, a: _windows_step(abpt, reads),
}


def _run_steps(tier: str, abpt, records: list, verbose: bool) -> None:
    """Each anchor's steps of `tier`, one record a step."""
    import sys

    import torch
    for anchor in TIERS[tier]:
        reads = synthetic_reads(anchor.qmax, 4)
        for step in anchor.steps:
            c0 = launch_counts()
            t_s = time.perf_counter()
            _STEPS[step](abpt, reads, anchor)
            torch.cuda.synchronize(abpt.torch_device)
            got = {e: n - c0[e] for e, n in launch_counts().items()
                   if n > c0[e]}
            rec = {"anchor": anchor.name, "qmax": anchor.qmax, "step": step,
                   "launches": got,
                   "wall_s": round(time.perf_counter() - t_s, 6)}
            records.append(rec)
            if verbose:
                print(f"[warm] {anchor.name} {step}: {got} "
                      f"{rec['wall_s']:.3f} s", file=sys.stderr)


def warm_ladder(tier: str = "quick", abpt=None, verbose: bool = False) -> dict:
    """Warm the tier on abpt's card (default: a cuda Params). Returns JAX's
    summary keys (abpoa_tpu/compile/warm.py:85) with the port's meanings:
    {tier, signatures (entry points launched), compiled (library builds),
    cache_hits and persistent_cache_hits (loads of a library already on
    disk), nvcc_build_s (in place of xla_compile_s), wall_s, cache_dir (the
    build directory), records (one a step)}, plus `launches` and
    `by_entry`, the launches by entry point. Raises where the card or a
    launch fails: the steps run with the resilience envelope off, so that
    a kernel that fails is an error here, never a retry or a fallback."""
    from .. import resilience as rz
    from ..obs import compile_log
    from . import build
    if abpt is None:
        from ..params import Params
        abpt = Params().finalize()
    if abpt.torch_device.type != "cuda":
        raise RuntimeError("warm: the kernels launch on a CUDA card only "
                           f"(device {abpt.torch_device})")
    t0 = time.perf_counter()
    n_rec = len(compile_log.run_records())
    build.load()
    before = launch_counts()
    records = []
    was = rz.enabled()
    rz.set_enabled(False)
    try:
        _run_steps(tier, abpt, records, verbose)
    finally:
        rz.set_enabled(was)
    loads = compile_log.run_records()[n_rec:]
    by_entry = {e: n - before[e] for e, n in launch_counts().items()}
    built = sum(1 for r in loads if not r["cache_hit"])
    return {
        "tier": tier,
        "signatures": sum(1 for n in by_entry.values() if n),
        "compiled": built,
        "cache_hits": len(loads) - built,
        "persistent_cache_hits": len(loads) - built,
        "nvcc_build_s": round(sum(r.get("nvcc_build_s") or 0.0
                                  for r in loads), 3),
        "wall_s": round(time.perf_counter() - t0, 3),
        "cache_dir": build.BUILD_DIR,
        "records": records,
        "launches": sum(by_entry.values()),
        "by_entry": by_entry,
    }
