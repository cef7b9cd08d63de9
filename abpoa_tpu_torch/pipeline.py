"""Progressive POA in input order and consensus output.

Counterpart of `abpoa_tpu/pipeline.py` (abPOA src/abpoa_align.c: abpoa_poa
:313-353, abpoa_msa1 :474-540, abpoa_output :355-371): consensus, row-column
MSA, GFA and the `-g` graph plot. With `-i` the graph of an earlier MSA or
GFA is restored first (`io/restore.py`) and the new reads are aligned onto
it. Three routes, chosen as the JAX package chooses them:

- the fused route (`_run_fused_device`, whenever `plain_route` and
  `fused_eligible` hold):
  the whole progressive loop runs on the Params' device
  (`align/fused_loop.py`, kernels B1/B3, X1, S1, K1), from the empty graph
  or from the restored one (`-i` without read-id outputs), and the graph is
  downloaded once;
- the per-read route (`poa`): each read is aligned by the DP kernel B2
  and its backtrack X1w on the device and fused into the graph on the
  host, in global, local or extend (Z-drop) mode, banded or not. It takes
  what the JAX package sends to its host engine or to its per-read XLA
  DP: `-G` and `-b < 0` (outside local mode), `-i` with read-id outputs
  (MSA, GFA, `-a 1`, `-d > 1`), `-Q` with `-d > 1` (per-read qv weights),
  and a set of one read, which launches B2 only when `-i` restored a graph
  (the first read of an empty graph becomes the graph as it is);
- the seeded route (`-S` or `-p` in global mode, `seed.anchor_poa_pipeline`):
  the reads in input or guide-tree order, each cut at its minimizer anchors
  into windows that one batched B2 launch aligns (with `-G`'s path scores
  or unbanded where asked), fused into the host graph read by read, from
  the graph `-i` restored when there is one.

The per-read and seeded routes keep the graph in the native host graph
(`native/`, C++: fusion, sort, the DP's tables, the default consensus)
unless Z-drop or `-G` is on, as the JAX package chooses it for its device
routes (`want_native`); the restore of `-i` loads into it. Their backtrack runs on
the device too (X1w), so only the walks' results come back to the host. The
fused route keeps a Python graph.

`--device native` runs the per-read and seeded routes on the C++ host DP
(`align/native_backend.py`); the fused route is not eligible there, as in
the JAX package.

Every route runs under the resilience envelope (`resilience/`), which
absorbs, reports and routes around device faults, under four rules: a
missing or wrong card raises (no `auto` device); a kernel library that
cannot be built or loaded raises (`KernelBuildError`, loaded in the
`backend_init` phase, outside the envelope); every absorbed fault is loud
(a stderr line, a `faults` record, the `degraded` block while a breaker
is open, the `fallback.*`/`breaker.*` counters); and `chip_smoke.py`
fails on any fault it did not inject. The fused route falls back to the
per-read route on the same device (`_run_fused_device`); on the card,
what the card's own recovery cannot absorb raises
`resilience.CardFailure` (rc 1) and never moves to the host.
The outputs are read out of the host graph at the end.

Run telemetry (`obs/`) is taken at the JAX package's call sites and under
its names: the phases `backend_init`, `align_fused`, `align`, `fusion`,
`consensus`, `output` and `graph_export`, the DP cell model (`record_dp`),
one latency record a read (amortised over the fused route's wall there)
and a `read:i` span a read on the per-read route.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import IO, List, Optional

import numpy as np

from . import obs
from .align.dispatch import align_sequence_to_graph, telemetry_backend
from .align.eligibility import fused_eligible
from .align.result import AlignResult
from .cons.consensus import ConsensusResult, generate_consensus
from .cons.msa import generate_rc_msa
from .graph import POAGraph
from .io.fastx import read_fastx
from .io.output import generate_gfa, output_fx_consensus, output_rc_msa
from .params import Params, plain_route
from .resilience.quarantine import validate_records
from . import resilience as rz


@dataclass
class Abpoa:
    """Top-level container (abPOA abpoa_t): graph + sequence metadata."""
    graph: POAGraph = field(default_factory=POAGraph)
    names: List[str] = field(default_factory=list)
    comments: List[str] = field(default_factory=list)
    quals: List[Optional[str]] = field(default_factory=list)
    seqs: List[str] = field(default_factory=list)
    is_rc: List[bool] = field(default_factory=list)
    cons: Optional[ConsensusResult] = None

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    def reset(self) -> None:
        self.graph.reset()
        self.names, self.comments, self.quals = [], [], []
        self.seqs, self.is_rc = [], []
        self.cons = None

    def append_read(self, name: str = "", comment: str = "",
                    qual: Optional[str] = None, seq: str = "") -> None:
        self.names.append(name)
        self.comments.append(comment)
        self.quals.append(qual)
        self.seqs.append(seq)
        self.is_rc.append(False)


def _rc_encode(seq: np.ndarray) -> np.ndarray:
    rc = seq[::-1].copy()
    lt4 = rc < 4
    rc[lt4] = 3 - rc[lt4]
    rc[~lt4] = 4
    return rc


def _band_cols(abpt: Params, qlen: int) -> int:
    """The telemetry's band extent of one read's DP (abpoa_tpu/pipeline.py
    :65): the adaptive band's planned 2w+1 columns, clipped to the query
    when banding is off or wider than the row."""
    if abpt.wb < 0:
        return qlen + 1
    w = abpt.wb + int(abpt.wf * qlen)
    return min(qlen + 1, 2 * w + 1)


def poa(ab: Abpoa, abpt: Params, seqs: List[np.ndarray], weights: List[np.ndarray],
        exist_n_seq: int, fallback: Optional[str] = None) -> None:
    """Plain progressive POA, input order (src/abpoa_align.c:313-353), with
    the `-s` reverse-complement retry for weakly aligned reads. `fallback`
    marks every read's record (the fused route's fallback)."""
    g = ab.graph
    for i, (qseq, weight) in enumerate(zip(seqs, weights)):
        qlen = len(qseq)
        read_id = exist_n_seq + i
        t_read = time.perf_counter()
        res = AlignResult()
        if g.node_n > 2:
            obs.record_dp(g.node_n, _band_cols(abpt, qlen), abpt.gap_mode)
            with obs.phase("align"):
                res = align_sequence_to_graph(g, abpt, qseq)
                if (abpt.amb_strand and res.best_score
                        < min(qlen, g.node_n - 2) * abpt.max_mat * 0.3333):
                    rc_qseq = _rc_encode(qseq)
                    # the rc retry is a second DP of the read
                    obs.record_dp(g.node_n, _band_cols(abpt, qlen),
                                  abpt.gap_mode)
                    rc_res = align_sequence_to_graph(g, abpt, rc_qseq)
                    if rc_res.best_score > res.best_score:
                        res = rc_res
                        qseq, weight = rc_qseq, weight[::-1].copy()
                        ab.is_rc[read_id] = True
        with obs.phase("fusion"):
            g.add_alignment(abpt, qseq, weight, res.cigar, True, read_id)
        dt = time.perf_counter() - t_read
        backend, fb = telemetry_backend(abpt)
        obs.record_read(dt, qlen, _band_cols(abpt, qlen), backend,
                        fallback=fallback or fb)
        obs.trace.add_span(f"read:{read_id}", "read", t_read, dt,
                           args={"qlen": qlen})


def want_native(abpt: Params, fused: bool = False) -> bool:
    """The twin of `abpoa_tpu/pipeline.py:193` `_want_native`, applied to
    the route instead of the device name, so it is the same on every
    device: the native host graph for the per-read and seeded routes,
    except with Z-drop and `-G` (whose path scores are read from the
    Python graph's nodes), which keep the Python graph as the JAX package
    keeps it for them. The fused route
    keeps its Python graph (it comes back from the card as one). With
    `--device native` every route's graph is native, as in JAX: the C++ DP
    reads `-G`'s path scores and runs Z-drop itself."""
    if abpt.device == "native":
        return True
    return not fused and not abpt.inc_path_score and abpt.zdrop <= 0


def _select_graph(ab: Abpoa, native: bool) -> None:
    """Give `ab` the native or the Python graph engine (JAX
    `pipeline.py:309-324`, without its fallback: a failed build raises)."""
    if native and not getattr(ab.graph, "is_native", False):
        from .native.graph import NativePOAGraph
        ab.graph = NativePOAGraph()
    elif not native and getattr(ab.graph, "is_native", False):
        ab.graph = POAGraph()


def _run_fused_device(ab: Abpoa, abpt: Params, seqs: List[np.ndarray],
                      weights: List[np.ndarray], exist_n_seq: int = 0) -> str:
    """The fused route (abpoa_tpu/pipeline.py:116-190): progressive POA on
    the device, from the graph `-i` restored when it has nodes, then the
    graph and the new reads' strand flags come back to `ab`; returns
    "fused". Under the envelope it returns "per_read", the per-read route
    on the same device, where the fused route cannot serve: an open
    breaker (`cpu`), a dispatch that failed (`DispatchFailed`, with its
    warning and the `fallback.fused_to_per_read` count), or a set over the
    admission budget whose per-read planes fit it. On the card a set that
    fits neither route, and a card lost earlier in the run, raise
    `resilience.CardFailure` before any allocation; nothing goes to the
    host."""
    from .align.dispatch import requested_backend
    from .align.fused_loop import plan_dispatch_footprint, progressive_poa_fused
    backend = requested_backend(abpt)
    init_graph = ab.graph if exist_n_seq and ab.graph.node_n > 2 else None
    if rz.enabled():
        rz.check_card(backend)
        if rz.breaker().is_open(backend):
            # the breaker demoted `cpu` for the run: the per-read route on
            # the rung it names, without failing the dispatch again
            obs.count("fallback.fused_breaker_open")
            return "per_read"
        # a set whose footprint is over the budget takes the per-read route
        # before any allocation instead of running out of memory mid-run
        caps = plan_dispatch_footprint(
            abpt, [seqs], n0=init_graph.node_n if init_graph is not None else 0)
        decision, est, budget = rz.memory.admit(caps, abpt.torch_device)
        if decision != "ok":
            per_read = rz.memory.per_read_bytes(caps)
            detail = (f"estimated {est} B fused, {per_read} B per read; "
                      f"budget {budget} B")
            if backend == "cuda" and per_read > budget:
                rz.note_abort("admission", backend, detail)
                raise rz.CardFailure("admission", "the set does not fit the "
                                     f"card in either route ({detail})")
            rz.note_absorbed("admission", backend, "per_read", detail,
                             label="fused_loop")
            obs.count("fallback.admission_per_read")
            return "per_read"
    t0 = time.perf_counter()
    try:
        with obs.phase("align_fused"):
            pg, _, is_rc = rz.guarded_device_call(
                "fused_loop", backend,
                lambda: progressive_poa_fused(seqs, weights, abpt,
                                              init_graph=init_graph))
    except rz.DispatchFailed as e:
        print(f"Warning: fused device loop failed ({e}); "
              "falling back to the per-read loop.", file=sys.stderr)
        obs.count("fallback.fused_to_per_read")
        return "per_read"
    # one latency record a read: the fused wall split evenly over the reads
    # (marked amortized: a share, not a measurement of its own)
    per_read = (time.perf_counter() - t0) / max(1, len(seqs))
    for s in seqs:
        obs.record_read(per_read, len(s), _band_cols(abpt, len(s)),
                        abpt.device, amortized=True)
    ab.graph = pg
    if abpt.amb_strand:
        ab.is_rc[exist_n_seq: exist_n_seq + len(is_rc)] = is_rc
    return "fused"


def _to_per_read_graph(ab: Abpoa, abpt: Params) -> None:
    """After the fused route fell back: the graph the per-read route takes
    (`want_native`), with the restored graph of `-i` carried over."""
    if not want_native(abpt) or getattr(ab.graph, "is_native", False):
        return
    from .convert import graph_to_numpy, native_graph_from_numpy
    if ab.graph.node_n > 2:
        ab.graph = native_graph_from_numpy(graph_to_numpy(ab.graph))
    else:
        _select_graph(ab, True)


def _ingest_records(ab: Abpoa, abpt: Params, records):
    """Append records to `ab` (sorting per `-L`), encode sequences, derive
    qv weights (abpoa_msa1's read/encode block, src/abpoa_align.c:493-506).
    Returns (seqs, weights) for the new reads."""
    exist_n_seq = ab.n_seq
    for rec in records:
        ab.append_read(rec.name, rec.comment, rec.qual, rec.seq)
    n_seq = len(records)
    if abpt.sort_input_seq:
        order = sorted(range(n_seq), key=lambda i: -len(records[i].seq))
        for attr in ("names", "comments", "quals", "seqs"):
            lst = getattr(ab, attr)
            lst[exist_n_seq:] = [lst[exist_n_seq + i] for i in order]

    encode = abpt.char_to_code
    seqs: List[np.ndarray] = []
    weights: List[np.ndarray] = []
    for i in range(n_seq):
        s = ab.seqs[exist_n_seq + i]
        seqs.append(encode[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.uint8))
        qual = ab.quals[exist_n_seq + i]
        if abpt.use_qv and qual:
            weights.append(np.frombuffer(qual.encode(), dtype=np.uint8).astype(np.int64) - 32)
        else:
            weights.append(np.ones(len(s), dtype=np.int64))
    return seqs, weights


def _native_cons_fast_path(ab: Abpoa, abpt: Params, out_fp: IO[str]) -> bool:
    """The default consensus straight from the native graph's C++ heaviest
    bundling (abpoa_tpu/pipeline.py:346), without exporting the graph; False
    where the configuration needs the Python graph."""
    from .cons.consensus import native_consensus_hb, native_hb_eligible
    if not native_hb_eligible(ab.graph, abpt) or abpt.out_gfa or abpt.out_pog:
        return False
    with obs.phase("consensus"):
        ab.cons = native_consensus_hb(ab.graph, ab.n_seq)
    if ab.cons.n_cons == 0:
        print("Warning: no consensus sequence generated.", file=sys.stderr)
    with obs.phase("output"):
        output_fx_consensus(ab.cons, abpt, out_fp)
    return True


def output(ab: Abpoa, abpt: Params, out_fp: IO[str]) -> None:
    """GFA, MSA or consensus output (src/abpoa_align.c:355-371); the
    consensus, where one is made, is kept in `ab.cons`. A native graph gives
    the default consensus itself, and a Python copy to the rest."""
    if _native_cons_fast_path(ab, abpt, out_fp):
        return
    g = ab.graph
    if getattr(g, "is_native", False):
        with obs.phase("graph_export"):
            g = g.to_python()
    if abpt.out_gfa:
        def consensus() -> ConsensusResult:
            ab.cons = generate_consensus(g, abpt, ab.n_seq)
            return ab.cons
        with obs.phase("output"):
            generate_gfa(g, abpt, ab.names, ab.is_rc, consensus, out_fp)
    else:
        with obs.phase("consensus"):
            if abpt.out_msa:
                ab.cons = generate_rc_msa(g, abpt, ab.n_seq)
            elif abpt.out_cons:
                ab.cons = generate_consensus(g, abpt, ab.n_seq)
                if not g.is_called_cons:
                    print("Warning: no consensus sequence generated.",
                          file=sys.stderr)
        with obs.phase("output"):
            if abpt.out_msa:
                output_rc_msa(ab.cons, abpt, ab.names, ab.is_rc, out_fp)
            elif abpt.out_cons:
                output_fx_consensus(ab.cons, abpt, out_fp)
    if abpt.out_pog:
        from .io.plot import dump_pog
        dump_pog(ab, abpt)


def msa(ab: Abpoa, abpt: Params, records, out_fp: IO[str]) -> None:
    """One read set (abpoa_msa1): the restore of `-i`, progressive POA, then
    the outputs. A malformed set raises PoisonedSetError before any work."""
    if not abpt._finalized:
        raise ValueError("call Params.finalize() first")
    validate_records(records, abpt)
    obs.note_device(abpt.torch_device)
    seeded = not plain_route(abpt)
    fused = (not seeded and abpt.device != "native"
             and fused_eligible(abpt, len(records)))
    with obs.phase("backend_init"):
        if abpt.torch_device.type == "cuda":
            # the kernel library is built and loaded here, outside the
            # envelope: a build or load failure raises (KernelBuildError)
            from .kernels import build
            build.load()
        _select_graph(ab, want_native(abpt, fused))
        ab.reset()
    if abpt.incr_fn:
        from .io.restore import restore_graph
        restore_graph(ab, abpt)
    exist_n_seq = ab.n_seq
    seqs, weights = _ingest_records(ab, abpt, records)
    if seeded:
        from .seed import anchor_poa_pipeline
        anchor_poa_pipeline(ab, abpt, seqs, weights, exist_n_seq)
    elif fused:
        if _run_fused_device(ab, abpt, seqs, weights, exist_n_seq) != "fused":
            _to_per_read_graph(ab, abpt)
            poa(ab, abpt, seqs, weights, exist_n_seq, fallback="fused_bypass")
    else:
        poa(ab, abpt, seqs, weights, exist_n_seq)
    output(ab, abpt, out_fp)


def msa_from_file(ab: Abpoa, abpt: Params, path: str, out_fp: IO[str]) -> None:
    if not (abpt.out_msa or abpt.out_cons or abpt.out_gfa):
        return
    msa(ab, abpt, read_fastx(path), out_fp)
