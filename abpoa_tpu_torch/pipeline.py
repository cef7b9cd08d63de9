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

A failure on the card or in the native build raises; nothing falls back to
another route or graph. The outputs are read out of the host graph at the
end.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import IO, List, Optional

import numpy as np

from .align.dispatch import align_sequence_to_graph
from .align.eligibility import fused_eligible
from .align.result import AlignResult
from .cons.consensus import ConsensusResult, generate_consensus
from .cons.msa import generate_rc_msa
from .graph import POAGraph
from .io.fastx import read_fastx
from .io.output import generate_gfa, output_fx_consensus, output_rc_msa
from .params import Params, plain_route
from .quarantine import validate_records


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


def poa(ab: Abpoa, abpt: Params, seqs: List[np.ndarray], weights: List[np.ndarray],
        exist_n_seq: int) -> None:
    """Plain progressive POA, input order (src/abpoa_align.c:313-353), with
    the `-s` reverse-complement retry for weakly aligned reads."""
    g = ab.graph
    for i, (qseq, weight) in enumerate(zip(seqs, weights)):
        qlen = len(qseq)
        read_id = exist_n_seq + i
        res = AlignResult()
        if g.node_n > 2:
            res = align_sequence_to_graph(g, abpt, qseq)
            if (abpt.amb_strand and res.best_score
                    < min(qlen, g.node_n - 2) * abpt.max_mat * 0.3333):
                rc_qseq = _rc_encode(qseq)
                rc_res = align_sequence_to_graph(g, abpt, rc_qseq)
                if rc_res.best_score > res.best_score:
                    res = rc_res
                    qseq, weight = rc_qseq, weight[::-1].copy()
                    ab.is_rc[read_id] = True
        g.add_alignment(abpt, qseq, weight, res.cigar, True, read_id)


def want_native(abpt: Params, fused: bool = False) -> bool:
    """The twin of `abpoa_tpu/pipeline.py:193` `_want_native`, applied to
    the route instead of the device name, so it is the same on every
    device: the native host graph for the per-read and seeded routes,
    except with Z-drop and `-G` (whose path scores are read from the
    Python graph's nodes), which keep the Python graph as the JAX package
    keeps it for them. The fused route
    keeps its Python graph (it comes back from the card as one)."""
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
                      weights: List[np.ndarray], exist_n_seq: int = 0) -> None:
    """The fused route (abpoa_tpu/pipeline.py:116-190 without the probe,
    breaker, admission and fallback): progressive POA on the device, from
    the graph `-i` restored when it has nodes, then the graph and the new
    reads' strand flags come back to `ab`."""
    from .align.fused_loop import progressive_poa_fused
    init_graph = ab.graph if exist_n_seq and ab.graph.node_n > 2 else None
    pg, _, is_rc = progressive_poa_fused(seqs, weights, abpt,
                                         init_graph=init_graph)
    ab.graph = pg
    if abpt.amb_strand:
        ab.is_rc[exist_n_seq: exist_n_seq + len(is_rc)] = is_rc


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
    ab.cons = native_consensus_hb(ab.graph, ab.n_seq)
    if ab.cons.n_cons == 0:
        print("Warning: no consensus sequence generated.", file=sys.stderr)
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
        g = g.to_python()
    if abpt.out_gfa:
        def consensus() -> ConsensusResult:
            ab.cons = generate_consensus(g, abpt, ab.n_seq)
            return ab.cons
        generate_gfa(g, abpt, ab.names, ab.is_rc, consensus, out_fp)
    elif abpt.out_msa:
        ab.cons = generate_rc_msa(g, abpt, ab.n_seq)
        output_rc_msa(ab.cons, abpt, ab.names, ab.is_rc, out_fp)
    elif abpt.out_cons:
        ab.cons = generate_consensus(g, abpt, ab.n_seq)
        if not g.is_called_cons:
            print("Warning: no consensus sequence generated.", file=sys.stderr)
        output_fx_consensus(ab.cons, abpt, out_fp)
    if abpt.out_pog:
        from .io.plot import dump_pog
        dump_pog(ab, abpt)


def msa(ab: Abpoa, abpt: Params, records, out_fp: IO[str]) -> None:
    """One read set (abpoa_msa1): the restore of `-i`, progressive POA, then
    the outputs. A malformed set raises PoisonedSetError before any work."""
    if not abpt._finalized:
        raise ValueError("call Params.finalize() first")
    validate_records(records)
    seeded = not plain_route(abpt)
    fused = not seeded and fused_eligible(abpt, len(records))
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
        _run_fused_device(ab, abpt, seqs, weights, exist_n_seq)
    else:
        poa(ab, abpt, seqs, weights, exist_n_seq)
    output(ab, abpt, out_fp)


def msa_from_file(ab: Abpoa, abpt: Params, path: str, out_fp: IO[str]) -> None:
    if not (abpt.out_msa or abpt.out_cons or abpt.out_gfa):
        return
    msa(ab, abpt, read_fastx(path), out_fp)
