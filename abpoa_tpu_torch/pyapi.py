"""pyabpoa-compatible Python API on the port.

Counterpart of `abpoa_tpu/pyapi.py` (abPOA python/pyabpoa.pyx):
`msa_aligner` with the one-shot `msa()`, the incremental `msa_align()` /
`msa_add()` / `msa_output()` and `msa_batch()`, returning `msa_result`
objects. Like the binding, it aligns one read, fuses it, and goes on to the
next: each read is aligned by kernel B2 on the aligner's device (the
per-read route, `align/banded.py`, with its backtrack X1w) and fused into
the native host graph (`native/`), as the CLI's per-read route does, in
global, local (`aln_mode="l"`) or extend (`"e"`) mode with linear, affine
or convex gaps.

`msa_batch` runs the sets the lockstep route covers in split lockstep
(`parallel/lockstep.py`: one K-lane B2 launch a round, each set's fusion
on its own native graph) where `lockstep` allows it ("auto": on the card),
and the others one `msa()` after another; the results equal `msa()`'s set
by set either way. `device` defaults to "cuda" (the port's rule: the card
unless the caller asks for the CPU). The JAX package's `last_report`
telemetry is ROADMAP.md queue A, item 10.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import constants as C
from .align.dispatch import align_sequence_to_graph
from .cons.consensus import (ConsensusResult, generate_consensus,
                             native_consensus_hb, native_hb_eligible)
from .cons.msa import generate_rc_msa
from .params import Params
from .pipeline import Abpoa, _select_graph, want_native
from .quarantine import QUARANTINE_EXCEPTIONS, PoisonedSetError, quarantine_set


class msa_result:
    def __init__(self, n_seq, n_cons, clu_n_seq, clu_read_ids, cons_len,
                 cons_seq, cons_cov, cons_qv, msa_len, msa_seq):
        self.n_seq = n_seq
        self.n_cons = n_cons
        self.clu_n_seq = clu_n_seq
        self.clu_read_ids = clu_read_ids
        self.cons_len = cons_len
        self.cons_seq = cons_seq
        self.cons_cov = cons_cov
        self.cons_qv = cons_qv
        self.msa_len = msa_len
        self.msa_seq = msa_seq

    def print_msa(self) -> None:
        if not self.msa_seq:
            return
        for i, s in enumerate(self.msa_seq):
            if i < self.n_seq:
                print(f">Seq_{i + 1}")
            else:
                cons_id = ""
                if self.n_cons > 1:
                    ids = ",".join(map(str, self.clu_read_ids[i - self.n_seq]))
                    cons_id = f"_{i - self.n_seq + 1} {ids}"
                print(f">Consensus_sequence{cons_id}")
            print(s)


def _text(x) -> str:
    return x if isinstance(x, str) else x.decode()


class msa_aligner:
    def __init__(self, aln_mode="g", is_aa=False, match=2, mismatch=4,
                 score_matrix="", gap_open1=4, gap_open2=24, gap_ext1=2,
                 gap_ext2=1, extra_b=10, extra_f=0.01, cons_algrm="HB",
                 device="cuda", lockstep="auto"):
        abpt = Params()
        modes = {"g": C.GLOBAL_MODE, "l": C.LOCAL_MODE, "e": C.EXTEND_MODE}
        if aln_mode not in modes:
            raise ValueError(f"Unknown alignment mode: {aln_mode}")
        abpt.align_mode = modes[aln_mode]
        if is_aa:
            abpt.m = 27
        abpt.match = match
        abpt.mismatch = mismatch
        if score_matrix:
            abpt.use_score_matrix = True
            abpt.mat_fn = _text(score_matrix)
        abpt.gap_open1, abpt.gap_open2 = gap_open1, gap_open2
        abpt.gap_ext1, abpt.gap_ext2 = gap_ext1, gap_ext2
        abpt.wb, abpt.wf = extra_b, extra_f
        if cons_algrm.upper() == "MF":
            abpt.cons_algrm = C.CONS_MF
        elif cons_algrm.upper() == "HB":
            abpt.cons_algrm = C.CONS_HB
        else:
            raise ValueError(f"Unknown consensus algorithm: {cons_algrm}")
        abpt.device = device
        abpt.lockstep = lockstep
        self.abpt = abpt
        self.ab = Abpoa()

    # ------------------------------------------------------------- internals
    def _encode(self, seqs: List[str], qscores):
        """One set's reads encoded, with their weights (ones without
        qscores), after the binding's input checks."""
        enc = self.abpt.char_to_code
        if qscores is not None and len(qscores) != len(seqs):
            raise ValueError("qscores must contain one entry per input sequence.")
        bseqs, weights = [], []
        for read_i, seq in enumerate(seqs):
            if not seq:
                raise PoisonedSetError(f"sequence {read_i} is empty")
            bseqs.append(enc[np.frombuffer(seq.encode(), dtype=np.uint8)
                             ].astype(np.uint8))
            if qscores is None:
                weights.append(np.ones(len(seq), dtype=np.int64))
                continue
            q = np.asarray(qscores[read_i], dtype=np.int64)
            if len(q) != len(seq):
                raise ValueError(
                    "Each qscore array must have the same length as its sequence.")
            if (q < 0).any():
                raise ValueError("Qscores must be non-negative integers.")
            weights.append(q)
        return bseqs, weights

    def _add_sequences(self, seqs: List[str], qscores, exist_n: int) -> None:
        abpt = self.abpt
        g = self.ab.graph
        bseqs, weights = self._encode(seqs, qscores)
        for read_i, (seq, bseq, w) in enumerate(zip(seqs, bseqs, weights)):
            res = align_sequence_to_graph(g, abpt, bseq)
            g.add_alignment(abpt, bseq, w, res.cigar, True, exist_n + read_i)
            self.ab.append_read(seq=seq)

    def _collect(self, n_seq: int, ab: Abpoa = None) -> msa_result:
        abpt = self.abpt
        ab = ab or self.ab
        g = ab.graph
        if native_hb_eligible(g, abpt):
            abc = native_consensus_hb(g, n_seq)
        else:
            if getattr(g, "is_native", False):
                g = g.to_python()
            if abpt.out_msa:
                abc = generate_rc_msa(g, abpt, n_seq)
            elif abpt.out_cons:
                abc = generate_consensus(g, abpt, n_seq)
            else:
                abc = ConsensusResult(n_seq=n_seq)
        decode = abpt.code_to_char
        cons_seq = ["".join(chr(decode[b]) for b in row) for row in abc.cons_base]
        cons_qv = ["".join(chr(q) for q in row) for row in abc.cons_phred]
        msa_seq = []
        if abc.msa_len > 0:
            for row in abc.msa_base:
                msa_seq.append("".join(chr(decode[b]) for b in row))
        ab.cons = abc
        return msa_result(n_seq, abc.n_cons, list(abc.clu_n_seq),
                          [list(x) for x in abc.clu_read_ids], abc.cons_len,
                          cons_seq, [list(c) for c in abc.cons_cov], cons_qv,
                          abc.msa_len, msa_seq)

    def _prepare(self, out_cons, out_msa, max_n_cons, min_freq, incr_fn,
                 qscores) -> int:
        """Set the outputs, finalize, empty the graph and restore `incr_fn`
        into it; returns the restored reads."""
        abpt = self.abpt
        abpt.out_cons = bool(out_cons)
        abpt.out_msa = bool(out_msa)
        if not 1 <= max_n_cons <= 2:
            raise Exception("Error: max number of consensus sequences should be 1 or 2.")
        abpt.max_n_cons = max_n_cons
        abpt.min_freq = min_freq
        abpt.use_qv = qscores is not None
        abpt.incr_fn = _text(incr_fn) if incr_fn else None
        abpt.finalize()
        _select_graph(self.ab, want_native(abpt))
        self.ab.reset()
        if abpt.incr_fn:
            from .io.restore import restore_graph
            restore_graph(self.ab, abpt)
        return self.ab.n_seq

    # ------------------------------------------------------------ public API
    def msa(self, seqs, out_cons, out_msa, max_n_cons=1, min_freq=0.25,
            out_pog="", incr_fn="", qscores=None) -> msa_result:
        abpt = self.abpt
        abpt.out_pog = _text(out_pog) or None
        exist_n = self._prepare(out_cons, out_msa, max_n_cons, min_freq,
                                incr_fn, qscores)
        self._add_sequences(seqs, qscores, exist_n)
        result = self._collect(exist_n + len(seqs))
        if abpt.out_pog:
            from .io.plot import dump_pog
            dump_pog(self.ab, abpt)
        return result

    def msa_batch(self, seq_sets, out_cons, out_msa, max_n_cons=1,
                  min_freq=0.25, qscores_sets=None) -> List[msa_result]:
        """Independent read sets (abpoa_tpu/pyapi.py:216-389): the sets the
        lockstep route covers (`parallel.lockstep_covers`) in split
        lockstep, one group a query rung (`flush_lockstep_group`); the
        others one `msa()` after another. Each result equals `msa()`'s on
        its set. A set that fails its input checks is quarantined: None in
        its slot, one stderr line, and the rest complete."""
        from .parallel import flush_lockstep_group, lockstep_covers
        if qscores_sets is not None and len(qscores_sets) != len(seq_sets):
            raise ValueError("qscores_sets must contain one entry per set.")
        self._prepare(out_cons, out_msa, max_n_cons, min_freq, "",
                      qscores_sets)
        group = []   # (set index, Abpoa, encoded reads, weights)
        for k, seqs in enumerate(seq_sets):
            if not all(seqs) or not lockstep_covers(self.abpt, len(seqs)):
                continue  # msa() runs it (and quarantines an empty read)
            ab = Abpoa()
            for seq in seqs:
                ab.append_read(seq=seq)
            qs = qscores_sets[k] if qscores_sets is not None else None
            group.append((k, ab, *self._encode(seqs, qs)))
        done = flush_lockstep_group(group, self.abpt)
        results: List[msa_result] = [None] * len(seq_sets)
        for k, seqs in enumerate(seq_sets):
            if k in done:
                results[k] = self._collect(len(seqs), ab=done[k])
                continue
            qs = qscores_sets[k] if qscores_sets is not None else None
            try:
                results[k] = self.msa(seqs, out_cons, out_msa, max_n_cons,
                                      min_freq, qscores=qs)
            except QUARANTINE_EXCEPTIONS as e:
                quarantine_set(k, f"set {k}", e)
        return results

    def msa_align(self, seqs, out_cons, out_msa, max_n_cons=1, min_freq=0.25,
                  incr_fn="", qscores=None) -> "msa_aligner":
        exist_n = self._prepare(out_cons, out_msa, max_n_cons, min_freq,
                                incr_fn, qscores)
        self._add_sequences(seqs, qscores, exist_n)
        return self

    def msa_add(self, new_seqs, qscores=None) -> "msa_aligner":
        if isinstance(new_seqs, str):
            raise TypeError(
                'Expected a list of strings. If you want to add a single sequence, '
                'pass it as a list: ["ACGT..."]')
        exist_n = self.ab.n_seq
        if exist_n == 0:
            raise Exception("Error: no existing sequences in the graph. "
                            "Please run msa() or msa_align() first.")
        if qscores is not None:
            self.abpt.use_qv = True
        self._add_sequences(new_seqs, qscores, exist_n)
        return self

    def msa_output(self) -> msa_result:
        return self._collect(self.ab.n_seq)
