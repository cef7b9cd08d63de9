"""GAF-style alignment records of the map route (minigraph/vg GAF): a copy
of `abpoa_tpu/io/gaf.py`.

One tab-separated line per read against the static graph:

    qname qlen qstart qend strand path plen pstart pend
    matches block_len mapq  AS:i:<score>  cg:Z:<cigar>

Every field derives from the packed graph cigar (`cigar.py`), the encoded
read and the graph's per-node bases, not from engine-internal state, so
two engines that produce the same cigar produce byte-identical records:
the port's map route and the JAX package's agree where their cigars do.

Conventions (documented, deterministic):
- the graph is node-per-base, so `path` is one ">"-prefixed node id per
  aligned graph base in walk order (M and D ops), and plen == |path| with
  pstart 0, pend plen — the path IS the aligned subwalk;
- `strand` is "+" unless the amb-strand rescue chose the reverse
  complement; qstart/qend and the cigar are on the ALIGNED orientation;
- `matches` recounts M ops whose graph base equals the query base (the
  backtrack folds mismatches into M, reference abPOA semantics), so it
  never trusts a head counter that an oracle path might not fill;
- mapq is 255 (unavailable: map mode does not chain or rescore);
- cg:Z: is the run-merged cigar (M/I/D; X only if a CDIFF op appears).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import constants as C

_OP_CHAR = {C.CMATCH: "M", C.CINS: "I", C.CDEL: "D", C.CDIFF: "X",
            C.CSOFT_CLIP: "S", C.CHARD_CLIP: "H"}


def _unpack(p: int):
    """-> (op, node_id, query_id, run_len) for one packed entry; fields
    that the op does not carry come back as -1/run_len semantics per
    cigar.py's packing table."""
    op = p & 0xF
    if op in (C.CMATCH, C.CDIFF):
        return op, p >> 34, (p >> 4) & 0x3FFFFFFF, 1
    if op == C.CDEL:
        return op, p >> 34, -1, (p >> 4) & 0x3FFFFFFF
    # I/S/H: query_id << 34 | run_len << 4
    return op, -1, p >> 34, (p >> 4) & 0x3FFFFFFF


def merged_cigar_str(cigar: List[int]) -> str:
    """Run-merged cigar text (`2300M12I1D...`) from the packed per-base
    list — the cg:Z: tag body. Empty cigar renders as "*"."""
    if not cigar:
        return "*"
    out: List[str] = []
    run_op, run_len = None, 0
    for p in cigar:
        op, _nid, _qid, ln = _unpack(p)
        ch = _OP_CHAR[op]
        if ch == run_op:
            run_len += ln
        else:
            if run_op is not None:
                out.append(f"{run_len}{run_op}")
            run_op, run_len = ch, ln
    out.append(f"{run_len}{run_op}")
    return "".join(out)


def gaf_record(qname: str, query: np.ndarray, res,
               base_by_nid: np.ndarray, strand: str = "+",
               comment: Optional[str] = None) -> str:
    """One GAF line for `res` (AlignResult with a packed cigar) of encoded
    read `query` (aligned orientation). `base_by_nid` maps node id ->
    encoded base (StaticGraphTables.base_by_nid)."""
    qlen = len(query)
    cigar = res.cigar or []
    path: List[str] = []
    matches = 0
    block_len = 0
    qstart, qend = -1, -1
    for p in cigar:
        op, nid, qid, ln = _unpack(p)
        block_len += ln
        if op in (C.CMATCH, C.CDIFF):
            path.append(f">{nid}")
            if qstart < 0:
                qstart = qid
            qend = qid + 1
            if 0 <= qid < qlen and nid < len(base_by_nid) \
                    and int(base_by_nid[nid]) == int(query[qid]):
                matches += 1
        elif op == C.CDEL:
            path.extend(f">{nid}" for _ in range(ln))
    plen = len(path)
    if qstart < 0:
        # no aligned base: an unmapped-style record, path "*"
        qstart = qend = 0
    fields = [
        qname, str(qlen), str(qstart), str(qend), strand,
        "".join(path) if path else "*",
        str(plen), "0", str(plen),
        str(matches), str(block_len), "255",
        f"AS:i:{int(res.best_score)}",
        f"cg:Z:{merged_cigar_str(cigar)}",
    ]
    if comment:
        fields.append(f"co:Z:{comment}")
    return "\t".join(fields)
