"""Incremental MSA (`-i`): rebuild the POA graph from an abPOA GFA or an MSA
FASTA (with '-' gaps), so new reads can be aligned onto it.

Counterpart of `abpoa_tpu/io/restore.py` (abPOA src/abpoa_seq.c:385-673),
for this package's `POAGraph`; a native graph (`native/`) is loaded with
the parsed graph in one call, since a call through ctypes an edge costs
more than the Python graph's method (PERF.md §6). Each restored path or
row becomes a read of
`ab` (name, empty sequence) with its strand flag; its edges carry its read
id when `Params.use_read_ids` is set.
"""
from __future__ import annotations

from typing import Dict, List

from .. import constants as C
from ..convert import graph_to_numpy
from ..graph import POAGraph
from ..params import Params
from .fastx import _open


def _segment_nodes(g, encode, seq: str):
    """One node per base of a segment's sequence: (first id, last id)."""
    in_id = out_id = -1
    for i, ch in enumerate(seq):
        nid = g.add_node(int(encode[ord(ch)]))
        if i == 0:
            in_id = nid
        out_id = nid
    return in_id, out_id


def _append_restored(ab, name: str, is_rc: bool) -> None:
    ab.names.append(name)
    ab.comments.append("")
    ab.quals.append(None)
    ab.seqs.append("")
    ab.is_rc.append(is_rc)


def _parse_gfa(ab, abpt: Params, lines: List[str]) -> None:
    """S lines are segments; each P line is a read's path over them, all of
    one strand (abpoa_seq.c:385-570)."""
    g = ab.graph
    segs: Dict[str, str] = {}
    seg_in_id: Dict[str, int] = {}
    seg_out_id: Dict[str, int] = {}
    rid = abpt.use_read_ids
    encode = abpt.char_to_code
    p_i = -1
    for line in lines:
        if line.startswith("S\t"):
            toks = line.split("\t")
            if len(toks) < 3:
                raise ValueError(f"bad GFA S-line: {line}")
            if toks[1] in segs:
                raise ValueError(f"Duplicated segment: {toks[1]}")
            segs[toks[1]] = toks[2]
        elif line.startswith("P\t"):
            p_i += 1
            toks = line.split("\t")
            if len(toks) < 3:
                raise ValueError(f"bad GFA P-line: {line}")
            path_name = toks[1]
            is_rc = -1
            last_id = C.SRC_NODE_ID
            next_id = C.SINK_NODE_ID
            for item in toks[2].split(","):
                sign, name = item[-1], item[:-1]
                if name not in segs:
                    raise ValueError(f"segment {name} not in GFA")
                strand = 0 if sign == "+" else 1
                if is_rc == 1 - strand:
                    raise ValueError(f"path {path_name} mixes strands")
                is_rc = strand
                if name not in seg_in_id:
                    seg_in_id[name], seg_out_id[name] = _segment_nodes(
                        g, encode, segs[name])
                in_id, out_id = seg_in_id[name], seg_out_id[name]
                if strand == 0:
                    g.add_edge(last_id, in_id, True, 1, rid, p_i)
                else:
                    g.add_edge(out_id, next_id, True, 1, rid, p_i)
                for i in range(out_id - in_id):
                    g.add_edge(in_id + i, in_id + i + 1, True, 1, rid, p_i)
                if strand == 0:
                    last_id = out_id
                else:
                    next_id = in_id
            if is_rc == 1:
                g.add_edge(C.SRC_NODE_ID, next_id, True, 1, rid, p_i)
            else:
                g.add_edge(last_id, C.SINK_NODE_ID, True, 1, rid, p_i)
            _append_restored(ab, path_name, is_rc == 1)


def _parse_msa_fa(ab, abpt: Params, records) -> None:
    """MSA FASTA with '-' gaps: a column's bases share a node, or an aligned
    node where they differ (abpoa_seq.c:572-606)."""
    g = ab.graph
    rid = abpt.use_read_ids
    encode = abpt.char_to_code
    rank2node_id: List[int] = []
    for p_i, (name, seq) in enumerate(records):
        if not rank2node_id:
            rank2node_id = [0] * len(seq)
        last_id = C.SRC_NODE_ID
        for rank, ch in enumerate(seq):
            if ch == "-":
                continue
            base = int(encode[ord(ch)])
            cur_id = rank2node_id[rank]
            if cur_id == 0:
                cur_id = g.add_node(base)
                rank2node_id[rank] = cur_id
            elif g.nodes[cur_id].base != base:
                aln_id = g.get_aligned_id(cur_id, base)
                if aln_id == -1:
                    aln_id = g.add_node(base)
                    g.add_aligned_node(cur_id, aln_id)
                cur_id = aln_id
            g.add_edge(last_id, cur_id, True, 1, rid, p_i)
            last_id = cur_id
        g.add_edge(last_id, C.SINK_NODE_ID, True, 1, rid, p_i)
        _append_restored(ab, name, False)


def restore_graph(ab, abpt: Params) -> None:
    """Restore `abpt.incr_fn` into `ab`, whose graph must be empty
    (abpoa_seq.c:608-673): a file with a '>' line is an MSA, else a GFA."""
    fn = abpt.incr_fn
    if not fn:
        return
    target = ab.graph
    if getattr(target, "is_native", False):
        ab.graph = POAGraph()
    with _open(fn) as fp:
        lines = [ln.rstrip("\n") for ln in fp]
    if any(ln.startswith(">") for ln in lines if ln):
        records = []
        name = None
        seq_parts: List[str] = []
        for ln in lines:
            if ln.startswith(">"):
                if name is not None and seq_parts:
                    records.append((name, "".join(seq_parts)))
                name = ln[1:].split()[0] if len(ln) > 1 else ""
                seq_parts = []
            elif ln:
                seq_parts.append(ln)
        if name is not None:
            records.append((name, "".join(seq_parts)))
        _parse_msa_fa(ab, abpt, records)
    else:
        _parse_gfa(ab, abpt, lines)
    if ab.n_seq == 0:
        # on stdout, as abPOA and the JAX package print it
        print(f"Warning: no graph/sequence restored from '{fn}'.")
    g = ab.graph
    g.is_called_cons = g.is_set_msa_rank = g.is_topological_sorted = False
    if target is not g:
        target.load_arrays(graph_to_numpy(g))
        ab.graph = target
