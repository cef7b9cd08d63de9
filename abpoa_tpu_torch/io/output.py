"""Text writers: consensus FASTA/FASTQ, row-column MSA and GFA, byte for
byte as abPOA writes them (src/abpoa_output.c: abpoa_output_fx_consensus
:589-628, abpoa_output_rc_msa :73-104, abpoa_generate_gfa :196-295)."""
from __future__ import annotations

from collections import deque
from typing import IO, Callable, List

from .. import constants as C
from ..cons.consensus import ConsensusResult
from ..graph import POAGraph
from ..params import Params


def _cons_name(abpt: Params, abc: ConsensusResult, cons_i: int) -> str:
    s = "Consensus_sequence"
    if abpt.batch_index > 0:
        s += f"_{abpt.batch_index}"
    if abc.n_cons > 1:
        s += f"_{cons_i + 1} " + ",".join(str(r) for r in abc.clu_read_ids[cons_i])
    return s


def output_fx_consensus(abc: ConsensusResult, abpt: Params, fp: IO[str]) -> None:
    decode = abpt.code_to_char
    for cons_i in range(abc.n_cons):
        lead = "@" if abpt.out_fq else ">"
        fp.write(f"{lead}{_cons_name(abpt, abc, cons_i)}\n")
        fp.write("".join(chr(decode[b]) for b in abc.cons_base[cons_i]) + "\n")
        if abpt.out_fq:
            fp.write(f"+{_cons_name(abpt, abc, cons_i)}\n")
            fp.write("".join(chr(q) for q in abc.cons_phred[cons_i]) + "\n")


def output_rc_msa(abc: ConsensusResult, abpt: Params, names: List[str],
                  is_rc: List[bool], fp: IO[str]) -> None:
    if abc.msa_len <= 0:
        return
    decode = abpt.code_to_char
    for i in range(abc.n_seq):
        if names[i]:
            sfx = "_reverse_complement" if is_rc[i] else ""
            fp.write(f">{names[i]}{sfx}\n")
        else:
            fp.write(f">Seq_{i + 1}\n")
        fp.write("".join(chr(decode[b]) for b in abc.msa_base[i]) + "\n")
    if abpt.out_cons:
        for cons_i in range(abc.n_cons):
            fp.write(">Consensus_sequence")
            if abc.n_cons > 1:
                fp.write(f"_{cons_i + 1} " + ",".join(str(r) for r in abc.clu_read_ids[cons_i]))
            fp.write("\n")
            fp.write("".join(chr(decode[b]) for b in abc.msa_base[abc.n_seq + cons_i]) + "\n")


def generate_gfa(g: POAGraph, abpt: Params, names: List[str], is_rc: List[bool],
                 abc_provider: Callable[[], ConsensusResult], fp: IO[str]) -> None:
    """BFS GFA writer with a P line per read (src/abpoa_output.c:196-295).
    `abc_provider()` makes the consensus, called only with consensus output."""
    if g.node_n <= 2:
        return
    n_seq = len(names)
    decode = abpt.code_to_char
    in_degree = [len(nd.in_ids) for nd in g.nodes]
    read_paths: List[List[int]] = [[] for _ in range(n_seq)]
    nl = sum(len(g.nodes[i].in_ids) for i in range(2, g.node_n))
    fp.write(f"H\tVN:Z:1.0\tNS:i:{g.node_n - 2}\t"
             f"NL:i:{nl - len(g.nodes[C.SRC_NODE_ID].out_ids)}\t"
             f"NP:i:{n_seq + (1 if abpt.out_cons else 0)}\n")
    q: deque[int] = deque([C.SRC_NODE_ID])
    while q:
        cur = q.popleft()
        if cur == C.SINK_NODE_ID:
            break
        node = g.nodes[cur]
        if cur != C.SRC_NODE_ID:
            fp.write(f"S\t{cur - 1}\t{chr(decode[node.base])}\n")
            for pre_id in node.in_ids:
                if pre_id != C.SRC_NODE_ID:
                    fp.write(f"L\t{pre_id - 1}\t+\t{cur - 1}\t+\t0M\n")
            for bits in node.read_ids:
                while bits:
                    lsb = bits & -bits
                    read_paths[lsb.bit_length() - 1].append(cur - 1)
                    bits ^= lsb
        for out_id in node.out_ids:
            in_degree[out_id] -= 1
            if in_degree[out_id] == 0:
                q.append(out_id)
    for i in range(n_seq):
        name = names[i] if names[i] else str(i + 1)
        fp.write(f"P\t{name}\t")
        path = read_paths[i]
        if is_rc[i]:
            fp.write(",".join(f"{p}-" for p in reversed(path)) + "\t*\n")
        else:
            fp.write(",".join(f"{p}+" for p in path) + "\t*\n")
    if abpt.out_cons:
        abc = abc_provider()
        for cons_i in range(abc.n_cons):
            fp.write("P\tConsensus_sequence")
            if abc.n_cons > 1:
                fp.write(f"_{cons_i + 1}")
            fp.write("\t")
            fp.write(",".join(f"{nid - 1}+" for nid in abc.cons_node_ids[cons_i]) + "\t*\n")
