"""Consensus FASTA/FASTQ writer, byte-compatible with abPOA's
abpoa_output_fx_consensus (src/abpoa_output.c:589-628)."""
from __future__ import annotations

from typing import IO

from ..cons.consensus import ConsensusResult
from ..params import Params


def output_fx_consensus(abc: ConsensusResult, abpt: Params, fp: IO[str]) -> None:
    decode = abpt.code_to_char
    for cons_i in range(abc.n_cons):
        lead = "@" if abpt.out_fq else ">"
        fp.write(f"{lead}Consensus_sequence\n")
        fp.write("".join(chr(decode[b]) for b in abc.cons_base[cons_i]) + "\n")
        if abpt.out_fq:
            fp.write("+Consensus_sequence\n")
            fp.write("".join(chr(q) for q in abc.cons_phred[cons_i]) + "\n")
