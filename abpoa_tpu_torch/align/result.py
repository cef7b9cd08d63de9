"""Alignment result container (abPOA abpoa_res_t, include/abpoa.h:57-64)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class AlignResult:
    cigar: List[int] = field(default_factory=list)  # packed 64-bit graph cigar
    node_s: int = -1
    node_e: int = -1
    query_s: int = -1
    query_e: int = -1
    n_aln_bases: int = 0
    n_matched_bases: int = 0
    best_score: int = 0
