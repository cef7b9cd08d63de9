"""Packed 64-bit graph cigar (abPOA include/abpoa.h:45-50, abpoa_align.h:54-96).

M/X ops:   node_id << 34 | query_id << 4 | op        (one entry per base)
I/S/H ops: query_id << 34 | run_len << 4 | op        (run-length merged)
D ops:     node_id << 34 | run_len << 4 | op
"""
from __future__ import annotations

from typing import List

from . import constants as C

_MERGEABLE = (C.CINS, C.CSOFT_CLIP, C.CHARD_CLIP)


def push_cigar(cigar: List[int], op: int, length: int, node_id: int, query_id: int) -> None:
    if cigar and op in _MERGEABLE and (cigar[-1] & 0xF) == op:
        cigar[-1] += length << 4
        return
    if op in (C.CMATCH, C.CDIFF):
        cigar.append((node_id & 0x3FFFFFFF) << 34 | (query_id & 0x3FFFFFFF) << 4 | op)
    elif op in _MERGEABLE:
        cigar.append((query_id & 0x3FFFFFFF) << 34 | (length & 0x3FFFFFFF) << 4 | op)
    elif op == C.CDEL:
        cigar.append((node_id & 0x3FFFFFFF) << 34 | (length & 0x3FFFFFFF) << 4 | op)
    else:
        raise ValueError(f"Unknown cigar op: {op}")

