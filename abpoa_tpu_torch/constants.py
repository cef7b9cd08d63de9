"""Shared constants and alphabet tables.

Mirrors the public constants of abPOA (include/abpoa.h:6-50) and
the nucleotide / amino-acid encode/decode tables (src/abpoa_seq.c:15-98).
Tables are re-derived from their stated rules, not copied: nt encoding maps
A/a->0 C/c->1 G/g->2 T/t/U/u->3, everything else ->4, with the low bytes 0..3
mapping to themselves so already-encoded input is idempotent.
"""
from __future__ import annotations

import numpy as np

# alignment modes
GLOBAL_MODE = 0
LOCAL_MODE = 1
EXTEND_MODE = 2

# gap modes
LINEAR_GAP = 0
AFFINE_GAP = 1
CONVEX_GAP = 2

# default extra band parameters
EXTRA_B = 10
EXTRA_F = 0.01

# cigar ops (packed 64-bit cigar, see abpoa.h:45-50)
CIGAR_STR = "MIDXSH"
CMATCH = 0
CINS = 1
CDEL = 2
CDIFF = 3
CSOFT_CLIP = 4
CHARD_CLIP = 5

SRC_NODE_ID = 0
SINK_NODE_ID = 1

# output result modes
OUT_CONS = 0
OUT_MSA = 1
OUT_CONS_MSA = 2
OUT_GFA = 3
OUT_CONS_GFA = 4
OUT_CONS_FQ = 5

# consensus algorithms
CONS_HB = 0  # heaviest bundling
CONS_MF = 1  # most frequent (majority vote)

# verbosity ladder
VERBOSE_NONE = 0
VERBOSE_INFO = 1
VERBOSE_DEBUG = 2
VERBOSE_LONG_DEBUG = 3

# default scoring (abpoa_align.h:9-18)
DEFAULT_MATCH = 2
DEFAULT_MISMATCH = 4
DEFAULT_GAP_OPEN1 = 4
DEFAULT_GAP_OPEN2 = 24
DEFAULT_GAP_EXT1 = 2
DEFAULT_GAP_EXT2 = 1
DEFAULT_MMK = 19
DEFAULT_MMW = 10
DEFAULT_MIN_POA_WIN = 500
MULTIP_MIN_FREQ = 0.25

# supported gap-extension range: penalties must stay BELOW this bound.
# At -E>=64 (a gap column costing 32x a match) the reference binary
# crashes outright ("Error in lg_backtrack", abpoa_align_simd.c:116-194)
# and our native engine and the numpy oracle disagree on the optimal
# alignment (measured boundary: parity through 63, divergence from 64 —
# PERF.md round 10). The contract is therefore an explicit validation
# error, not a silent superset: Params.finalize() rejects the config.
MAX_GAP_EXT = 64

# backtrack op bitmask (abpoa_align.h:20-27)
M_OP = 0x1
E1_OP = 0x2
E2_OP = 0x4
E_OP = 0x6
F1_OP = 0x8
F2_OP = 0x10
F_OP = 0x18
ALL_OP = 0x1F


def _build_nt4_table() -> np.ndarray:
    t = np.full(256, 4, dtype=np.uint8)
    # idempotent for already-encoded bytes 0..3
    t[0], t[1], t[2], t[3] = 0, 1, 2, 3
    for ch, v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
        t[ord(ch)] = v
        t[ord(ch.lower())] = v
    return t


def _build_nt256_table() -> np.ndarray:
    # decode 0..5 -> 'ACGTN-'; printable input letters decode to themselves
    t = np.full(256, ord("N"), dtype=np.uint8)
    for i, ch in enumerate("ACGTN-"):
        t[i] = ord(ch)
    t[27] = ord("-")
    for ch in "ACGT":
        t[ord(ch)] = ord(ch)
        t[ord(ch.lower())] = ord(ch)
    t[ord("T") + 1] = ord("T")  # 'U'
    t[ord("t") + 1] = ord("T")  # 'u'
    return t


def _build_aa26_table() -> np.ndarray:
    # amino acid 5-bit-ish encoding (abpoa_seq.c:57-74): ACGTN share 0..4 with nt,
    # the remaining letters take 5..25 in alphabetical order, unknown -> 26
    t = np.full(256, 26, dtype=np.uint8)
    for i in range(27):
        t[i] = i
    order = {}
    nt = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    nxt = 5
    for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
        if ch in nt:
            order[ch] = nt[ch]
        else:
            order[ch] = nxt
            nxt += 1
    for ch, v in order.items():
        t[ord(ch)] = v
        t[ord(ch.lower())] = v
    return t


def _build_aa256_table() -> np.ndarray:
    t = np.full(256, ord("*"), dtype=np.uint8)
    inv = {}
    nt = {0: "A", 1: "C", 2: "G", 3: "T", 4: "N"}
    nxt = 5
    for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
        if ch in "ACGTN":
            continue
        inv[nxt] = ch
        nxt += 1
    inv.update(nt)
    for v, ch in inv.items():
        t[v] = ord(ch)
    t[26] = ord("*")
    t[27] = ord("-")
    for ch in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
        t[ord(ch)] = ord(ch)
        t[ord(ch.lower())] = ord(ch)
    return t


NT4_TABLE = _build_nt4_table()
NT256_TABLE = _build_nt256_table()
AA26_TABLE = _build_aa26_table()
AA256_TABLE = _build_aa256_table()
