"""Alignment/consensus parameter object.

Mirrors abPOA's parameter lifecycle (`abpoa_init_para` defaults, user
mutation, `abpoa_post_set_para` derivation in src/abpoa_align.c): construct
`Params()`, mutate fields, call `finalize()`.

`finalize()` covers every single-set configuration of the JAX package:
progressive POA with linear, affine or convex gaps in global, local and
extend mode (Z-drop included), banded or unbanded (`-b < 0`), with or
without path scores (`-G`), with consensus, MSA and GFA output,
majority-vote consensus, up to 10 clustered consensus sequences, qv
weights, incremental `-i`, graph plots `-g`, minimizer-seeded windows `-S`
and the guide-tree order `-p`. Nothing is rerouted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .device import resolve_device


def gen_simple_mat(m: int, match: int, mismatch: int) -> np.ndarray:
    """Match/mismatch scoring matrix (src/abpoa_align.c:13-26).

    Row/col m-1 is the ambiguous base ('N'): score 0 against everything.
    """
    match = abs(match)
    mismatch = -abs(mismatch)
    mat = np.full((m, m), mismatch, dtype=np.int32)
    np.fill_diagonal(mat, match)
    mat[:, m - 1] = 0
    mat[m - 1, :] = 0
    return mat


def parse_mat_file(path: str, m: int) -> np.ndarray:
    """Parse a scoring-matrix file (BLOSUM62-style; src/abpoa_align.c:35-86)."""
    mat = np.zeros((m, m), dtype=np.int32)
    order: list[int] = []
    first = True
    with open(path) as fp:
        for line in fp:
            if line.startswith("#"):
                continue
            if first:
                first = False
                for ch in line.split():
                    order.append(int(C.AA26_TABLE[ord(ch[0])]))
            else:
                toks = line.split()
                if not toks:
                    continue
                row = int(C.AA26_TABLE[ord(toks[0][0])])
                if row >= m:
                    raise ValueError(f"Unknown base in matrix file: {toks[0]}")
                for n, tok in enumerate(toks[1:]):
                    mat[row, order[n]] = int(tok)
    return mat


def plain_route(abpt: "Params") -> bool:
    """True when the progressive loop runs in input order with no seeding
    (abpoa_tpu/pipeline.py:234): the fused route or `pipeline.poa`. `-S`
    and `-p` take the seeded route in global mode only; in local and extend
    mode they are ignored, as in the JAX package."""
    return ((abpt.disable_seeding and not abpt.progressive_poa)
            or abpt.align_mode != C.GLOBAL_MODE)


@dataclass
class Params:
    align_mode: int = C.GLOBAL_MODE
    gap_mode: int = C.CONVEX_GAP  # derived in finalize()
    # extend mode's Z-drop threshold; <= 0 turns Z-drop off
    zdrop: int = -1
    # -e: stored as abPOA stores it; no alignment mode reads it
    end_bonus: int = -1

    inc_path_score: bool = False
    sort_input_seq: bool = False
    put_gap_on_right: bool = False
    put_gap_at_end: bool = False

    # adaptive band
    wb: int = C.EXTRA_B
    wf: float = C.EXTRA_F

    amb_strand: bool = False
    out_cons: bool = True
    out_fq: bool = False
    out_gfa: bool = False
    out_msa: bool = False
    cons_algrm: int = C.CONS_HB
    max_n_cons: int = 1
    # majority vote (-a 1) counts gaps against the reads spanning a column
    # instead of all reads
    sub_aln: bool = False
    # -q: a het column's minor allele needs this share of the reads (-d > 1)
    min_freq: float = C.MULTIP_MIN_FREQ
    # derived: per-edge read-id bitsets are kept for the outputs that read them
    use_read_ids: bool = False
    incr_fn: Optional[str] = None
    out_pog: Optional[str] = None

    # alphabet size: 5 = nucleotide, 27 = amino acid
    m: int = 5

    # scoring
    use_score_matrix: bool = False
    mat_fn: Optional[str] = None
    match: int = C.DEFAULT_MATCH
    mismatch: int = C.DEFAULT_MISMATCH
    gap_open1: int = C.DEFAULT_GAP_OPEN1
    gap_open2: int = C.DEFAULT_GAP_OPEN2
    gap_ext1: int = C.DEFAULT_GAP_EXT1
    gap_ext2: int = C.DEFAULT_GAP_EXT2

    use_qv: bool = False
    disable_seeding: bool = True
    # -k/-w/-n: minimizer k-mer, window and minimum POA window of seeding (-S)
    k: int = C.DEFAULT_MMK
    w: int = C.DEFAULT_MMW
    min_w: int = C.DEFAULT_MIN_POA_WIN
    progressive_poa: bool = False

    verbose: int = C.VERBOSE_NONE
    # set index in the consensus names of a `-l` run (0: a single set)
    batch_index: int = 0
    # `-l` and msa_batch in split lockstep: "auto" (on where the device is
    # the card), "on" or "off" (parallel.runner.lockstep_enabled)
    lockstep: str = "auto"

    # torch device the DP kernel runs on: "cuda" (the kernel) or "cpu"
    # (its plain PyTorch version); resolved by finalize()
    device: str = "cuda"

    # derived (set by finalize)
    mat: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    max_mat: int = 0
    min_mis: int = 0
    torch_device: Optional[torch.device] = field(default=None, repr=False)
    _finalized: bool = field(default=False, repr=False)

    def finalize(self) -> "Params":
        """Derive gap mode / scoring matrix, check the configuration and
        resolve the torch device."""
        if min(self.match, self.mismatch, self.gap_open1, self.gap_open2,
               self.gap_ext1, self.gap_ext2) < 0:
            raise ValueError("negative scoring parameters")
        if self.gap_ext1 == 0 and self.gap_ext2 == 0:
            raise ValueError("at least one gap extension must be positive")
        if max(self.gap_ext1, self.gap_ext2) >= C.MAX_GAP_EXT:
            raise ValueError(
                f"gap extension penalty {max(self.gap_ext1, self.gap_ext2)} "
                f"is outside the supported range (must be < {C.MAX_GAP_EXT})")
        if self.gap_open1 == 0:
            self.gap_mode = C.LINEAR_GAP
        elif self.gap_open2 == 0:
            self.gap_mode = C.AFFINE_GAP
        else:
            self.gap_mode = C.CONVEX_GAP
        if (self.out_msa or self.out_gfa or self.max_n_cons > 1
                or self.cons_algrm == C.CONS_MF):
            self.use_read_ids = True
        if self.align_mode == C.LOCAL_MODE:
            self.wb = -1
        if self.m > 5 and self.k > 11:  # aa sequences: smaller minimizers
            self.k, self.w = 7, 4
        if self.align_mode not in (C.GLOBAL_MODE, C.LOCAL_MODE, C.EXTEND_MODE):
            raise ValueError(f"unknown alignment mode {self.align_mode}")

        if not self.use_score_matrix:
            self.mat = gen_simple_mat(self.m, self.match, self.mismatch)
            self.max_mat = abs(self.match)
            self.min_mis = abs(self.mismatch)
        else:
            if self.mat_fn is None:
                raise ValueError("use_score_matrix needs mat_fn")
            self.mat = parse_mat_file(self.mat_fn, self.m)
            self.max_mat = int(self.mat.max())
            self.min_mis = int((-self.mat).max())
        self.torch_device = resolve_device(self.device)
        self._finalized = True
        return self

    @property
    def is_aa(self) -> bool:
        return self.m > 5

    @property
    def char_to_code(self) -> np.ndarray:
        return C.AA26_TABLE if self.is_aa else C.NT4_TABLE

    @property
    def code_to_char(self) -> np.ndarray:
        return C.AA256_TABLE if self.is_aa else C.NT256_TABLE

    @property
    def gap_oe1(self) -> int:
        return self.gap_open1 + self.gap_ext1

    @property
    def gap_oe2(self) -> int:
        return self.gap_open2 + self.gap_ext2
