"""Kernel X1, the backtrack over windowed planes: wrapper and plain version.

Counterpart of the XLA function `abpoa_tpu/align/fused_loop.py`
`_backtrack_w`: from the best cell back to row 0 (or, in local mode, to a
zero cell) through the banded planes B1 wrote, with abPOA's op priority
(src/abpoa_align_simd.c:309-458): match, then deletion (E1/E2), then
insertion (F1/F2), then a second match, with the put_gap_on_right and
put_gap_at_end switches; among predecessor slots the first hit wins. Each
step depends on the last, so on the card one warp of `csrc/backtrack.cu`
walks: lane k takes predecessor slot k (32 slots at a time) and a ballot
finds the first hit.

`backtrack(...)` checks its inputs and, for CUDA tensors, launches the kernel
(or raises); for CPU tensors it runs `backtrack_torch`, the same walk over
host lists, which is also the kernel's yardstick on the card.

Inputs: H, E1, E2, F1, F2 (R, W) int16 or int32 planes; beg, end (R,);
pre_idx (R, P), pre_cnt (R,); base (R,) the row bases (bits 0-7); query (Q,)
the padded read; mat (m, m); sc (8,) = [best_i, best_j, e1, oe1, e2, oe2,
inf, max_ops], all int32 on one device.
Outputs: ops (max_ops, 2) [op, row] with op 0 match, 1 deletion, 2 insertion,
in walk order (zero past n_ops), and res (6,) = [n_ops, fin_i, fin_j, n_aln,
n_match, err]; err is 1 on a dead end or when the stream reaches max_ops.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..kernels import build

_NAMES = ("H", "E1", "E2", "F1", "F2", "beg", "end", "pre_idx", "pre_cnt",
          "base", "query", "mat", "sc")


def _check_inputs(args) -> tuple:
    dev = args[0].device
    dt = args[0].dtype
    for k, (name, t) in enumerate(zip(_NAMES, args)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"backtrack: {name} must be a tensor")
        want = dt if k < 5 else torch.int32
        if t.dtype != want or want not in (torch.int16, torch.int32):
            raise TypeError(f"backtrack: {name} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"backtrack: {name} is on {t.device}, H on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"backtrack: {name} must be contiguous")
    H = args[0]
    R, W = H.shape
    for name, t in zip(_NAMES[1:5], args[1:5]):
        if t.shape != (R, W):
            raise ValueError(f"backtrack: {name} must have shape ({R}, {W})")
    pre_idx = args[7]
    if pre_idx.dim() != 2 or pre_idx.shape[0] != R:
        raise ValueError("backtrack: pre_idx must have shape (R, P)")
    for name, t in (("beg", args[5]), ("end", args[6]), ("pre_cnt", args[8]),
                    ("base", args[9])):
        if t.shape != (R,):
            raise ValueError(f"backtrack: {name} must have shape ({R},)")
    if args[11].dim() != 2 or args[12].shape != (8,):
        raise ValueError("backtrack: mat must be (m, m) and sc (8,)")
    return R, W, pre_idx.shape[1]


def backtrack(H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base, query,
              mat, sc, *, max_ops: int, gap_mode: int, gap_on_right: bool,
              put_gap_at_end: bool, local: bool):
    """The walk; see the module docstring. Returns (ops, res)."""
    args = (H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base, query, mat,
            sc)
    R, W, P = _check_inputs(args)
    kw = dict(max_ops=max_ops, gap_mode=gap_mode, gap_on_right=gap_on_right,
              put_gap_at_end=put_gap_at_end, local=local)
    dev = H.device
    if dev.type == "cpu":
        return backtrack_torch(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"backtrack: unsupported device {dev}")
    lib = build.load()
    flags = ((1 if gap_on_right else 0) | (2 if put_gap_at_end else 0)
             | (4 if local else 0) | (8 if H.dtype == torch.int16 else 0))
    with torch.cuda.device(dev):
        ops = torch.zeros((max_ops, 2), dtype=torch.int32, device=dev)
        res = torch.empty(6, dtype=torch.int32, device=dev)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_backtrack(
            *(ptr(t) for t in args), ptr(ops), ptr(res), R, W, P,
            mat.shape[1], query.shape[0], int(max_ops), int(gap_mode), flags,
            ctypes.c_void_p(stream))
    build.check(err, "backtrack launch")
    backtrack.launches += 1
    return ops, res


backtrack.launches = 0


def backtrack_torch(H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base,
                    query, mat, sc, *, max_ops: int, gap_mode: int,
                    gap_on_right: bool, put_gap_at_end: bool, local: bool):
    """The plain version of `backtrack`: `_backtrack_w`'s loop body
    (fused_loop.py:643-777) one step at a time, over host copies of the
    planes; returns (ops, res) on the inputs' device."""
    dev = H.device
    R, W = H.shape
    planes = [p.cpu().numpy() for p in (H, E1, E2, F1, F2)]
    Hn, E1n, E2n, F1n, F2n = planes
    beg_l, end_l = beg.tolist(), end.tolist()
    pre_l, pre_cnt_l = pre_idx.tolist(), pre_cnt.tolist()
    base_l = [b & 0xFF for b in base.tolist()]
    q = query.tolist()
    mat_l = mat.tolist()
    i, j, e1, oe1, e2, oe2, inf, _ = sc.tolist()
    linear = gap_mode == C.LINEAR_GAP
    convex = gap_mode == C.CONVEX_GAP
    M, ALL = C.M_OP, C.ALL_OP

    def gat(A, r, c):  # fused_loop.py:625: inside the row's band only
        k = c - beg_l[r]
        return int(A[r, k]) if 0 <= k < W and c <= end_l[r] else inf

    def gat_row(A, r, c):  # fused_loop.py:632: inside the window only
        k = c - beg_l[r]
        return int(A[r, k]) if 0 <= k < W else inf

    ops = []
    cur_op, look_gap = ALL, (1 if put_gap_at_end else 0)
    n_aln = n_match = err = 0
    while i > 0 and j > 0:
        H_ij = gat(Hn, i, j)
        if local and H_ij == 0:
            break
        bi, qb = base_l[i], q[j - 1]
        s = mat_l[bi][qb]
        preds = pre_l[i][:pre_cnt_l[i]]
        has_M = cur_op & M != 0

        first_m = -1
        for k, p in enumerate(preds):
            if beg_l[p] <= j - 1 <= end_l[p] and gat_row(Hn, p, j - 1) + s == H_ij:
                first_m = k
                break
        any_m = first_m >= 0
        m1 = (not gap_on_right and any_m and look_gap == 0
              and (linear or has_M))

        first_d, d_new_op = -1, ALL
        for k, p in enumerate(preds):
            if not beg_l[p] <= j <= end_l[p]:
                continue
            if linear:
                if gat_row(Hn, p, j) - e1 == H_ij:
                    first_d = k
                    break
                continue
            ph, pe1 = gat_row(Hn, p, j), gat_row(E1n, p, j)
            hit1 = cur_op & C.E1_OP != 0 and (
                H_ij == pe1 if has_M else gat(E1n, i, j) == pe1 - e1)
            hit2 = False
            if convex:
                pe2 = gat_row(E2n, p, j)
                hit2 = cur_op & C.E2_OP != 0 and (
                    H_ij == pe2 if has_M else gat(E2n, i, j) == pe2 - e2)
            if hit1 or hit2:
                first_d = k
                if hit1:
                    d_new_op = M | C.F_OP if ph - oe1 == pe1 else C.E1_OP
                elif convex:
                    d_new_op = M | C.F_OP if ph - oe2 == pe2 else C.E2_OP
                else:
                    d_new_op = C.E1_OP
                break
        any_d = first_d >= 0

        H_ijm1 = gat(Hn, i, j - 1)
        if linear:
            ins_hit, ins_new_op = H_ijm1 - e1 == H_ij, ALL
        else:
            F1_ij = gat(F1n, i, j)
            f1_open = H_ijm1 - oe1 == F1_ij
            f1_hit = (cur_op & C.F1_OP != 0 and (not has_M or H_ij == F1_ij)
                      and (f1_open or gat(F1n, i, j - 1) - e1 == F1_ij))
            f1_op = M | C.E_OP if f1_open else C.F1_OP
            f2_hit, f2_op = False, ALL
            if convex:
                F2_ij = gat(F2n, i, j)
                f2_open = H_ijm1 - oe2 == F2_ij
                f2_hit = (cur_op & C.F2_OP != 0 and (not has_M or H_ij == F2_ij)
                          and (f2_open or gat(F2n, i, j - 1) - e2 == F2_ij))
                f2_op = M | C.E_OP if f2_open else C.F2_OP
            ins_hit = f1_hit or f2_hit
            ins_new_op = f1_op if f1_hit else f2_op

        m2 = any_m and (linear or has_M)
        d_sel = not m1 and any_d
        i_sel = not m1 and not d_sel and ins_hit
        m2_sel = not m1 and not d_sel and not i_sel and m2
        if not (m1 or d_sel or i_sel or m2_sel):
            err = 1
            break
        m_sel = m1 or m2_sel
        ops.append((0 if m_sel else 1 if d_sel else 2, i))
        cap = len(ops) >= max_ops
        if m_sel:
            n_aln += 1
            n_match += int(bi == qb)
            i, j, cur_op = preds[first_m], j - 1, ALL
        elif d_sel:
            i, cur_op = preds[first_d], d_new_op
        else:
            n_aln += 1
            j, cur_op = j - 1, ins_new_op
        if not m1:
            look_gap = 0
        if cap:
            err = 1
            break

    out = torch.zeros((max_ops, 2), dtype=torch.int32, device="cpu")
    if ops:
        out[: len(ops)] = torch.tensor(ops, dtype=torch.int32, device="cpu")
    res = torch.tensor([len(ops), i, j, n_aln, n_match, err], dtype=torch.int32,
                       device="cpu")
    return out.to(dev), res.to(dev)
