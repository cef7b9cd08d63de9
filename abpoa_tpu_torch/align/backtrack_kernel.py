"""Kernels X1 (the fused loop's backtrack over windowed planes) and X1w (the
same walk over the windows of one B2 launch): wrappers and plain versions.

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

X1w (`backtrack_windows`) is the counterpart of
`abpoa_tpu/align/jax_backtrack.py` `device_backtrack` as
`jax_backend.py` `_dp_full_batch` vmaps it over a seeded read's windows,
with `_dp_full`'s best cell of each mode (:662-681), the local stop and
`-G`'s path scores: on the card one block a window of a B2 launch
(`csrc/backtrack_windows.cu`), whose walker warp reads B2's ragged planes
from shared-memory tiles that its loader warp stages ahead of it
(`tile_shape`); its plain version `backtrack_windows_torch` runs the pick
and `backtrack_torch` window by window.
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
    ops, res = _launch((*args[:12], sc.reshape(1, 8)), 1, R, W, P, None, R,
                       **kw)
    backtrack.launches += 1
    return ops[0], res[0]


def _launch(args, L: int, R: int, W: int, P: int, lanes, bstride: int, *,
            max_ops: int, gap_mode: int, gap_on_right: bool,
            put_gap_at_end: bool, local: bool):
    """One launch of X1 over the lanes of `lanes` (host ints; None: all L),
    lane b's rows R apart in the planes and tables, its beg/end bstride
    ints apart. Returns ops (L, max_ops, 2), res (L, 6)."""
    H, query, mat = args[0], args[10], args[11]
    dev = H.device
    lib = build.load()
    flags = ((1 if gap_on_right else 0) | (2 if put_gap_at_end else 0)
             | (4 if local else 0) | (8 if H.dtype == torch.int16 else 0))
    nl = L if lanes is None else len(lanes)
    with torch.cuda.device(dev):
        ops = torch.zeros((L, max_ops, 2), dtype=torch.int32, device=dev)
        res = torch.empty((L, 6), dtype=torch.int32, device=dev)
        lanes_t = build.lane_list(lanes, dev)
        ptr = lambda t: ctypes.c_void_p(  # noqa: E731
            None if t is None else t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_backtrack(
            *(ptr(t) for t in args), ptr(ops), ptr(res), ptr(lanes_t), R, W,
            P, mat.shape[1], query.shape[-1], int(max_ops), int(gap_mode),
            flags, nl, int(bstride), ctypes.c_void_p(stream))
    build.check(err, "backtrack launch")
    return ops, res


def backtrack_lanes(H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base,
                    query, mat, sc, *, max_ops: int, gap_mode: int,
                    gap_on_right: bool, put_gap_at_end: bool, local: bool,
                    lanes=None):
    """The walks of L lanes in one launch of X1 (one warp a lane): each
    input of `backtrack` with a leading lane axis (planes (L, R, W), beg
    and end (L, R) with unit column stride, as B1's lanes give them, ...,
    query (L, Q), sc (L, 8)); mat is shared. `lanes` (host ints) lists the
    lanes to walk (None: all); the others' res is undefined on the card
    (zero in the plain version). Returns ops (L, max_ops, 2), res (L, 6).
    On the CPU the plain version walks lane by lane."""
    args = (H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base, query, mat,
            sc)
    L = H.shape[0]
    one = tuple(t if k == 11 else t[0].contiguous()
                for k, t in enumerate(args))
    R, W, P = _check_inputs(one)
    for k, (name, t) in enumerate(zip(_NAMES, args)):
        if k == 11:
            continue
        if t.shape[0] != L:
            raise ValueError(f"backtrack_lanes: {name} must have {L} lanes")
        if k in (5, 6):
            if t.stride(1) != 1 or t.stride() != args[5].stride():
                raise ValueError("backtrack_lanes: beg and end must share "
                                 "one lane stride, unit column stride")
        elif not t.is_contiguous():
            raise ValueError(f"backtrack_lanes: {name} must be contiguous")
    kw = dict(max_ops=max_ops, gap_mode=gap_mode, gap_on_right=gap_on_right,
              put_gap_at_end=put_gap_at_end, local=local)
    todo = list(range(L)) if lanes is None else [int(x) for x in lanes]
    dev = H.device
    if dev.type == "cpu":
        ops = torch.zeros((L, max_ops, 2), dtype=torch.int32)
        res = torch.zeros((L, 6), dtype=torch.int32)
        for l in todo:
            ops[l], res[l] = backtrack_torch(
                *(t if k == 11 else t[l] for k, t in enumerate(args)), **kw)
        return ops, res
    if dev.type != "cuda":
        raise ValueError(f"backtrack_lanes: unsupported device {dev}")
    if not todo:
        raise ValueError("backtrack_lanes: no lane to launch")
    out = _launch(args, L, R, W, P, lanes, beg.stride(0), **kw)
    backtrack_lanes.launches += 1
    return out


backtrack_lanes.launches = 0


backtrack.launches = 0


def backtrack_torch(H, E1, E2, F1, F2, beg, end, pre_idx, pre_cnt, base,
                    query, mat, sc, *, max_ops: int, gap_mode: int,
                    gap_on_right: bool, put_gap_at_end: bool, local: bool,
                    pre_score=None):
    """The plain version of `backtrack`: `_backtrack_w`'s loop body
    (fused_loop.py:643-777) one step at a time, over host copies of the
    planes; returns (ops, res) on the inputs' device. `pre_score` (R, P),
    `-G`'s path score of each predecessor slot, enters every
    predecessor-crossing equality (jax_backtrack.py:73-110)."""
    dev = H.device
    R, W = H.shape
    planes = [p.cpu().numpy() for p in (H, E1, E2, F1, F2)]
    Hn, E1n, E2n, F1n, F2n = planes
    beg_l, end_l = beg.tolist(), end.tolist()
    pre_l, pre_cnt_l = pre_idx.tolist(), pre_cnt.tolist()
    ps_l = pre_score.tolist() if pre_score is not None else None
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
        pss = ps_l[i] if ps_l is not None else [0] * len(preds)
        has_M = cur_op & M != 0

        first_m = -1
        for k, p in enumerate(preds):
            if (beg_l[p] <= j - 1 <= end_l[p]
                    and gat_row(Hn, p, j - 1) + s + pss[k] == H_ij):
                first_m = k
                break
        any_m = first_m >= 0
        m1 = (not gap_on_right and any_m and look_gap == 0
              and (linear or has_M))

        first_d, d_new_op = -1, ALL
        for k, p in enumerate(preds):
            if not beg_l[p] <= j <= end_l[p]:
                continue
            ps = pss[k]
            if linear:
                if gat_row(Hn, p, j) - e1 + ps == H_ij:
                    first_d = k
                    break
                continue
            ph, pe1 = gat_row(Hn, p, j), gat_row(E1n, p, j)
            hit1 = cur_op & C.E1_OP != 0 and (
                H_ij == pe1 + ps if has_M else gat(E1n, i, j) == pe1 - e1 + ps)
            hit2 = False
            if convex:
                pe2 = gat_row(E2n, p, j)
                hit2 = cur_op & C.E2_OP != 0 and (
                    H_ij == pe2 + ps if has_M else gat(E2n, i, j) == pe2 - e2 + ps)
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


# ----------------------------------------------------------------- X1w
HEADER = 11  # [n_ops, fin_i, fin_j, n_aln, n_match, start_i, start_j, err,
#               best_score, best_i, best_j]

# X1w's tile (csrc/backtrack_windows.cu `tile_shape`, which this mirrors):
# C columns, at most 256 rows, pre_idx/pre_score staged up to 32 slots, two
# stages in a block's 227 KB after a 32-int control block and mat
TILE_COLS = 32
_MAX_ROWS, _MAX_STAGED_P, _SMEM_BYTES, _CTL = 256, 32, 232448, 32


def tile_shape(gap_mode: int, P: int, path_score: bool, m: int,
               cols: int = TILE_COLS) -> dict:
    """X1w's tile for a launch: R rows x C columns of the planes the gap
    mode reads (H; H, E1, F1; all five), the rows' tables (pre_idx and
    pre_score only up to 32 slots) and the query's C bases, two stages to a
    block. `cols` is the kernel's compile-time C (a build of the source
    with another `X1W_TILE_COLS` has its own)."""
    r4 = lambda x: (x + 3) & ~3  # noqa: E731
    planes = (1 if gap_mode == C.LINEAR_GAP else
              5 if gap_mode == C.CONVEX_GAP else 3)
    staged = P if P <= _MAX_STAGED_P else 0
    tabs = (2 if path_score else 1) if staged else 0
    mat = _CTL + r4(m * m)
    half = (_SMEM_BYTES // 4 - mat) // 2
    stride = cols + 4
    rows = (half - (16 + 4 * tabs + stride)) // (4 + staged * tabs
                                                  + planes * (stride + 1))
    R = min(rows, _MAX_ROWS) & ~7
    pre = R * staged + 4 if staged else 0
    stage = 4 * (R + 4) + pre * tabs + stride + planes * R * (stride + 1)
    return {"R": R, "C": cols, "planes": planes, "staged_p": staged,
            "smem": 4 * (mat + 2 * stage)}


_WNAMES = ("planes", "begend", "mplr", "ext", "pre_idx", "pre_cnt", "base",
           "scalars", "roff", "mat", "query", "plan")


def _check_windows(args) -> tuple:
    dev = args[0].device
    for name, t in zip(_WNAMES, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"backtrack_windows: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"backtrack_windows: {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"backtrack_windows: {name} is on {t.device}, "
                             f"planes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"backtrack_windows: {name} must be contiguous")
    (planes, begend, mplr, ext, pre_idx, pre_cnt, base, scalars, roff, mat, _,
     plan) = args
    if planes.dim() != 3 or planes.shape[0] != 5:
        raise ValueError("backtrack_windows: planes must have shape (5, Rtot, W)")
    R = planes.shape[1]
    if pre_idx.dim() != 2 or pre_idx.shape[0] != R:
        raise ValueError("backtrack_windows: pre_idx must have shape (Rtot, P)")
    for name, t, n in (("begend", begend, 2 * R), ("mplr", mplr, 2 * R),
                       ("pre_cnt", pre_cnt, R), ("base", base, R)):
        if t.shape != (n,):
            raise ValueError(f"backtrack_windows: {name} must have shape ({n},)")
    if scalars.dim() != 2 or scalars.shape[1] != 16:
        raise ValueError("backtrack_windows: scalars must have shape (B, 16)")
    if ext.shape != (scalars.shape[0], 4):
        raise ValueError("backtrack_windows: ext must have shape (B, 4)")
    if roff.shape != (scalars.shape[0] + 1,) or mat.dim() != 2:
        raise ValueError("backtrack_windows: roff must be (B + 1,), mat (m, m)")
    if plan.dim() != 2 or plan.shape[1] != 6 or plan.shape[0] < 1:
        raise ValueError("backtrack_windows: plan must have shape (n >= 1, 6)")
    return R, planes.shape[2], pre_idx.shape[1]


def backtrack_windows(planes, begend, mplr, ext, pre_idx, pre_cnt, base,
                      scalars, roff, mat, query, plan, *, size: int,
                      gap_mode: int, gap_on_right: bool, put_gap_at_end: bool,
                      pre_score=None):
    """Kernel X1w: the best cell and the walk of each planned window of one
    B2 launch, into one packed int32 buffer of `size`.

    The inputs are B2's launch as it stands on the device: `planes` its
    (5, Rtot, W) output, `begend`/`mplr` its bands, `ext` (B, 4) its best
    cells, `pre_idx`, `pre_cnt`, `base`, `scalars` and `roff` its inputs
    (scalars[12] is a window's mode: 0 global, 1 extend, 2 local), and
    `pre_score` its path scores (`-G`) or None; `mat` (m, m); `query` the
    walked windows' queries one after another; `plan` (n, 6), one row a
    walk: [slot in the launch, query offset, header offset, band offset,
    op offset, max_ops]. The best cell is, in global mode, the end row's
    predecessor with the largest H at its band's end (`_dp_full`'s argmax,
    jax_backend.py:664-670), in extend and local mode B2's `ext`; a local
    walk stops before a zero cell. The walk writes at those offsets of the
    output the header (`HEADER` ints), the window's final [mpl..., mpr...]
    (2 gn) and its ops (max_ops, 2) [op, row] in walk order (op 0 match, 1
    deletion, 2 insertion; rows past n_ops undefined). For CUDA tensors one
    block a walk runs it on the card (`csrc/backtrack_windows.cu`: a walker
    warp on shared-memory tiles of the planes, a loader warp that stages
    them), for CPU tensors `backtrack_windows_torch`."""
    args = (planes, begend, mplr, ext, pre_idx, pre_cnt, base, scalars, roff,
            mat, query, plan)
    R, W, P = _check_windows(args)
    if pre_score is not None and (pre_score.shape != pre_idx.shape
                                  or pre_score.dtype != torch.int32
                                  or pre_score.device != planes.device
                                  or not pre_score.is_contiguous()):
        raise ValueError("backtrack_windows: pre_score must be a contiguous "
                         "int32 tensor shaped and placed as pre_idx")
    kw = dict(size=size, gap_mode=gap_mode, gap_on_right=gap_on_right,
              put_gap_at_end=put_gap_at_end, pre_score=pre_score)
    dev = planes.device
    if dev.type == "cpu":
        return backtrack_windows_torch(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"backtrack_windows: unsupported device {dev}")
    lib = build.load()
    flags = (1 if gap_on_right else 0) | (2 if put_gap_at_end else 0)
    with torch.cuda.device(dev):
        packed = torch.empty(size, dtype=torch.int32, device=dev)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_backtrack_windows(
            *(ptr(t) for t in args),
            ptr(pre_score) if pre_score is not None else None, ptr(packed),
            plan.shape[0], R, W, P, mat.shape[1], int(gap_mode), flags,
            ctypes.c_void_p(stream))
    build.check(err, "backtrack_windows launch")
    backtrack_windows.launches += 1
    return packed


backtrack_windows.launches = 0


def backtrack_windows_torch(planes, begend, mplr, ext, pre_idx, pre_cnt,
                            base, scalars, roff, mat, query, plan, *,
                            size: int, gap_mode: int, gap_on_right: bool,
                            put_gap_at_end: bool, pre_score=None):
    """The plain version of `backtrack_windows`: window by window, the best
    cell (global: `_dp_full`'s argmax over the end row's predecessors,
    jax_backend.py:664-670; extend and local: B2's `ext`) and
    `backtrack_torch`'s walk, whose start cell follows from its last op;
    returns the packed output on the inputs' device (unwritten ints are 0)."""
    dev = planes.device
    cpu = lambda t: t.cpu()  # noqa: E731
    planes, begend, mplr, pre_idx, pre_cnt, base, mat, query = map(
        cpu, (planes, begend, mplr, pre_idx, pre_cnt, base, mat, query))
    if pre_score is not None:
        pre_score = pre_score.cpu()
    sc_l, roff_l, ext_l = scalars.tolist(), roff.tolist(), ext.tolist()
    W = planes.shape[2]
    out = torch.zeros(size, dtype=torch.int32)
    for slot, qoff, h_at, b_at, o_at, max_ops in plan.tolist():
        qlen, _, _, inf, _, e1, oe1, _, e2, oe2, gn, _, mode = sc_l[slot][:13]
        r0 = roff_l[slot]
        beg = begend[2 * r0: 2 * r0 + gn]
        end = begend[2 * r0 + gn: 2 * r0 + 2 * gn]
        out[b_at: b_at + 2 * gn] = mplr[2 * r0: 2 * r0 + 2 * gn]
        H = planes[0, r0: r0 + gn]
        if mode != 0:
            score, bi, bj = ext_l[slot][:3]
        else:
            n_sink = int(pre_cnt[r0 + gn - 1])
            rows = pre_idx[r0 + gn - 1, :n_sink].tolist() if n_sink else [0]
            best = None
            for p in rows:
                e = min(qlen, int(end[p]))
                k = e - int(beg[p])
                v = int(H[p, k]) if 0 <= k < W else inf
                if best is None or v > best[0]:
                    best = (v, p, e)
            score, bi, bj = best
        sc = torch.tensor([bi, bj, e1, oe1, e2, oe2, inf, max_ops],
                          dtype=torch.int32)
        ops, res = backtrack_torch(
            *(planes[c, r0: r0 + gn] for c in range(5)), beg, end,
            pre_idx[r0: r0 + gn], pre_cnt[r0: r0 + gn], base[r0: r0 + gn],
            query[qoff: qoff + max(qlen, 1)], mat, sc, max_ops=max_ops,
            gap_mode=gap_mode, gap_on_right=gap_on_right,
            put_gap_at_end=put_gap_at_end, local=mode == 2,
            pre_score=(pre_score[r0: r0 + gn] if pre_score is not None
                       else None))
        n_ops, fi, fj, n_aln, n_match, err = res.tolist()
        si, sj = bi, bj
        if n_ops and (not err or n_ops >= max_ops):
            # the last step emitted its op from the cell it started at
            last_op, si = ops[n_ops - 1].tolist()
            sj = fj + (1 if last_op != 1 else 0)
        elif err:  # a dead end: the step that found no op started here
            si, sj = fi, fj
        out[h_at: h_at + HEADER] = torch.tensor(
            [n_ops, fi, fj, n_aln, n_match, si, sj, err, score, bi, bj],
            dtype=torch.int32)
        out[o_at: o_at + 2 * n_ops] = ops[:n_ops].reshape(-1)
    return out.to(dev)
