"""Kernels B2 and B2u, the per-read and seeded routes' DP: wrappers and
plain version.

Counterpart of the Pallas kernel `abpoa_tpu/align/pallas_kernel.py`
`pallas_banded_dp` (one read against the whole graph) and of
`abpoa_tpu/align/jax_backend.py` `_dp_full_batch` (the XLA vmap over the
windows of one seeded read): the forward DP of a batch of independent
windows, each a query against a subgraph in topological order, in every
mode of `_dp_scan` (jax_backend.py:54): global, extend (with Z-drop) or
local, adaptive-banded or unbanded, with or without `-G`'s path scores;
linear, affine or convex gaps, int32 scores.

Two kernels share the work by the kind of window, which the callers know
from `Params` (`abpt.wb < 0`, local mode included: `finalize` sets wb to
-1 there) and pass as `unbanded`, a host flag: no device value is read to
pick a kernel.
- `banded_dp(..., unbanded=False)`: adaptive-banded windows, kernel B2, B1's
  seeded instantiation in `csrc/fused_dp.cu` (entry `abpoa_banded_dp`, one
  block a window). It takes B1's design (shared-memory ring, control warp,
  cp.async table prefetch, three barriers a row; the launch from
  `fused_dp_kernel.launch_shape(..., seeded=True)`) and pulls each row's
  band from its predecessors; the plain version pushes it to the
  successors, as Pallas does. The two agree because
  `tables.build_row_tables` gives pre and out tables that are transposes
  over rows 1..gn-2, and row 0 pushes nothing (its successors' 1 comes with
  mpl0/mpr0).
- `banded_dp(..., unbanded=True)`, which is `unbanded_dp`: whole-row windows
  (scalars[13] = 0, or local mode), kernel B2u in `csrc/unbanded_dp.cu`
  (entry `abpoa_unbanded_dp`, one thread-block cluster a window; the launch
  from `fused_dp_kernel.unbanded_launch_shape`, with 16 blocks a cluster
  only where the card can hold such a cluster, else 8).
For CUDA tensors each launches its kernel (or raises); a window of the other
kind is not computed and gets ok = -1 (`check_ok` raises on it), and nothing
falls back to the other kernel. For CPU tensors each checks that every
window is of its kind (else raises) and runs `banded_dp_torch`, the same
row loop in torch ops, window by window, which is also both kernels'
yardstick on the card.

A batch of B windows is ragged: window b owns rows roff[b]..roff[b+1]-1 of
the concatenated tables and planes (R_b rows; every per-row table and plane
row is window-local, predecessor indices too), and row b of the per-window
inputs. With `roff` omitted the inputs are one window's (B = 1, the
per-read route's shapes below without the leading B).

Inputs (all int32, contiguous, one device):
  scalars (B, 16) [qlen, w, remain_end, inf, o1, e1, oe1, o2, e2, oe2, gn,
                   dp_end0, mode, banded, zdrop, 0]; mode 0/1/2 = global/
                   extend/local (local is unbanded: banded = 0), zdrop > 0
                   turns extend mode's Z-drop on
  base, pre_cnt, out_cnt, remain, mpl0, mpr0 (Rtot,); pre_idx (Rtot, P);
  out_idx (Rtot, O); qp_pad (B, m, Qp + W); row0 (B, 5, W) = row 0 of
  H/E1/E2/F1/F2 in the gap mode's form (`tables.query_tables`);
  roff (B + 1,) row offsets, roff[0] = 0, roff[B] = Rtot;
  pre_score (Rtot, P), optional: `-G`'s score of each predecessor slot,
  added to that predecessor's H, E1 and E2 (_dp_scan:141-170).
Outputs: H, E1, E2, F1, F2 (Rtot, W) banded planes (band lane k of a row is
column dp_beg + k; linear gaps leave E1..F2 at -inf, affine E2 and F2),
begend (2 Rtot,) = window b's [dp_beg, dp_end] at 2 roff[b], mplr (2 Rtot,)
= its final [mpl, mpr] there (the seeds unbanded: no row pushes), ok (B,) =
0 where some row's band was wider than W (-1 on the card where the kernel
refused the window, see above), ext (B, 4) = [best score, row,
column, zdropped] of extend and local mode ([inf, 0, 0, 0] in global):
extend's best-so-far with its Z-drop stop, local's first row of the
largest row max at its leftmost column (_dp_full:662-681). An unbanded
row spans [0, qlen]; a row no predecessor reaches has an empty band in
every mode. Only plane rows 0..last computed of each window are defined on the
card: gn - 2, or on ok = 0 the row whose band overflowed
(`fused_dp_kernel.computed_rows`); the kernels leave the later rows as
allocated, the plain version fills them with -inf (as Pallas pads them).
The backtrack reads rows below gn - 1 only (align/banded.py). begend, mplr
and ok are defined on every row in both, and equal Pallas's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..kernels import build
from ..obs.tally import count_launch
from .fused_dp_kernel import launch_shape, unbanded_launch_shape

_NAMES = ("scalars", "base", "pre_idx", "pre_cnt", "out_idx", "out_cnt",
          "remain", "mpl0", "mpr0", "qp_pad", "row0", "roff")


def _check_inputs(args) -> tuple:
    """(B, Rtot, W, P) after checking device, dtype, shape and contiguity
    (args in batch form, roff included)."""
    dev = args[0].device
    for name, t in zip(_NAMES, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"banded_dp: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"banded_dp: {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"banded_dp: {name} is on {t.device}, "
                             f"scalars on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"banded_dp: {name} must be contiguous")
    (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0,
     qp_pad, row0, roff) = args
    R = base.shape[0]
    if scalars.dim() != 2 or scalars.shape[1] != 16:
        raise ValueError("banded_dp: scalars must have shape (B, 16)")
    B = scalars.shape[0]
    if row0.dim() != 3 or row0.shape[:2] != (B, 5):
        raise ValueError("banded_dp: row0 must have shape (B, 5, W)")
    W = row0.shape[2]
    if roff.shape != (B + 1,):
        raise ValueError("banded_dp: roff must have shape (B + 1,)")
    if pre_idx.dim() != 2 or pre_idx.shape[0] != R:
        raise ValueError("banded_dp: pre_idx must have shape (Rtot, P)")
    if out_idx.dim() != 2 or out_idx.shape[0] != R:
        raise ValueError("banded_dp: out_idx must have shape (Rtot, O)")
    for name, t in (("pre_cnt", pre_cnt), ("out_cnt", out_cnt),
                    ("remain", remain), ("mpl0", mpl0), ("mpr0", mpr0)):
        if t.shape != (R,):
            raise ValueError(f"banded_dp: {name} must have shape ({R},)")
    if qp_pad.dim() != 3 or qp_pad.shape[0] != B or qp_pad.shape[2] < W:
        raise ValueError("banded_dp: qp_pad must have shape (B, m, Qp + W)")
    if B < 1 or R < 1 or W < 1:
        raise ValueError("banded_dp: empty problem")
    return B, R, W, pre_idx.shape[1]


def _batch_form(args, roff):
    """The inputs in batch form: one window's gain a leading B = 1 and
    roff = [0, R]."""
    if roff is not None:
        return (*args, roff)
    scalars, qp_pad, row0 = args[0], args[9], args[10]
    if scalars.dim() != 1:
        raise ValueError("banded_dp: batched scalars need roff")
    R = args[1].shape[0]
    one = torch.tensor([0, R], dtype=torch.int32, device=scalars.device)
    return (scalars[None], *args[1:9], qp_pad[None], row0[None], one)


def _check_pre_score(pre_score, pre_idx) -> None:
    if pre_score is None:
        return
    if (not isinstance(pre_score, torch.Tensor) or pre_score.dtype != torch.int32
            or pre_score.device != pre_idx.device
            or pre_score.shape != pre_idx.shape or not pre_score.is_contiguous()):
        raise ValueError("banded_dp: pre_score must be a contiguous int32 "
                         "tensor shaped and placed as pre_idx")


def _check_kind(scalars: torch.Tensor, unbanded: bool, who: str) -> None:
    """Raise unless every window (scalars on the CPU) is of the kernel's
    kind: whole-row (scalars[13] = 0, or local mode) for B2u, banded for
    B2."""
    whole = (scalars[:, 13] == 0) | (scalars[:, 12] == 2)
    if bool((whole != unbanded).any()):
        kind = "a banded" if unbanded else "a whole-row"
        raise ValueError(f"{who}: {kind} window sent to kernel "
                         f"{'B2u' if unbanded else 'B2'}")


def check_ok(ok: torch.Tensor) -> list:
    """A launch's ok as a list; raises where a kernel refused a window of the
    other kind (ok = -1)."""
    oks = ok.tolist()
    if oks and min(oks) < 0:
        raise RuntimeError("banded_dp: a window was sent to the kernel of the "
                           "other kind (B2 takes banded windows, B2u "
                           "whole-row ones)")
    return oks


def banded_dp(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain,
              mpl0, mpr0, qp_pad, row0, roff=None, pre_score=None, *,
              gap_mode: int = C.CONVEX_GAP, unbanded: bool = False,
              warps=None):
    """Forward DP of a batch of windows; see the module docstring. Returns
    (H, E1, E2, F1, F2, begend, mplr, ok, ext). `unbanded` sends the batch
    to kernel B2u (`unbanded_dp`). `warps` overrides B2's launch table's
    column warps (chip_smoke.py's sweep)."""
    if unbanded:
        return unbanded_dp(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt,
                           remain, mpl0, mpr0, qp_pad, row0, roff, pre_score,
                           gap_mode=gap_mode)
    args = _batch_form((scalars, base, pre_idx, pre_cnt, out_idx, out_cnt,
                        remain, mpl0, mpr0, qp_pad, row0), roff)
    B, R, W, P = _check_inputs(args)
    _check_pre_score(pre_score, pre_idx)
    dev = scalars.device
    if dev.type == "cpu":
        _check_kind(args[0], False, "banded_dp")
        return banded_dp_torch(*args, pre_score=pre_score, gap_mode=gap_mode)
    if dev.type != "cuda":
        raise ValueError(f"banded_dp: unsupported device {dev}")
    ps = pre_score is not None
    ls = launch_shape(W, P, gap_mode, warps, seeded=True, path_score=ps)
    lib = build.load()
    (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0,
     qp_pad, row0, roff) = args
    kernel_in = (scalars, roff, base, pre_idx, pre_cnt, remain, mpl0, mpr0,
                 row0, qp_pad)
    with torch.cuda.device(dev):
        planes = torch.empty((5, R, W), dtype=torch.int32, device=dev)
        begend = torch.empty(2 * R, dtype=torch.int32, device=dev)
        mplr = torch.empty(2 * R, dtype=torch.int32, device=dev)
        ok = torch.empty(B, dtype=torch.int32, device=dev)
        ext = torch.empty((B, 4), dtype=torch.int32, device=dev)
        lr = torch.empty(2 * R, dtype=torch.int32, device=dev)   # scratch
        outs = (*planes.unbind(0), begend, mplr, ok, ext)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_banded_dp(
            *(ptr(t) for t in kernel_in),
            ptr(pre_score) if ps else None, *(ptr(t) for t in outs),
            ptr(lr), B, W, P, qp_pad.shape[2],
            qp_pad.shape[1] * qp_pad.shape[2], int(gap_mode),
            ls["block_warps"], ls["depth"], ls["smem"],
            ctypes.c_void_p(stream))
    build.check(err, "banded_dp launch")
    count_launch(banded_dp)
    return outs


banded_dp.launches = 0

# the B2u launch shape a (W, P, gap mode, path scores) gets on the card
_shapes: dict = {}


def cluster_shape(W: int, P: int, gap_mode: int, path_score: bool = False,
                  cs=None) -> dict:
    """`unbanded_launch_shape` on the card in use: 16 blocks a cluster only
    where cudaOccupancyMaxActiveClusters says one such cluster fits at once,
    else 8 (a given `cs` is taken as it is)."""
    ls = unbanded_launch_shape(W, P, gap_mode, path_score, cs)
    if cs is not None or ls["cs"] <= 8:
        return ls
    key = (W, P, gap_mode, path_score)
    if key not in _shapes:
        n = ctypes.c_int(0)
        build.check(build.load().abpoa_unbanded_max_clusters(
            W, P, gap_mode, int(path_score), ls["cs"], ls["warps"],
            ls["lanes"], ls["depth"], ls["smem"], ctypes.addressof(n)),
            "unbanded_dp cluster occupancy")
        _shapes[key] = ls if n.value >= 1 else unbanded_launch_shape(
            W, P, gap_mode, path_score, max_cs=8)
    return _shapes[key]


def unbanded_dp(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain,
                mpl0, mpr0, qp_pad, row0, roff=None, pre_score=None, *,
                gap_mode: int = C.CONVEX_GAP, cs=None):
    """Kernel B2u: `banded_dp` on whole-row windows (see the module
    docstring), the same inputs and outputs. `cs` forces the blocks a
    cluster (1, 2, 4, 8 or 16; chip_smoke.py's sweep). The launch needs
    scratch of Rtot x cs x 4 ints (each block's row maxima)."""
    args = _batch_form((scalars, base, pre_idx, pre_cnt, out_idx, out_cnt,
                        remain, mpl0, mpr0, qp_pad, row0), roff)
    B, R, W, P = _check_inputs(args)
    _check_pre_score(pre_score, pre_idx)
    dev = scalars.device
    if dev.type == "cpu":
        _check_kind(args[0], True, "unbanded_dp")
        return banded_dp_torch(*args, pre_score=pre_score, gap_mode=gap_mode)
    if dev.type != "cuda":
        raise ValueError(f"unbanded_dp: unsupported device {dev}")
    ps = pre_score is not None
    lib = build.load()
    with torch.cuda.device(dev):
        ls = cluster_shape(W, P, int(gap_mode), ps, cs)
        (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0,
         mpr0, qp_pad, row0, roff) = args
        kernel_in = (scalars, roff, base, pre_idx, pre_cnt, remain, mpl0,
                     mpr0, row0, qp_pad)
        planes = torch.empty((5, R, W), dtype=torch.int32, device=dev)
        begend = torch.empty(2 * R, dtype=torch.int32, device=dev)
        mplr = torch.empty(2 * R, dtype=torch.int32, device=dev)
        ok = torch.empty(B, dtype=torch.int32, device=dev)
        ext = torch.empty((B, 4), dtype=torch.int32, device=dev)
        rmax = torch.empty((R, ls["cs"], 4), dtype=torch.int32, device=dev)
        outs = (*planes.unbind(0), begend, mplr, ok, ext)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_unbanded_dp(
            *(ptr(t) for t in kernel_in),
            ptr(pre_score) if ps else None, *(ptr(t) for t in outs),
            ptr(rmax), B, W, P, qp_pad.shape[2],
            qp_pad.shape[1] * qp_pad.shape[2], int(gap_mode), ls["cs"],
            ls["warps"], ls["lanes"], ls["depth"], ls["smem"],
            ctypes.c_void_p(stream))
    build.check(err, "unbanded_dp launch")
    count_launch(unbanded_dp)
    return outs


unbanded_dp.launches = 0


def _f_chain(A: torch.Tensor, ext: int, lane_ext: torch.Tensor,
             inf: int) -> torch.Tensor:
    """F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext), exactly, in int64
    (the log-step chain of pallas_kernel.py:139-148 computes the same)."""
    t = torch.cummax(A.to(torch.int64) + lane_ext, 0).values - lane_ext
    return torch.clamp(t, min=inf).to(torch.int32)


def banded_dp_torch(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain,
                    mpl0, mpr0, qp_pad, row0, roff=None, pre_score=None, *,
                    gap_mode: int = C.CONVEX_GAP):
    """The plain PyTorch version of `banded_dp`: window by window, the row
    loop of pallas_kernel.py `_make_kernel` and jax_backend.py `_dp_scan`,
    step by step, on the inputs' device."""
    args = _batch_form((scalars, base, pre_idx, pre_cnt, out_idx, out_cnt,
                        remain, mpl0, mpr0, qp_pad, row0), roff)
    scalars, qp_pad, row0, roff = args[0], args[9], args[10], args[11]
    dev = scalars.device
    R, W = args[1].shape[0], row0.shape[2]
    if pre_score is None:
        pre_score = torch.zeros_like(args[2])
    planes = torch.empty((5, R, W), dtype=torch.int32, device=dev)
    begend = torch.empty(2 * R, dtype=torch.int32, device=dev)
    mplr = torch.empty(2 * R, dtype=torch.int32, device=dev)
    oks, exts = [], []
    offs = roff.tolist()
    for b in range(scalars.shape[0]):
        r0, r1 = offs[b], offs[b + 1]
        rows = [t[r0:r1] for t in (*args[1:9], pre_score)]
        H, E1, E2, F1, F2, be, lr, ok, ext = _window_dp_torch(
            scalars[b], *rows, qp_pad[b], row0[b], gap_mode)
        planes[:, r0:r1] = torch.stack([H, E1, E2, F1, F2])
        begend[2 * r0: 2 * r1] = be
        mplr[2 * r0: 2 * r1] = lr
        oks.append(ok)
        exts.append(ext)
    i32 = dict(dtype=torch.int32, device=dev)
    return (*planes.unbind(0), begend, mplr, torch.tensor(oks, **i32),
            torch.tensor(exts, **i32))


def _window_dp_torch(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt,
                     remain, mpl0, mpr0, pre_score, qp_pad, row0,
                     gap_mode: int):
    """One window of `banded_dp_torch`: (H, E1, E2, F1, F2, begend, mplr,
    ok, ext) with ok an int and ext a list."""
    dev = scalars.device
    R = base.shape[0]
    W = row0.shape[1]
    sc = scalars.tolist()
    qlen, w, remain_end, inf = sc[0], sc[1], sc[2], sc[3]
    e1, oe1, e2, oe2 = sc[5], sc[6], sc[8], sc[9]
    gn, end0, mode, banded, zdrop = sc[10], sc[11], sc[12], sc[13], sc[14]
    extend, local = mode == 1, mode == 2
    banded = banded != 0 and not local
    zdrop_on = extend and zdrop > 0
    linear = gap_mode == C.LINEAR_GAP
    convex = gap_mode == C.CONVEX_GAP
    base_l = base.tolist()
    pre_l, pre_cnt_l = pre_idx.tolist(), pre_cnt.tolist()
    ps_l = pre_score.tolist()
    out_l, out_cnt_l = out_idx.tolist(), out_cnt.tolist()
    remain_l = remain.tolist()
    mpl, mpr = mpl0.tolist(), mpr0.tolist()
    dp_beg, dp_end = [0] * R, [0] * R
    dp_end[0] = end0
    ok = 0 if end0 + 1 > W else 1
    bs, bi, bj, brem, zdropped = inf, 0, 0, 0, 0

    planes = torch.full((5, R, W), inf, dtype=torch.int32, device=dev)
    planes[:, 0] = row0
    H, E1, E2, F1, F2 = planes.unbind(0)
    lane = torch.arange(W, dtype=torch.int64, device=dev)
    lane_e1, lane_e2 = lane * e1, lane * e2
    first = lane == 0
    inf_row = torch.full((W,), inf, dtype=torch.int32, device=dev)
    dead = torch.zeros(W, dtype=torch.int32, device=dev) if local else inf_row

    for row in range(1, R):
        if row >= gn - 1 or not ok:
            break
        # band of this row (pallas_kernel.py:89-108; unbanded, _dp_scan's
        # [0, qlen]); no ring, so a band wider than W is the only overflow
        preds = pre_l[row][:pre_cnt_l[row]]
        pss = ps_l[row][:pre_cnt_l[row]]
        min_pre_beg = min((dp_beg[p] for p in preds), default=1 << 30)
        if banded:
            r = qlen - (remain_l[row] - remain_end - 1)
            beg = max(0, min(mpl[row], r) - w)
            end = min(qlen, max(mpr[row], r) + w)
            beg = max(beg, min_pre_beg)
        else:
            beg, end = min_pre_beg, qlen
        if end - beg + 1 > W:
            ok = 0
        dp_beg[row], dp_end[row] = beg, end

        cols = beg + lane
        in_band = cols <= end
        # column 0's lead cell: 0 in local mode (_dp_scan:128)
        lead = torch.where(cols == 0, dead, inf_row)
        Mq, E1r, E2r = inf_row, inf_row, inf_row
        for p, ps in zip(preds, pss):
            pbeg, pend = dp_beg[p], dp_end[p]
            hidx = cols - 1 - pbeg
            hok = (hidx >= 0) & (cols - 1 <= pend) & (hidx < W)
            hs = torch.where(hok, H[p].gather(0, hidx.clamp(0, W - 1)), lead)
            Mq = torch.maximum(Mq, hs + ps)
            eidx = cols - pbeg
            eok = (eidx >= 0) & (cols <= pend) & (eidx < W)
            eidx = eidx.clamp(0, W - 1)
            if linear:  # the E row comes from the predecessors' H
                E1r = torch.maximum(E1r, torch.where(eok, H[p].gather(0, eidx), inf) + ps)
                continue
            E1r = torch.maximum(E1r, torch.where(eok, E1[p].gather(0, eidx), inf) + ps)
            if convex:
                E2r = torch.maximum(E2r, torch.where(eok, E2[p].gather(0, eidx), inf) + ps)

        # a row no predecessor reaches (a window's subgraph may hold some)
        # has beg = 2^30 > end: an empty band, every lane masked
        qb = min(beg, qp_pad.shape[1] - W)
        qprow = qp_pad[base_l[row], qb: qb + W]
        Mq = torch.where(in_band, Mq + qprow, inf)
        if linear:  # _dp_scan's linear branch (jax_backend.py:171-175)
            Erow = torch.where(in_band, E1r - e1, inf)
            Hrow = _f_chain(torch.maximum(Mq, Erow), e1, lane_e1, inf)
            if local:
                Hrow = torch.clamp(Hrow, min=0)
            H[row] = torch.where(in_band, Hrow, inf)
        else:
            E1r = torch.where(in_band, E1r, inf)
            Hhat = torch.maximum(Mq, E1r)
            if convex:
                E2r = torch.where(in_band, E2r, inf)
                Hhat = torch.maximum(Hhat, E2r)
            Hm1 = torch.cat([inf_row[:1], Hhat[:-1]])
            src = torch.where(first, Mq, Hm1)
            f1 = _f_chain(torch.where(in_band, src - oe1, inf), e1, lane_e1, inf)
            Hrow = torch.maximum(Hhat, f1)
            if convex:
                f2 = _f_chain(torch.where(in_band, src - oe2, inf), e2, lane_e2, inf)
                Hrow = torch.maximum(Hrow, f2)
            if local:
                Hrow = torch.clamp(Hrow, min=0)
            E1n = torch.maximum(E1r - e1, Hrow - oe1)
            if convex:
                E2n = torch.maximum(E2r - e2, Hrow - oe2)
                if local:
                    E1n, E2n = torch.clamp(E1n, min=0), torch.clamp(E2n, min=0)
                E2[row] = torch.where(in_band, E2n, inf)
                F2[row] = torch.where(in_band, f2, inf)
            else:  # affine: E1 only where H is H-hat (jax_backend.py:204)
                E1n = torch.where(Hrow == Hhat, E1n, dead)
            H[row] = torch.where(in_band, Hrow, inf)
            E1[row] = torch.where(in_band, E1n, inf)
            F1[row] = torch.where(in_band, f1, inf)

        # band_extents (pallas_common.py:39), the best cell of local and
        # extend mode (_dp_scan:219-261) and the successor scatter
        Hm = H[row]
        mx = Hm.max()
        eq = (Hm == mx) & in_band
        mx, left, right = torch.stack([
            mx.to(torch.int64),
            torch.where(eq, cols, 1 << 30).min(),
            torch.where(eq, cols, -1).max()]).tolist()
        has_row = mx > inf
        if not has_row:
            left = right = -1
        if local and mx > bs:
            bs, bi, bj = mx, row, left
        if extend:
            better = not zdropped and mx > bs
            if zdrop_on and not zdropped and not better:
                if has_row:
                    zd = bs - mx > zdrop + e1 * abs((brem - remain_l[row]) - (right - bj))
                else:
                    zd = bs > inf
                zdropped = int(zd)
            if better:
                bs, bi, bj, brem = mx, row, right, remain_l[row]
        if banded and not (zdrop_on and zdropped):
            for t in out_l[row][:out_cnt_l[row]]:
                mpr[t] = max(mpr[t], right + 1)
                mpl[t] = min(mpl[t], left + 1)

    i32 = dict(dtype=torch.int32, device=dev)
    begend = torch.tensor(dp_beg + dp_end, **i32)
    mplr = torch.tensor(mpl + mpr, **i32)
    ext = [bs, bi, bj, zdropped] if (extend or local) else [inf, 0, 0, 0]
    return H, E1, E2, F1, F2, begend, mplr, ok, ext
