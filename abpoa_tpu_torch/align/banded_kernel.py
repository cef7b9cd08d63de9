"""Kernel B2, the per-read route's banded DP: wrapper and plain version.

Counterpart of the Pallas kernel `abpoa_tpu/align/pallas_kernel.py`
`pallas_banded_dp`: the adaptive-banded forward DP of one read against a
topologically ordered graph, convex gaps, global mode, int32 scores.

`banded_dp(...)` checks its inputs and, for CUDA tensors, launches kernel
B1's seeded instantiation in `csrc/fused_dp.cu` (entry `abpoa_banded_dp`;
or raises); for CPU tensors it runs `banded_dp_torch`, the same row loop in
torch ops, which is also the kernel's yardstick on the card. The kernel
takes B1's design (shared-memory ring, control warp, cp.async table
prefetch, three barriers a row; the launch from
`fused_dp_kernel.launch_shape(..., seeded=True)`) and pulls each row's band
from its predecessors; the plain version pushes it to the successors, as
Pallas does. The two agree because `tables.build_row_tables` gives pre and
out tables that are transposes over rows 1..gn-2, and row 0 pushes nothing
(its successors' 1 comes with mpl0/mpr0).

Inputs (all int32, contiguous, one device):
  scalars (16,)   [qlen, w, remain_end, inf, o1, e1, oe1, o2, e2, oe2, gn,
                   dp_end0, 0...]
  base, pre_cnt, out_cnt, remain, mpl0, mpr0 (R,); pre_idx (R, P);
  out_idx (R, O); qp_pad (m, Qp + W); row0 (5, W) = row 0 of H/E1/E2/F1/F2.
Outputs: H, E1, E2, F1, F2 (R, W) banded planes (band lane k of row i is
column dp_beg[i] + k), begend (2R,) = [dp_beg, dp_end], mplr (2R,) = the
final [mpl, mpr], ok (1,) = 0 when some row's band was wider than W.
Only plane rows 0..last computed are defined on the card: gn - 2, or on
ok = 0 the row whose band overflowed (`fused_dp_kernel.computed_rows`);
the kernel leaves the later rows as allocated, the plain version fills
them with -inf (as Pallas pads them). The per-read backtrack reads rows
below gn - 1 only (align/banded.py). begend, mplr and ok are defined on
every row in both, and equal Pallas's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..kernels import build
from .fused_dp_kernel import launch_shape

_NAMES = ("scalars", "base", "pre_idx", "pre_cnt", "out_idx", "out_cnt",
          "remain", "mpl0", "mpr0", "qp_pad", "row0")


def _check_inputs(args) -> tuple:
    """(R, W, P, O) after checking device, dtype, shape and contiguity."""
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
     qp_pad, row0) = args
    R = base.shape[0]
    if scalars.shape != (16,):
        raise ValueError("banded_dp: scalars must have shape (16,)")
    if row0.dim() != 2 or row0.shape[0] != 5:
        raise ValueError("banded_dp: row0 must have shape (5, W)")
    W = row0.shape[1]
    if pre_idx.dim() != 2 or pre_idx.shape[0] != R:
        raise ValueError("banded_dp: pre_idx must have shape (R, P)")
    if out_idx.dim() != 2 or out_idx.shape[0] != R:
        raise ValueError("banded_dp: out_idx must have shape (R, O)")
    for name, t in (("pre_cnt", pre_cnt), ("out_cnt", out_cnt),
                    ("remain", remain), ("mpl0", mpl0), ("mpr0", mpr0)):
        if t.shape != (R,):
            raise ValueError(f"banded_dp: {name} must have shape ({R},)")
    if qp_pad.dim() != 2 or qp_pad.shape[1] < W:
        raise ValueError("banded_dp: qp_pad must have shape (m, Qp + W)")
    if R < 1 or W < 1:
        raise ValueError("banded_dp: empty problem")
    return R, W, pre_idx.shape[1], out_idx.shape[1]


def banded_dp(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain,
              mpl0, mpr0, qp_pad, row0, *, warps=None):
    """Banded forward DP; see the module docstring. Returns
    (H, E1, E2, F1, F2, begend, mplr, ok). `warps` overrides the launch
    table's column warps (chip_smoke.py's sweep)."""
    args = (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0,
            mpr0, qp_pad, row0)
    R, W, P, O = _check_inputs(args)
    dev = scalars.device
    if dev.type == "cpu":
        return banded_dp_torch(*args)
    if dev.type != "cuda":
        raise ValueError(f"banded_dp: unsupported device {dev}")
    ls = launch_shape(W, P, C.CONVEX_GAP, warps, seeded=True)
    lib = build.load()
    kernel_in = (scalars, base, pre_idx, pre_cnt, remain, mpl0, mpr0, row0,
                 qp_pad)
    with torch.cuda.device(dev):
        planes = torch.empty((5, R, W), dtype=torch.int32, device=dev)
        begend = torch.empty(2 * R, dtype=torch.int32, device=dev)
        mplr = torch.empty(2 * R, dtype=torch.int32, device=dev)
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        ext = torch.empty(4, dtype=torch.int32, device=dev)     # scratch
        lr = torch.empty(2 * R, dtype=torch.int32, device=dev)  # scratch
        outs = (*planes.unbind(0), begend, mplr, ok)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_banded_dp(
            *(ptr(t) for t in kernel_in), *(ptr(t) for t in outs),
            ptr(ext), ptr(lr), R, W, P, qp_pad.shape[1], ls["block_warps"],
            ls["depth"], ls["smem"], ctypes.c_void_p(stream))
    build.check(err, "banded_dp launch")
    banded_dp.launches += 1
    return outs


banded_dp.launches = 0


def _f_chain(A: torch.Tensor, ext: int, lane_ext: torch.Tensor,
             inf: int) -> torch.Tensor:
    """F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext), exactly, in int64
    (the log-step chain of pallas_kernel.py:139-148 computes the same)."""
    t = torch.cummax(A.to(torch.int64) + lane_ext, 0).values - lane_ext
    return torch.clamp(t, min=inf).to(torch.int32)


def banded_dp_torch(scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain,
                    mpl0, mpr0, qp_pad, row0):
    """The plain PyTorch version of `banded_dp`: the row loop of
    pallas_kernel.py `_make_kernel`, step by step, on the inputs' device."""
    dev = scalars.device
    R = base.shape[0]
    W = row0.shape[1]
    sc = scalars.tolist()
    qlen, w, remain_end, inf = sc[0], sc[1], sc[2], sc[3]
    e1, oe1, e2, oe2 = sc[5], sc[6], sc[8], sc[9]
    gn, end0 = sc[10], sc[11]
    base_l = base.tolist()
    pre_l, pre_cnt_l = pre_idx.tolist(), pre_cnt.tolist()
    out_l, out_cnt_l = out_idx.tolist(), out_cnt.tolist()
    remain_l = remain.tolist()
    mpl, mpr = mpl0.tolist(), mpr0.tolist()
    dp_beg, dp_end = [0] * R, [0] * R
    dp_end[0] = end0
    ok = 0 if end0 + 1 > W else 1

    planes = torch.full((5, R, W), inf, dtype=torch.int32, device=dev)
    planes[:, 0] = row0
    H, E1, E2, F1, F2 = planes.unbind(0)
    lane = torch.arange(W, dtype=torch.int64, device=dev)
    lane_e1, lane_e2 = lane * e1, lane * e2
    first = lane == 0
    inf_row = torch.full((W,), inf, dtype=torch.int32, device=dev)

    for row in range(1, R):
        if row >= gn - 1 or not ok:
            break
        # band of this row (pallas_kernel.py:89-108); no ring, so a band
        # wider than W is the only overflow
        r = qlen - (remain_l[row] - remain_end - 1)
        beg = max(0, min(mpl[row], r) - w)
        end = min(qlen, max(mpr[row], r) + w)
        preds = pre_l[row][:pre_cnt_l[row]]
        beg = max(beg, min((dp_beg[p] for p in preds), default=1 << 30))
        if end - beg + 1 > W:
            ok = 0
        dp_beg[row], dp_end[row] = beg, end

        cols = beg + lane
        in_band = cols <= end
        Mq, E1r, E2r = inf_row, inf_row, inf_row
        for p in preds:
            pbeg, pend = dp_beg[p], dp_end[p]
            hidx = cols - 1 - pbeg
            hok = (hidx >= 0) & (cols - 1 <= pend) & (hidx < W)
            hs = torch.where(hok, H[p].gather(0, hidx.clamp(0, W - 1)), inf)
            Mq = torch.maximum(Mq, hs)
            eidx = cols - pbeg
            eok = (eidx >= 0) & (cols <= pend) & (eidx < W)
            eidx = eidx.clamp(0, W - 1)
            E1r = torch.maximum(E1r, torch.where(eok, E1[p].gather(0, eidx), inf))
            E2r = torch.maximum(E2r, torch.where(eok, E2[p].gather(0, eidx), inf))

        qprow = qp_pad[base_l[row], beg: beg + W]
        Mq = torch.where(in_band, Mq + qprow, inf)
        E1r = torch.where(in_band, E1r, inf)
        E2r = torch.where(in_band, E2r, inf)
        Hhat = torch.maximum(torch.maximum(Mq, E1r), E2r)

        Hm1 = torch.cat([inf_row[:1], Hhat[:-1]])
        src = torch.where(first, Mq, Hm1)
        A1 = torch.where(in_band, src - oe1, inf)
        A2 = torch.where(in_band, src - oe2, inf)
        f1 = _f_chain(A1, e1, lane_e1, inf)
        f2 = _f_chain(A2, e2, lane_e2, inf)
        Hrow = torch.maximum(Hhat, torch.maximum(f1, f2))
        E1n = torch.maximum(E1r - e1, Hrow - oe1)
        E2n = torch.maximum(E2r - e2, Hrow - oe2)
        H[row] = torch.where(in_band, Hrow, inf)
        E1[row] = torch.where(in_band, E1n, inf)
        E2[row] = torch.where(in_band, E2n, inf)
        F1[row] = torch.where(in_band, f1, inf)
        F2[row] = torch.where(in_band, f2, inf)

        # band_extents (pallas_common.py:39) and the successor scatter
        Hm = H[row]
        mx = Hm.max()
        eq = (Hm == mx) & in_band
        mx, left, right = torch.stack([
            mx.to(torch.int64),
            torch.where(eq, cols, 1 << 30).min(),
            torch.where(eq, cols, -1).max()]).tolist()
        if not mx > inf:
            left = right = -1
        for t in out_l[row][:out_cnt_l[row]]:
            mpr[t] = max(mpr[t], right + 1)
            mpl[t] = min(mpl[t], left + 1)

    i32 = dict(dtype=torch.int32, device=dev)
    begend = torch.tensor(dp_beg + dp_end, **i32)
    mplr = torch.tensor(mpl + mpr, **i32)
    return H, E1, E2, F1, F2, begend, mplr, torch.tensor([ok], **i32)
