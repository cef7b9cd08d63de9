"""Kernel B1/B3, the fused loop's banded forward DP: wrapper and plain version.

Counterpart of the Pallas kernels `abpoa_tpu/align/pallas_fused.py`
`pallas_fused_dp` (body `_make_kernel`, row math `_row_dp_math`) and
`pallas_fused_dp_local_hbm` (`_make_local_hbm_kernel`). Both become one CUDA
kernel, `csrc/fused_dp.cu`: its ring of recent rows lives in shared memory
with a fallback to the planes in device memory, so no predecessor distance
overflows it, and local mode at any width (B3's case) is the kernel's local
instantiation. Its seeded instantiation is the per-read route's kernel B2
(`align/banded_kernel.py`).

The adaptive-banded DP of one read against a topologically ordered graph,
for linear, affine or convex gaps, in global, extend (with Z-drop) or local
mode, with int16 or int32 planes (all arithmetic in int32; the fused loop's
promotion bound keeps every value inside int16 while it picks int16). A
row's band is pulled from its predecessors (min/max of the left+1/right+1
each stored), which equals Pallas's push to the successors because the
fused loop's pre and out tables are transposes over rows 1..gn-2; out_idx
and out_cnt are taken, as by Pallas, but neither version reads them.

`fused_dp(...)` checks its inputs and, for CUDA tensors, launches the kernel
(or raises); for CPU tensors it runs `fused_dp_torch`, the same row loop in
torch ops, which is also the kernel's yardstick on the card.
`launch_shape` picks the kernel's block and shared-memory layout.

Inputs (int32, contiguous, one device):
  scalars (16,) [qlen, w, remain_end, inf, e1, oe1, e2, oe2, gn, dp_end0,
                 zdrop, 0...] (pallas_fused.py's layout)
  base_packed (R,) base | is_src_out << 8; pre_idx (R, P), pre_cnt (R,);
  out_idx (R, O), out_cnt (R,); remain (R,);
  row0 (5, W): row 0 of H/E1/E2/F1/F2 (`row0_planes`);
  qp_pad (m, Qp + W): the query profile, column j + 1 scoring base j.
Outputs: H, E1, E2, F1, F2 (R, W) banded planes in the plane dtype (lane k
of row i is column beg[i] + k), beg, end (R,), ok (1,) = 0 when a row's band
was wider than W (rows after it are not computed), ext (4,) = [best score,
row, column, zdropped] of extend/local mode ([inf, 0, 0, 0] in global).
Only plane rows 0..last computed are defined: gn - 2, or on ok = 0 the row
whose band overflowed (`computed_rows`). The kernel leaves the later rows
as allocated; the plain version fills them with -inf. beg/end are 0 past
the last computed row in both. Unlike the Pallas kernels, row 0 and
beg/end[0] are written from `row0` and dp_end0, so no caller patches them.
"""
from __future__ import annotations

import ctypes

import torch

from .. import constants as C
from ..kernels import build

_NAMES = ("scalars", "base_packed", "pre_idx", "pre_cnt", "out_idx",
          "out_cnt", "remain", "row0", "qp_pad")
_MODES = {"global": 0, "extend": 1, "local": 2}

# the kernel's shared-memory layout (csrc/fused_dp.cu): a ring of
# _SCALAR_RING rows of beg/end/left/right (16 B each), _STAGES table rows of
# P + 4 ints (P + 5 for B2, the seeded instantiation, and P more for its
# path scores), two rows of P
# predecessor records (16 B), 8 ints per warp, and the ring of D rows of the
# planes the gap regime reads (int32)
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on Hopper
MAX_W = 16 * 1024     # 1024 threads x 16 columns
MAX_W_SEEDED = 32 * 1024  # B2: 1024 threads x 32 columns
_SCALAR_RING = 256
_STAGES = 4
_MAX_DEPTH = 64       # ring rows; headline predecessors: p99 16, max 37 back
# column warps (the control warp comes on top) at the widths chip_smoke.py
# sweeps: W = 128 and the B3 width 2048 (phase A2), 512 (phase D, the
# headline). Another width takes the entry of the next swept width at or
# above it; past the widest, that entry, raised where 16 columns a thread
# would not cover W. The columns a thread takes follow (at most 16)
_WARPS = {128: 4, 512: 8, 2048: 32}


def ring_planes(gap_mode: int) -> int:
    """Planes the ring keeps: H (linear), + E1 (affine), + E2 (convex)."""
    return {C.LINEAR_GAP: 1, C.AFFINE_GAP: 2}.get(gap_mode, 3)


def smem_bytes(W: int, P: int, block_warps: int, depth: int,
               gap_mode: int, seeded: bool = False,
               path_score: bool = False) -> int:
    extra = (5 + (P if path_score else 0)) if seeded else 4
    return (_SCALAR_RING * 16 + _STAGES * (P + extra) * 4
            + 2 * P * 16 + block_warps * 32
            + ring_planes(gap_mode) * depth * W * 4)


def table_warps(W: int) -> int:
    """Column warps for band width W from _WARPS and its rule."""
    widest = max(_WARPS)
    if W <= widest:
        return _WARPS[min(k for k in _WARPS if k >= W)]
    return max(_WARPS[widest], min(32, -(-W // (32 * 16)) - 1))


def launch_shape(W: int, P: int, gap_mode: int, warps=None,
                 seeded: bool = False, path_score: bool = False) -> dict:
    """The kernel's launch: `warps` warps that take the columns (from the
    table unless given; chip_smoke.py's sweep gives them) plus the control
    warp (the block's last; at 32 warps it takes columns too), columns per
    thread (cpt, a power of two up to 16, or 32 for B2's `seeded`
    instantiation), ring depth D (0 or a power of two, the deepest up to
    _MAX_DEPTH that fits) and the dynamic shared-memory bytes (B2 with
    `path_score` stages each row's scores too). Raises when W or P does not
    fit."""
    max_w = MAX_W_SEEDED if seeded else MAX_W
    if W < 1 or W > max_w:
        raise ValueError(f"fused_dp: band width {W} outside the kernel's "
                         f"1..{max_w} columns")
    if warps is None:
        warps = table_warps(W)
    if not 1 <= warps <= 32:
        raise ValueError(f"fused_dp: {warps} warps")
    block_warps = min(32, warps + 1)
    cpt = 1
    while cpt * block_warps * 32 < W:
        cpt *= 2
    if cpt > max_w // 1024:
        raise ValueError(f"fused_dp: {warps} warps cannot cover W = {W}")
    depth = _MAX_DEPTH
    while depth >= 2 and smem_bytes(W, P, block_warps, depth, gap_mode,
                                    seeded, path_score) > SMEM_LIMIT:
        depth //= 2
    if depth < 2:  # a ring of one row serves no predecessor
        depth = 0
    smem = smem_bytes(W, P, block_warps, depth, gap_mode, seeded, path_score)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_dp: {smem} bytes of shared memory for W = {W},"
                         f" P = {P} pass the block's {SMEM_LIMIT}")
    return dict(warps=warps, block_warps=block_warps, cpt=cpt, depth=depth,
                smem=smem)


def computed_rows(beg, end, ok, gn: int, W: int) -> int:
    """How many plane rows (from row 0) the DP defined: gn - 1, or on a band
    overflow up to and including the row whose band passed W."""
    if int(ok[0]):
        return gn - 1
    wide = ((end[1:gn - 1] - beg[1:gn - 1] + 1) > W).nonzero()
    return int(wide[0, 0]) + 2 if wide.numel() else 1


def row0_planes(W: int, dp_end0: torch.Tensor, abpt, inf: int,
                local: bool, device) -> torch.Tensor:
    """(5, W) int32 row 0 of H/E1/E2/F1/F2 per gap regime
    (fused_loop.py:196 `_row0_planes`); dp_end0 is a 0-d tensor."""
    kw = torch.arange(W, dtype=torch.int32, device=device)
    colv = kw <= dp_end0
    full = lambda v: torch.full((W,), v, dtype=torch.int32, device=device)  # noqa: E731
    infr = full(inf)
    if local:
        z = torch.where(colv, full(0), infr)
        return torch.stack([z] * 5)
    o1, e1, oe1 = abpt.gap_open1, abpt.gap_ext1, abpt.gap_oe1
    o2, e2, oe2 = abpt.gap_open2, abpt.gap_ext2, abpt.gap_oe2
    live = colv & (kw >= 1)
    if abpt.gap_mode == C.LINEAR_GAP:
        return torch.stack([torch.where(colv, -e1 * kw, infr)] + [infr] * 4)
    f1 = torch.where(live, -o1 - e1 * kw, infr)
    E1 = infr.clone()
    E1[0] = -oe1
    if abpt.gap_mode == C.CONVEX_GAP:
        f2 = torch.where(live, -o2 - e2 * kw, infr)
        H = torch.maximum(f1, f2)
        E2 = infr.clone()
        E2[0] = -oe2
    else:
        f2 = infr
        H = f1.clone()
        E2 = infr
    H[0] = 0
    return torch.stack([H, E1, E2, f1, f2])


def _check_inputs(args) -> tuple:
    """(R, W, P, O) after checking device, dtype, shape and contiguity."""
    dev = args[0].device
    for name, t in zip(_NAMES, args):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_dp: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"fused_dp: {name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"fused_dp: {name} is on {t.device}, "
                             f"scalars on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_dp: {name} must be contiguous")
    (scalars, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, row0,
     qp_pad) = args
    R = base.shape[0]
    if scalars.shape != (16,):
        raise ValueError("fused_dp: scalars must have shape (16,)")
    if row0.dim() != 2 or row0.shape[0] != 5:
        raise ValueError("fused_dp: row0 must have shape (5, W)")
    W = row0.shape[1]
    if pre_idx.dim() != 2 or pre_idx.shape[0] != R:
        raise ValueError("fused_dp: pre_idx must have shape (R, P)")
    if out_idx.dim() != 2 or out_idx.shape[0] != R:
        raise ValueError("fused_dp: out_idx must have shape (R, O)")
    for name, t in (("pre_cnt", pre_cnt), ("out_cnt", out_cnt),
                    ("remain", remain)):
        if t.shape != (R,):
            raise ValueError(f"fused_dp: {name} must have shape ({R},)")
    if qp_pad.dim() != 2 or qp_pad.shape[1] < W:
        raise ValueError("fused_dp: qp_pad must have shape (m, Qp + W)")
    if R < 1 or W < 1:
        raise ValueError("fused_dp: empty problem")
    return R, W, pre_idx.shape[1], out_idx.shape[1]


def fused_dp(scalars, base_packed, pre_idx, pre_cnt, out_idx, out_cnt,
             remain, row0, qp_pad, *, gap_mode: int, plane16: bool,
             extend: bool = False, zdrop_on: bool = False,
             local: bool = False, warps=None):
    """Banded forward DP; see the module docstring. Returns
    (H, E1, E2, F1, F2, beg, end, ok, ext). `warps` overrides the launch
    table's column warps (chip_smoke.py's sweep)."""
    args = (scalars, base_packed, pre_idx, pre_cnt, out_idx, out_cnt, remain,
            row0, qp_pad)
    R, W, P, O = _check_inputs(args)
    if extend and local:
        raise ValueError("fused_dp: extend and local are exclusive")
    dev = scalars.device
    kw = dict(gap_mode=gap_mode, plane16=plane16, extend=extend,
              zdrop_on=zdrop_on, local=local)
    if dev.type == "cpu":
        return fused_dp_torch(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_dp: unsupported device {dev}")
    ls = launch_shape(W, P, gap_mode, warps)
    lib = build.load()
    dt = torch.int16 if plane16 else torch.int32
    mode = _MODES["local" if local else "extend" if extend else "global"]
    kernel_in = (scalars, base_packed, pre_idx, pre_cnt, remain, row0, qp_pad)
    with torch.cuda.device(dev):
        planes = torch.empty((5, R, W), dtype=dt, device=dev)
        begend = torch.empty(2 * R, dtype=torch.int32, device=dev)
        ok = torch.empty(1, dtype=torch.int32, device=dev)
        ext = torch.empty(4, dtype=torch.int32, device=dev)
        lr = torch.empty(2 * R, dtype=torch.int32, device=dev)  # scratch
        outs = (*planes.unbind(0), begend, ok, ext, lr)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.abpoa_fused_dp(
            *(ptr(t) for t in kernel_in), *(ptr(t) for t in outs),
            R, W, P, qp_pad.shape[1], int(gap_mode), mode,
            int(bool(zdrop_on)), int(bool(plane16)), ls["block_warps"],
            ls["depth"], ls["smem"],
            ctypes.c_void_p(stream))
    build.check(err, "fused_dp launch")
    if local:
        fused_dp.local_launches += 1
    else:
        fused_dp.launches += 1
    return (*planes.unbind(0), begend[:R], begend[R:], ok, ext)


fused_dp.launches = 0        # global and extend mode (kernel B1)
fused_dp.local_launches = 0  # local mode (kernel B1-local / B3)


def _chain(A: torch.Tensor, ext: int, lane_ext: torch.Tensor,
           inf: int) -> torch.Tensor:
    """F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext), int64 in and out: the
    clamped log-step chain of pallas_fused.py:212-225."""
    return torch.clamp(torch.cummax(A + lane_ext, 0).values - lane_ext,
                       min=inf)


def fused_dp_torch(scalars, base_packed, pre_idx, pre_cnt, out_idx, out_cnt,
                   remain, row0, qp_pad, *, gap_mode: int, plane16: bool,
                   extend: bool = False, zdrop_on: bool = False,
                   local: bool = False):
    """The plain PyTorch version of `fused_dp`: the row loop of
    pallas_fused.py `_make_kernel`, step by step, in int64 on the inputs'
    device, stored in the plane dtype, with the band pulled from the
    predecessors as the kernel pulls it. Rows past the last computed one
    are -inf."""
    dev = scalars.device
    R = base_packed.shape[0]
    W = row0.shape[1]
    sc = scalars.tolist()
    qlen, w, remain_end, inf = sc[0], sc[1], sc[2], sc[3]
    e1, oe1, e2, oe2 = sc[4], sc[5], sc[6], sc[7]
    gn, end0, zdrop = sc[8], sc[9], sc[10]
    linear = gap_mode == C.LINEAR_GAP
    convex = gap_mode == C.CONVEX_GAP
    bp = base_packed.tolist()
    pre_l, pre_cnt_l = pre_idx.tolist(), pre_cnt.tolist()
    remain_l = remain.tolist()
    # what each computed row leaves for its successors to pull: left+1 and
    # right+1 of its row max, or (gn, 0) where Z-drop stops it (and row 0)
    pull_l, pull_r = [gn] * R, [0] * R
    beg_l, end_l = [0] * R, [0] * R
    end_l[0] = end0
    ok = 0 if end0 + 1 > W else 1
    bs, bi, bj, brem, zdropped = inf, 0, 0, 0, 0

    i64 = dict(dtype=torch.int64, device=dev)
    planes = torch.full((5, R, W), inf, **i64)
    planes[:, 0] = row0
    H, E1, E2, F1, F2 = planes.unbind(0)
    qp = qp_pad.to(torch.int64)
    lane = torch.arange(W, **i64)
    lane_e1, lane_e2 = lane * e1, lane * e2
    first = lane == 0
    infr = torch.full((W,), inf, **i64)
    zero = torch.zeros(W, **i64)

    for row in range(1, R):
        if row >= gn - 1 or not ok:
            break
        preds = pre_l[row][:pre_cnt_l[row]]
        if local:
            beg, end = 0, qlen
        else:
            back = [p for p in preds if p < row]
            mpl = min((pull_l[p] for p in back), default=gn)
            mpr = max((pull_r[p] for p in back), default=0)
            if bp[row] & 0x100:  # a successor of the source row
                mpl, mpr = min(mpl, 1), max(mpr, 1)
            r = qlen - (remain_l[row] - remain_end - 1)
            beg = max(0, min(mpl, r) - w)
            end = min(qlen, max(mpr, r) + w)
            beg = max(beg, min((beg_l[p] for p in preds), default=1 << 30))
        if end - beg + 1 > W:
            ok = 0  # this row is still computed; the later ones are not
        beg_l[row], end_l[row] = beg, end

        cols = beg + lane
        in_band = cols <= end
        Mq, E1r, E2r = infr, infr, infr
        for p in preds:
            pbeg, pend = beg_l[p], end_l[p]
            hidx = cols - 1 - pbeg
            hok = (cols - 1 >= pbeg) & (cols - 1 <= pend) & (hidx < W)
            Mq = torch.maximum(Mq, torch.where(hok, H[p].gather(0, hidx.clamp(0, W - 1)), infr))
            eidx = cols - pbeg
            eok = (cols >= pbeg) & (cols <= pend) & (eidx < W)
            eidx = eidx.clamp(0, W - 1)
            if linear:
                E1r = torch.maximum(E1r, torch.where(eok, H[p].gather(0, eidx), infr))
                continue
            E1r = torch.maximum(E1r, torch.where(eok, E1[p].gather(0, eidx), infr))
            if convex:
                E2r = torch.maximum(E2r, torch.where(eok, E2[p].gather(0, eidx), infr))
        if local:  # the lead cell (column -1) scores 0
            Mq = torch.where(cols == 0, torch.clamp(Mq, min=0), Mq)
        qprow = qp[bp[row] & 0xFF, beg: beg + W]
        Mq = torch.where(in_band, Mq + qprow, infr)

        # _row_dp_math (pallas_fused.py:59-123)
        if linear:
            Erow = torch.where(in_band, E1r - e1, infr)
            Hrow = _chain(torch.maximum(Mq, Erow), e1, lane_e1, inf)
            if local:
                Hrow = torch.clamp(Hrow, min=0)
            Hrow = torch.where(in_band, Hrow, infr)
            rows = (Hrow, infr, infr, infr, infr)
        else:
            E1r = torch.where(in_band, E1r, infr)
            Hhat = torch.maximum(Mq, E1r)
            if convex:
                E2r = torch.where(in_band, E2r, infr)
                Hhat = torch.maximum(Hhat, E2r)
            Hm1 = torch.cat([infr[:1], Hhat[:-1]])
            src = torch.where(first, Mq, Hm1)
            f1 = _chain(torch.where(in_band, src - oe1, infr), e1, lane_e1, inf)
            Hrow = torch.maximum(Hhat, f1)
            if convex:
                f2 = _chain(torch.where(in_band, src - oe2, infr), e2, lane_e2, inf)
                Hrow = torch.maximum(Hrow, f2)
                if local:
                    Hrow = torch.clamp(Hrow, min=0)
                E1n = torch.maximum(E1r - e1, Hrow - oe1)
                E2n = torch.maximum(E2r - e2, Hrow - oe2)
                if local:
                    E1n, E2n = torch.clamp(E1n, min=0), torch.clamp(E2n, min=0)
            else:
                f2 = infr
                if local:
                    Hrow = torch.clamp(Hrow, min=0)
                E1n = torch.maximum(E1r - e1, Hrow - oe1)
                E1n = torch.where(Hrow == Hhat, E1n, zero if local else infr)
                E2n = infr
            rows = tuple(torch.where(in_band, x, infr)
                         for x in (Hrow, E1n, E2n, f1, f2))
        for plane, x in zip((H, E1, E2, F1, F2), rows):
            plane[row] = x

        # band_extents (pallas_common.py:39)
        Hrow = rows[0]
        mx = Hrow.max()
        eq = (Hrow == mx) & in_band
        mx, left, right = torch.stack([
            mx, torch.where(eq, cols, 1 << 30).min(),
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
        if not local and not (extend and zdrop_on and zdropped):
            pull_l[row], pull_r[row] = left + 1, right + 1

    i32 = dict(dtype=torch.int32, device=dev)
    dt = torch.int16 if plane16 else torch.int32
    ext = [bs, bi, bj, zdropped] if (extend or local) else [inf, 0, 0, 0]
    return (*(p.to(dt) for p in planes.unbind(0)),
            torch.tensor(beg_l, **i32), torch.tensor(end_l, **i32),
            torch.tensor([ok], **i32), torch.tensor(ext, **i32))
