"""Cell-updates ops model -> MFU estimate.

Counterpart of `abpoa_tpu/obs/mfu.py`, with the same cell model and a peak
table of the cards the port's kernels are built for.

- Ops per cell by gap regime (adds + max ops in the H/E/F recurrences,
  including the band masking select): linear 8, affine 16, convex 26, as
  in the JAX package.
- The DP kernels (B1/B3, B2, B2u) are int32 adds and maxes on the CUDA
  cores, so the peak is the card's int32 rate: SMs x INT32 lanes an SM x
  boost clock. For the NVIDIA H100 80GB HBM3 (SXM5) that is 132 SMs x 64
  INT32 lanes x 1.98 GHz = 16.727e12 int ops/s, the rate the bounds in
  PERF.md use; the card measured there reports a 700.00 W power limit.
  A card that `torch.cuda.get_device_name()` does not name here (another
  H100 form factor, with other SM counts and clocks) gets no MFU.
- Cell totals are host-side models of the work launched (graph rows x band
  window), not device readbacks.
"""
from __future__ import annotations

from typing import Optional

from .. import constants as C

# integer ops per in-band DP cell (model, see module docstring)
CELL_INT_OPS = {
    C.LINEAR_GAP: 8,
    C.AFFINE_GAP: 16,
    C.CONVEX_GAP: 26,
}

# peak int32 ops/s by card, substring-matched against the lowercase
# torch.cuda.get_device_name() (see module docstring)
_PEAK_OPS = (
    ("h100 80gb hbm3", 132 * 64 * 1.98e9),
)


def peak_ops_for_kind(kind: str) -> Optional[float]:
    k = (kind or "").lower()
    for key, peak in _PEAK_OPS:
        if key in k:
            return peak
    return None


# phases whose wall time covers the DP launches the cell counters model
_ALIGN_PHASES = ("align", "align_fused")


def mfu_block(rep, device: Optional[dict]) -> Optional[dict]:
    """The report's `mfu` section. Cell-updates/s is emitted on every
    device; the MFU ratio itself only when a card with a known peak ran
    the work."""
    cells = rep.counters.get("dp.cells", 0)
    if not cells:
        return None
    ops = rep.counters.get("dp.cell_ops", 0)
    align_wall = sum(rep.phases[p][0] for p in _ALIGN_PHASES
                     if p in rep.phases)
    block = {
        "dp_cells": cells,
        "dp_cell_ops": ops,
        "align_wall_s": round(align_wall, 6),
        "cell_updates_per_sec": (round(cells / align_wall, 1)
                                 if align_wall > 0 else None),
        "model_ops_per_sec": (round(ops / align_wall, 1)
                              if align_wall > 0 else None),
        "peak_ops_per_sec": None,
        "mfu": None,
    }
    if device and device.get("platform") not in (None, "cpu"):
        peak = peak_ops_for_kind(device.get("kind", ""))
        if peak and align_wall > 0:
            block["peak_ops_per_sec"] = peak
            # significant digits, not decimal places: real MFUs here can
            # be far below 1e-8 and must not round to zero
            block["mfu"] = float(f"{ops / align_wall / peak:.6g}")
    return block
