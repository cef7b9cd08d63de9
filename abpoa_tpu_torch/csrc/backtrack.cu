// The fused loop's backtrack over banded planes (X1), written for Hopper
// (sm_90a).
//
// Replaces: the XLA function abpoa_tpu/align/fused_loop.py `_backtrack_w`,
// whose op priority chain is abPOA's (src/abpoa_align_simd.c:309-458):
// match (unless put_gap_on_right or a pending put_gap_at_end), deletion
// through E1/E2, insertion through F1/F2, then match; among predecessor
// slots the first hit wins. Local mode stops at a zero cell before it emits
// an op. The plain PyTorch version is `backtrack_torch` in
// align/backtrack_kernel.py and must agree with this kernel exactly.
//
// What bounds it: each step reads the cell the previous step chose, so the
// ~qlen + deletions steps of a walk run one after another, each a few
// dependent loads from L2 (the planes were just written by the DP kernel).
// It moves a few bytes per step and does a few dozen integer operations:
// it is latency bound, far from the card's bytes or operations bounds.
//
// What the design does about it: one thread walks the alignment, so no
// barrier sits between steps, and the planes never leave the card (the
// per-read route copied all five planes to the host for this walk). The
// op stream is written as it is found; n_ops and the end cell come back in
// a six-int result.
#include <cuda_runtime.h>

namespace {

constexpr int kLinear = 0, kConvex = 2;
constexpr int kM = 0x1, kE1 = 0x2, kE2 = 0x4, kE = 0x6, kF1 = 0x8, kF2 = 0x10,
              kF = 0x18, kAll = 0x1F;

struct Planes {
  const void* H;
  const void* E1;
  const void* E2;
  const void* F1;
  const void* F2;
  const int* beg;
  const int* end;
  int W;
  int inf;
  bool p16;

  __device__ int ld(const void* p, size_t i) const {
    return p16 ? (int)((const short*)p)[i] : ((const int*)p)[i];
  }
  // a cell inside row r's band (fused_loop.py:625 `gat`)
  __device__ int band(const void* p, int r, int c) const {
    const int k = c - beg[r];
    return (k >= 0 && k < W && c <= end[r]) ? ld(p, (size_t)r * W + k) : inf;
  }
  // a cell inside row r's window only (fused_loop.py:632 `gat_rows`)
  __device__ int window(const void* p, int r, int c) const {
    const int k = c - beg[r];
    return (k >= 0 && k < W) ? ld(p, (size_t)r * W + k) : inf;
  }
};

__global__ void backtrack_kernel(Planes pl_in, const int* __restrict__ pre_idx,
                                 const int* __restrict__ pre_cnt,
                                 const int* __restrict__ base,
                                 const int* __restrict__ query,
                                 const int* __restrict__ mat,
                                 const int* __restrict__ sc, int* ops,
                                 int* res, int P, int m, int gap_mode,
                                 int flags) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  Planes pl = pl_in;
  pl.inf = sc[6];
  const bool gap_on_right = flags & 1, local = flags & 4;
  const bool linear = gap_mode == kLinear, convex = gap_mode == kConvex;
  int i = sc[0], j = sc[1];
  const int e1 = sc[2], oe1 = sc[3], e2 = sc[4], oe2 = sc[5];
  const int max_ops = sc[7];
  int cur_op = kAll, look_gap = (flags & 2) ? 1 : 0;
  int n_ops = 0, n_aln = 0, n_match = 0, err = 0;

  while (i > 0 && j > 0) {
    const int H_ij = pl.band(pl.H, i, j);
    if (local && H_ij == 0) break;
    const int bi = base[i] & 0xFF, qb = query[j - 1];
    const int s = mat[bi * m + qb];
    const int* preds = pre_idx + (size_t)i * P;
    const int npre = pre_cnt[i];
    const bool has_M = (cur_op & kM) != 0;

    int first_m = -1;
    for (int k = 0; k < npre; ++k) {
      const int p = preds[k];
      if (j - 1 >= pl.beg[p] && j - 1 <= pl.end[p] &&
          pl.window(pl.H, p, j - 1) + s == H_ij) {
        first_m = k;
        break;
      }
    }
    const bool any_m = first_m >= 0;
    const bool m1 =
        !gap_on_right && any_m && look_gap == 0 && (linear || has_M);

    int first_d = -1, d_new_op = kAll;
    for (int k = 0; k < npre; ++k) {
      const int p = preds[k];
      if (j < pl.beg[p] || j > pl.end[p]) continue;
      const int ph = pl.window(pl.H, p, j);
      if (linear) {
        if (ph - e1 == H_ij) {
          first_d = k;
          break;
        }
        continue;
      }
      const int pe1 = pl.window(pl.E1, p, j);
      const bool hit1 =
          (cur_op & kE1) != 0 &&
          (has_M ? H_ij == pe1 : pl.band(pl.E1, i, j) == pe1 - e1);
      bool hit2 = false;
      int pe2 = 0;
      if (convex) {
        pe2 = pl.window(pl.E2, p, j);
        hit2 = (cur_op & kE2) != 0 &&
               (has_M ? H_ij == pe2 : pl.band(pl.E2, i, j) == pe2 - e2);
      }
      if (hit1 || hit2) {
        first_d = k;
        if (hit1)
          d_new_op = ph - oe1 == pe1 ? (kM | kF) : kE1;
        else
          d_new_op = ph - oe2 == pe2 ? (kM | kF) : kE2;
        break;
      }
    }
    const bool any_d = first_d >= 0;

    const int H_ijm1 = pl.band(pl.H, i, j - 1);
    bool ins_hit;
    int ins_new_op = kAll;
    if (linear) {
      ins_hit = H_ijm1 - e1 == H_ij;
    } else {
      const int F1_ij = pl.band(pl.F1, i, j);
      const bool f1_open = H_ijm1 - oe1 == F1_ij;
      const bool f1_hit =
          (cur_op & kF1) != 0 && (!has_M || H_ij == F1_ij) &&
          (f1_open || pl.band(pl.F1, i, j - 1) - e1 == F1_ij);
      bool f2_hit = false;
      int f2_op = kAll;
      if (convex) {
        const int F2_ij = pl.band(pl.F2, i, j);
        const bool f2_open = H_ijm1 - oe2 == F2_ij;
        f2_hit = (cur_op & kF2) != 0 && (!has_M || H_ij == F2_ij) &&
                 (f2_open || pl.band(pl.F2, i, j - 1) - e2 == F2_ij);
        f2_op = f2_open ? (kM | kE) : kF2;
      }
      ins_hit = f1_hit || f2_hit;
      ins_new_op = f1_hit ? (f1_open ? (kM | kE) : kF1) : f2_op;
    }

    const bool m2 = any_m && (linear || has_M);
    const bool d_sel = !m1 && any_d;
    const bool i_sel = !m1 && !d_sel && ins_hit;
    const bool m2_sel = !m1 && !d_sel && !i_sel && m2;
    if (!(m1 || d_sel || i_sel || m2_sel)) {
      err = 1;
      break;
    }
    const bool m_sel = m1 || m2_sel;
    ops[2 * n_ops] = m_sel ? 0 : (d_sel ? 1 : 2);
    ops[2 * n_ops + 1] = i;
    ++n_ops;
    const bool cap = n_ops >= max_ops;
    if (m_sel) {
      ++n_aln;
      n_match += bi == qb ? 1 : 0;
      i = preds[first_m];
      --j;
      cur_op = kAll;
    } else if (d_sel) {
      i = preds[first_d];
      cur_op = d_new_op;
    } else {
      ++n_aln;
      --j;
      cur_op = ins_new_op;
    }
    if (!m1) look_gap = 0;
    if (cap) {
      err = 1;
      break;
    }
  }
  res[0] = n_ops;
  res[1] = i;
  res[2] = j;
  res[3] = n_aln;
  res[4] = n_match;
  res[5] = err;
}

}  // namespace

// Launches the walk on `stream` and returns a cudaError_t as an int
// (0 = launched). flags: 1 put_gap_on_right, 2 put_gap_at_end, 4 local,
// 8 int16 planes. ops must be zeroed by the caller.
extern "C" int abpoa_backtrack(const void* H, const void* E1, const void* E2,
                               const void* F1, const void* F2,
                               const void* beg, const void* end,
                               const void* pre_idx, const void* pre_cnt,
                               const void* base, const void* query,
                               const void* mat, const void* sc, void* ops,
                               void* res, int R, int W, int P, int m, int Q,
                               int max_ops, int gap_mode, int flags,
                               void* stream) {
  if (R < 1 || W < 1 || max_ops < 1 || m < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  // -inf (sc[6]) lives on the device; the kernel fills it in
  Planes pl{H, E1, E2, F1, F2, (const int*)beg, (const int*)end, W, 0,
            (flags & 8) != 0};
  cudaStream_t s = (cudaStream_t)stream;
  backtrack_kernel<<<1, 32, 0, s>>>(pl, (const int*)pre_idx,
                                    (const int*)pre_cnt, (const int*)base,
                                    (const int*)query, (const int*)mat,
                                    (const int*)sc, (int*)ops, (int*)res, P,
                                    m, gap_mode, flags);
  return (int)cudaGetLastError();
}
