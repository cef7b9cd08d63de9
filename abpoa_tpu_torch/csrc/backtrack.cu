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
// ~qlen + deletions steps of a walk run one after another. A step moves a
// few dozen bytes and does a few dozen integer operations: it is bound by
// the latency of its dependent loads, far from the card's bytes or
// operations bounds. The planes of a 10 kb read are several hundred MB, far
// past the 50 MB L2, so most of those loads go to device memory.
//
// What the design does about it: one warp walks. Every load of a step that
// does not depend on another is issued at once, so a step is three
// dependent rounds instead of about ten:
//  1. the row's band, predecessor count, base, the query base, and lane k's
//     predecessor slot k;
//  2. the current row's H/E1/E2/F1/F2 at j and j-1, the score, and each
//     lane's predecessor's band;
//  3. each lane's predecessor cells H[p][j-1], H[p][j], E1[p][j], E2[p][j].
// The first match and the first deletion among the slots are
// __ffs(__ballot_sync(...)); slots past 32 go in further chunks of 32 only
// while one of the two is still missing. Every lane keeps the walk's state,
// so no value is broadcast but the chosen predecessor; lane 0 writes the
// op stream.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
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
  bool p16;

  __device__ int ld(const void* p, size_t i) const {
    return p16 ? (int)((const short*)p)[i] : ((const int*)p)[i];
  }
  // a cell of row r at column c inside the window that starts at rbeg; the
  // load is made at a clamped address either way (fused_loop.py:632
  // `gat_rows`; `gat`, :625, also asks c <= end[r])
  __device__ int cell(const void* p, int r, int rbeg, int c, bool in,
                      int inf) const {
    const int k = c - rbeg;
    const bool ok = in && k >= 0 && k < W;
    const int v = ld(p, (size_t)r * W + min(max(k, 0), W - 1));
    return ok ? v : inf;
  }
};

// The walk of X1 from cell (i, j) back to row 0 (or, in local mode, to a
// zero cell): ops written by lane 0, the end cell, the counts, err, and the
// cell the last step started from. With PS each predecessor slot's path
// score pre_score[i * P + k] enters every equality that crosses to that
// predecessor (jax_backtrack.py:73-110); X1w (backtrack_windows.cu) walks
// the same chain from shared-memory tiles.
struct Walk {
  int i, j, n_ops, n_aln, n_match, err, si, sj;
};

template <bool PS>
__device__ __forceinline__ Walk walk(
    const Planes& pl, const int* __restrict__ pre_idx,
    const int* __restrict__ pre_cnt, const int* __restrict__ base,
    const int* __restrict__ query, const int* __restrict__ mat, int* ops,
    int i, int j, int e1, int oe1, int e2, int oe2, int inf, int max_ops,
    int P, int m, int gap_mode, int flags, int lane,
    const int* __restrict__ pre_score) {
  const bool gap_on_right = flags & 1, local = flags & 4;
  const bool linear = gap_mode == kLinear, convex = gap_mode == kConvex;
  int cur_op = kAll, look_gap = (flags & 2) ? 1 : 0;
  int n_ops = 0, n_aln = 0, n_match = 0, err = 0;
  Walk w;
  w.si = i;
  w.sj = j;

  while (i > 0 && j > 0) {
    // round 1
    const int* preds = pre_idx + (size_t)i * P;
    const int rbeg = pl.beg[i], rend = pl.end[i], npre = pre_cnt[i];
    const int bi = base[i] & 0xFF, qb = query[j - 1];
    const int p0 = lane < P ? preds[lane] : 0;
    // round 2
    const int s = mat[bi * m + qb];
    const bool at_j = j <= rend, at_jm1 = j - 1 <= rend;
    const int H_ij = pl.cell(pl.H, i, rbeg, j, at_j, inf);
    const int H_ijm1 = pl.cell(pl.H, i, rbeg, j - 1, at_jm1, inf);
    int E1_ij = inf, E2_ij = inf, F1_ij = inf, F1_ijm1 = inf, F2_ij = inf,
        F2_ijm1 = inf;
    if (!linear) {
      E1_ij = pl.cell(pl.E1, i, rbeg, j, at_j, inf);
      F1_ij = pl.cell(pl.F1, i, rbeg, j, at_j, inf);
      F1_ijm1 = pl.cell(pl.F1, i, rbeg, j - 1, at_jm1, inf);
      if (convex) {
        E2_ij = pl.cell(pl.E2, i, rbeg, j, at_j, inf);
        F2_ij = pl.cell(pl.F2, i, rbeg, j, at_j, inf);
        F2_ijm1 = pl.cell(pl.F2, i, rbeg, j - 1, at_jm1, inf);
      }
    }
    if (local && H_ij == 0) break;
    w.si = i;
    w.sj = j;
    const bool has_M = (cur_op & kM) != 0;

    // the predecessor slots, 32 at a time (round 2: their bands; round 3:
    // their cells)
    int first_m = -1, first_d = -1, pm = 0, pd = 0, d_new_op = kAll;
    for (int c0 = 0; c0 < npre && (first_m < 0 || first_d < 0); c0 += 32) {
      const int k = c0 + lane;
      const bool has = k < npre;
      const int p = c0 == 0 ? p0 : (has ? preds[k] : 0);
      const int ps = PS && has ? pre_score[(size_t)i * P + k] : 0;
      const int pb = pl.beg[p], pe = pl.end[p];
      const int ph_m = pl.cell(pl.H, p, pb, j - 1, true, inf);
      const int ph = pl.cell(pl.H, p, pb, j, true, inf);
      const int pe1 = linear ? inf : pl.cell(pl.E1, p, pb, j, true, inf);
      const int pe2 = convex ? pl.cell(pl.E2, p, pb, j, true, inf) : inf;
      const bool m_hit =
          has && j - 1 >= pb && j - 1 <= pe && ph_m + s + ps == H_ij;
      bool d_hit = false;
      int op = kAll;
      if (has && j >= pb && j <= pe) {
        if (linear) {
          d_hit = ph - e1 + ps == H_ij;
        } else {
          const bool hit1 = (cur_op & kE1) != 0 &&
                            (has_M ? H_ij == pe1 + ps : E1_ij == pe1 - e1 + ps);
          const bool hit2 = convex && (cur_op & kE2) != 0 &&
                            (has_M ? H_ij == pe2 + ps : E2_ij == pe2 - e2 + ps);
          d_hit = hit1 || hit2;
          if (hit1)
            op = ph - oe1 == pe1 ? (kM | kF) : kE1;
          else
            op = ph - oe2 == pe2 ? (kM | kF) : kE2;
        }
      }
      const unsigned bm = __ballot_sync(kFull, m_hit);
      const unsigned bd = __ballot_sync(kFull, d_hit);
      if (first_m < 0 && bm) {
        const int src = __ffs(bm) - 1;
        first_m = c0 + src;
        pm = __shfl_sync(kFull, p, src);
      }
      if (first_d < 0 && bd) {
        const int src = __ffs(bd) - 1;
        first_d = c0 + src;
        pd = __shfl_sync(kFull, p, src);
        d_new_op = __shfl_sync(kFull, op, src);
      }
    }
    const bool any_m = first_m >= 0, any_d = first_d >= 0;
    const bool m1 =
        !gap_on_right && any_m && look_gap == 0 && (linear || has_M);

    bool ins_hit;
    int ins_new_op = kAll;
    if (linear) {
      ins_hit = H_ijm1 - e1 == H_ij;
    } else {
      const bool f1_open = H_ijm1 - oe1 == F1_ij;
      const bool f1_hit = (cur_op & kF1) != 0 && (!has_M || H_ij == F1_ij) &&
                          (f1_open || F1_ijm1 - e1 == F1_ij);
      bool f2_hit = false;
      int f2_op = kAll;
      if (convex) {
        const bool f2_open = H_ijm1 - oe2 == F2_ij;
        f2_hit = (cur_op & kF2) != 0 && (!has_M || H_ij == F2_ij) &&
                 (f2_open || F2_ijm1 - e2 == F2_ij);
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
    if (lane == 0) {
      ops[2 * n_ops] = m_sel ? 0 : (d_sel ? 1 : 2);
      ops[2 * n_ops + 1] = i;
    }
    ++n_ops;
    const bool cap = n_ops >= max_ops;
    if (m_sel) {
      ++n_aln;
      n_match += bi == qb ? 1 : 0;
      i = pm;
      --j;
      cur_op = kAll;
    } else if (d_sel) {
      i = pd;
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
  w.i = i;
  w.j = j;
  w.n_ops = n_ops;
  w.n_aln = n_aln;
  w.n_match = n_match;
  w.err = err;
  return w;
}

__global__ void __launch_bounds__(32)
backtrack_kernel(Planes pl, const int* __restrict__ pre_idx,
                 const int* __restrict__ pre_cnt, const int* __restrict__ base,
                 const int* __restrict__ query, const int* __restrict__ mat,
                 const int* __restrict__ sc, int* ops, int* res, int P, int m,
                 int gap_mode, int flags) {
  if (blockIdx.x != 0) return;
  const int lane = threadIdx.x;
  const int inf = sc[6];
  const int i = sc[0], j = sc[1];
  const int e1 = sc[2], oe1 = sc[3], e2 = sc[4], oe2 = sc[5];
  const int max_ops = sc[7];
  const Walk w = walk<false>(pl, pre_idx, pre_cnt, base, query, mat, ops, i,
                             j, e1, oe1, e2, oe2, inf, max_ops, P, m,
                             gap_mode, flags, lane, nullptr);
  if (lane == 0) {
    res[0] = w.n_ops;
    res[1] = w.i;
    res[2] = w.j;
    res[3] = w.n_aln;
    res[4] = w.n_match;
    res[5] = w.err;
  }
}

}  // namespace

// Launches the walk (one warp) on `stream` and returns a cudaError_t as an
// int (0 = launched). flags: 1 put_gap_on_right, 2 put_gap_at_end, 4 local,
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
  if (R < 1 || W < 1 || P < 1 || max_ops < 1 || m < 1 || Q < 1)
    return (int)cudaErrorInvalidValue;
  Planes pl{H, E1, E2, F1, F2, (const int*)beg, (const int*)end, W,
            (flags & 8) != 0};
  cudaStream_t s = (cudaStream_t)stream;
  backtrack_kernel<<<1, 32, 0, s>>>(pl, (const int*)pre_idx,
                                    (const int*)pre_cnt, (const int*)base,
                                    (const int*)query, (const int*)mat,
                                    (const int*)sc, (int*)ops, (int*)res, P,
                                    m, gap_mode, flags);
  return (int)cudaGetLastError();
}
