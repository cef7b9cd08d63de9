// The fused loop's banded forward DP for one read against one graph
// (kernels B1 and B3), written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels abpoa_tpu/align/pallas_fused.py
// `pallas_fused_dp` (body `_make_kernel`, row math `_row_dp_math`) and
// `pallas_fused_dp_local_hbm` (`_make_local_hbm_kernel`). It computes the
// same thing row for row: linear, affine or convex gaps (template GAP);
// global, extend (with Z-drop) or local mode (runtime `mode`, uniform over
// the block); int16 or int32 planes (runtime `plane16`), with every value
// computed in int32 and stored in the plane type. The plain PyTorch version
// is `fused_dp_torch` in align/fused_dp_kernel.py and must agree with this
// kernel bit for bit on all nine outputs.
//
// What bounds it: as for banded_dp.cu, the rows form a serial chain (each
// row reads its predecessors' rows and its band start depends on earlier
// rows' argmax), so a read's R rows run one after another, each costing a
// handful of block-wide barriers and the latency of reading predecessor
// rows back from L2. Its bytes and integer operations are far below what
// the card could stream or compute in that time: it is latency bound.
//
// What the design does about it: one block owns the alignment and loops
// over rows, ordered by __syncthreads(); columns go across threads, CPT
// contiguous columns per thread (W up to 16384 for local mode at 10 kb).
// Predecessor rows are read from the output planes, so there is no ring:
// B1's ring overflow (a predecessor or successor 512 or more rows away) does
// not exist here, `ok` reports only a band wider than W, and local mode at
// any width is this kernel with mode = local (B3's case). Per-row band
// scalars live in device memory (beg/end in the outputs, mpl/mpr in a
// scratch array) and thread 0 alone updates them, as it does the extend and
// local best-cell state. The gap chains are a block-wide max-plus prefix
// scan in 64 bit. Row 0 is written from the row0 input and rows past the
// last computed one are filled with -inf, so the outputs need no patching.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kScanId = -(1LL << 62);  // identity of the max scan
constexpr int kIntMin = -2147483647 - 1;
constexpr int kLinear = 0, kAffine = 1, kConvex = 2;
constexpr int kExtend = 1, kLocal = 2;  // mode 0 is global

__device__ __forceinline__ int ld(const void* p, size_t i, bool p16) {
  return p16 ? (int)((const short*)p)[i] : ((const int*)p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, int v, bool p16) {
  if (p16)
    ((short*)p)[i] = (short)v;
  else
    ((int*)p)[i] = v;
}

// Block-wide inclusive max scan of per-thread runs: returns the exclusive
// carry for this thread (the max over all earlier threads' runs).
__device__ __forceinline__ long long scan_carry(long long run,
                                                long long* s_warp, int lane_id,
                                                int warp) {
  long long inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(kFull, inc, off);
    if (lane_id >= off) inc = max(inc, v);
  }
  long long ex = __shfl_up_sync(kFull, inc, 1);
  if (lane_id == 0) ex = kScanId;
  if (lane_id == 31) s_warp[warp] = inc;
  __syncthreads();
  for (int k = 0; k < warp; ++k) ex = max(ex, s_warp[k]);
  return ex;
}

template <int CPT, int GAP>
__global__ void __launch_bounds__(kMaxThreads)
fused_dp_kernel(const int* __restrict__ sc, const int* __restrict__ base,
                const int* __restrict__ pre_idx,
                const int* __restrict__ pre_cnt,
                const int* __restrict__ out_idx,
                const int* __restrict__ out_cnt,
                const int* __restrict__ remain, const int* __restrict__ row0,
                const int* __restrict__ qp, void* H, void* E1, void* E2,
                void* F1, void* F2, int* begend, int* ok_out, int* ext_out,
                int* mplr, int R, int W, int P, int O, int QW, int mode,
                int zdrop_on, int plane16) {
  __shared__ int s_beg, s_end, s_ovf;
  __shared__ int s_last_hhat[kMaxThreads];
  __shared__ long long s_warp1[kMaxWarps], s_warp2[kMaxWarps];
  __shared__ int s_wmax[kMaxWarps], s_wleft[kMaxWarps], s_wright[kMaxWarps];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const bool p16 = plane16 != 0;
  const bool local = mode == kLocal, extend = mode == kExtend;

  const int qlen = sc[0], w = sc[1], remain_end = sc[2], inf = sc[3];
  const int e1 = sc[4], oe1 = sc[5], e2 = sc[6], oe2 = sc[7];
  const int gn = sc[8], end0 = sc[9], zdrop = sc[10];

  for (int k = tid; k < R; k += nthreads) {
    mplr[k] = gn;
    mplr[R + k] = 0;
    begend[k] = 0;
    begend[R + k] = 0;
  }
  for (int k = tid; k < W; k += nthreads) {
    st(H, k, row0[k], p16);
    st(E1, k, row0[W + k], p16);
    st(E2, k, row0[2 * W + k], p16);
    st(F1, k, row0[3 * W + k], p16);
    st(F2, k, row0[4 * W + k], p16);
  }
  __syncthreads();
  if (tid == 0) begend[R] = end0;
  int ok = (end0 + 1 > W) ? 0 : 1;  // block-uniform
  // best-cell state (thread 0): score, row, column, remain, zdropped
  int bs = inf, bi = 0, bj = 0, brem = 0, zdropped = 0;

  int row = 1;
  for (; row < R; ++row) {
    if (row >= gn - 1 || !ok) break;

    // ---- band of this row (pallas_fused.py:235-286), thread 0 only
    if (tid == 0) {
      int beg, end;
      if (local) {
        beg = 0;
        end = qlen;
      } else {
        if (base[row] & 0x100) {  // a successor of the source row
          mplr[row] = min(mplr[row], 1);
          mplr[R + row] = max(mplr[R + row], 1);
        }
        const int r = qlen - (remain[row] - remain_end - 1);
        beg = max(0, min(mplr[row], r) - w);
        end = min(qlen, max(mplr[R + row], r) + w);
        const int npre = pre_cnt[row];
        int min_pre_beg = 1 << 30;
        for (int k = 0; k < npre; ++k)
          min_pre_beg =
              min(min_pre_beg, begend[pre_idx[(size_t)row * P + k]]);
        beg = max(beg, min_pre_beg);
      }
      begend[row] = beg;
      begend[R + row] = end;
      s_beg = beg;
      s_end = end;
      s_ovf = (end - beg + 1 > W) ? 1 : 0;
    }
    __syncthreads();
    const int beg = s_beg, end = s_end;
    ok = ok && !s_ovf;  // the overflow row itself is still computed

    // ---- predecessor maxima: H one column left, and E1/E2 (linear: H)
    int mq[CPT], e1r[CPT], e2r[CPT], hhat[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) mq[c] = e1r[c] = e2r[c] = inf;
    const int npre = pre_cnt[row];
    for (int k = 0; k < npre; ++k) {
      const int p = pre_idx[(size_t)row * P + k];
      const int pbeg = begend[p], pend = begend[R + p];
      const size_t pr = (size_t)p * W;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        if (lane >= W) continue;
        const int col = beg + lane;
        if (col - 1 >= pbeg && col - 1 <= pend && col - 1 - pbeg < W)
          mq[c] = max(mq[c], ld(H, pr + col - 1 - pbeg, p16));
        if (col >= pbeg && col <= pend && col - pbeg < W) {
          if (GAP == kLinear) {
            e1r[c] = max(e1r[c], ld(H, pr + col - pbeg, p16));
          } else {
            e1r[c] = max(e1r[c], ld(E1, pr + col - pbeg, p16));
            if (GAP == kConvex)
              e2r[c] = max(e2r[c], ld(E2, pr + col - pbeg, p16));
          }
        }
      }
    }

    // ---- query profile band, local lead cell, H-hat
    const int* qrow = qp + (size_t)(base[row] & 0xFF) * QW + beg;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      const bool in_band = lane < W && beg + lane <= end;
      if (local && beg + lane == 0) mq[c] = max(mq[c], 0);
      mq[c] = in_band ? mq[c] + qrow[lane] : inf;
      if (GAP == kLinear) {
        e1r[c] = in_band ? e1r[c] - e1 : inf;  // E row from the preds' H
        hhat[c] = max(mq[c], e1r[c]);
      } else {
        if (!in_band) e1r[c] = e2r[c] = inf;
        hhat[c] = GAP == kConvex ? max(max(mq[c], e1r[c]), e2r[c])
                                 : max(mq[c], e1r[c]);
      }
    }
    if (GAP != kLinear) s_last_hhat[tid] = hhat[CPT - 1];
    __syncthreads();

    // ---- gap chains F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext) as a
    // prefix max of A[k] + k*ext in 64 bit (linear: A = H-hat itself)
    const int hm1_first = tid > 0 ? s_last_hhat[tid - 1] : inf;
    long long t1[CPT], t2[CPT];
    long long run1 = kScanId, run2 = kScanId;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      const bool in_band = lane < W && beg + lane <= end;
      int a1, a2 = inf;
      if (GAP == kLinear) {
        a1 = hhat[c];
      } else {
        const int hm1 = c == 0 ? hm1_first : hhat[c - 1];
        const int src = lane == 0 ? mq[c] : hm1;
        a1 = in_band ? src - oe1 : inf;
        if (GAP == kConvex) a2 = in_band ? src - oe2 : inf;
      }
      if (lane < W) {
        run1 = max(run1, (long long)a1 + (long long)lane * e1);
        if (GAP == kConvex)
          run2 = max(run2, (long long)a2 + (long long)lane * e2);
      }
      t1[c] = run1;
      t2[c] = run2;
    }
    const long long ex1 = scan_carry(run1, s_warp1, lane_id, warp);
    long long ex2 = kScanId;
    if (GAP == kConvex) ex2 = scan_carry(run2, s_warp2, lane_id, warp);

    // ---- H, E, F per regime (pallas_fused.py:59-123), store, local max
    int hrow[CPT];
    int local_max = kIntMin;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      if (lane >= W) {
        hrow[c] = kIntMin;
        continue;
      }
      const bool in_band = beg + lane <= end;
      const int f1 =
          (int)max(max(ex1, t1[c]) - (long long)lane * e1, (long long)inf);
      int h, en1 = inf, en2 = inf, g1 = inf, g2 = inf;
      if (GAP == kLinear) {
        h = f1;
        if (local) h = max(h, 0);
      } else if (GAP == kAffine) {
        g1 = f1;
        h = max(hhat[c], f1);
        if (local) h = max(h, 0);
        en1 = h == hhat[c] ? max(e1r[c] - e1, h - oe1) : (local ? 0 : inf);
      } else {
        g1 = f1;
        g2 = (int)max(max(ex2, t2[c]) - (long long)lane * e2, (long long)inf);
        h = max(hhat[c], max(g1, g2));
        if (local) h = max(h, 0);
        en1 = max(e1r[c] - e1, h - oe1);
        en2 = max(e2r[c] - e2, h - oe2);
        if (local) {
          en1 = max(en1, 0);
          en2 = max(en2, 0);
        }
      }
      if (!in_band) h = en1 = en2 = g1 = g2 = inf;
      const size_t at = (size_t)row * W + lane;
      st(H, at, h, p16);
      st(E1, at, en1, p16);
      st(E2, at, en2, p16);
      st(F1, at, g1, p16);
      st(F2, at, g2, p16);
      hrow[c] = h;
      local_max = max(local_max, h);
    }

    // ---- band_extents: row max, then leftmost/rightmost column holding it
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local_max = max(local_max, __shfl_xor_sync(kFull, local_max, off));
    if (lane_id == 0) s_wmax[warp] = local_max;
    __syncthreads();
    int mx = kIntMin;
    for (int k = 0; k < nwarps; ++k) mx = max(mx, s_wmax[k]);
    int left = 1 << 30, right = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      if (lane < W && beg + lane <= end && hrow[c] == mx) {
        left = min(left, beg + lane);
        right = max(right, beg + lane);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      left = min(left, __shfl_xor_sync(kFull, left, off));
      right = max(right, __shfl_xor_sync(kFull, right, off));
    }
    if (lane_id == 0) {
      s_wleft[warp] = left;
      s_wright[warp] = right;
    }
    __syncthreads();

    // ---- best cell (local, extend + Z-drop), then the successor scatter
    if (tid == 0) {
      for (int k = 1; k < nwarps; ++k) {
        left = min(left, s_wleft[k]);
        right = max(right, s_wright[k]);
      }
      const bool has_row = mx > inf;
      if (!has_row) left = right = -1;
      if (local && mx > bs) {
        bs = mx;
        bi = row;
        bj = left;
      }
      if (extend) {
        const bool better = !zdropped && mx > bs;
        if (zdrop_on && !zdropped && !better) {
          int zd;
          if (has_row) {
            const int delta = brem - remain[row];
            zd = bs - mx > zdrop + e1 * abs(delta - (right - bj));
          } else {
            zd = bs > inf;
          }
          zdropped = zd ? 1 : 0;
        }
        if (better) {
          bs = mx;
          bi = row;
          bj = right;
          brem = remain[row];
        }
      }
      if (!local && !(extend && zdrop_on && zdropped)) {
        const int nout = out_cnt[row];
        for (int k = 0; k < nout; ++k) {
          const int t = out_idx[(size_t)row * O + k];
          mplr[R + t] = max(mplr[R + t], right + 1);
          mplr[t] = min(mplr[t], left + 1);
        }
      }
    }
  }

  // rows past the last computed one are padding
  const size_t pad_from = (size_t)row * W, total = (size_t)R * W;
  for (size_t k = pad_from + tid; k < total; k += nthreads) {
    st(H, k, inf, p16);
    st(E1, k, inf, p16);
    st(E2, k, inf, p16);
    st(F1, k, inf, p16);
    st(F2, k, inf, p16);
  }
  if (tid == 0) {
    ok_out[0] = ok;
    const bool track = local || extend;
    ext_out[0] = track ? bs : inf;
    ext_out[1] = track ? bi : 0;
    ext_out[2] = track ? bj : 0;
    ext_out[3] = track ? zdropped : 0;
  }
}

template <int CPT>
cudaError_t launch_cpt(int gap, int threads, cudaStream_t s, const int* sc,
                       const int* base, const int* pre_idx,
                       const int* pre_cnt, const int* out_idx,
                       const int* out_cnt, const int* remain, const int* row0,
                       const int* qp, void* H, void* E1, void* E2, void* F1,
                       void* F2, int* begend, int* ok, int* ext, int* mplr,
                       int R, int W, int P, int O, int QW, int mode,
                       int zdrop_on, int plane16) {
#define ABPOA_FUSED_ARGS                                                     \
  sc, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, row0, qp, H, E1, E2, \
      F1, F2, begend, ok, ext, mplr, R, W, P, O, QW, mode, zdrop_on, plane16
  switch (gap) {
    case kLinear:
      fused_dp_kernel<CPT, kLinear><<<1, threads, 0, s>>>(ABPOA_FUSED_ARGS);
      break;
    case kAffine:
      fused_dp_kernel<CPT, kAffine><<<1, threads, 0, s>>>(ABPOA_FUSED_ARGS);
      break;
    case kConvex:
      fused_dp_kernel<CPT, kConvex><<<1, threads, 0, s>>>(ABPOA_FUSED_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef ABPOA_FUSED_ARGS
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = launched). gap_mode 0/1/2 = linear/affine/convex; mode 0/1/2 =
// global/extend/local. Planes are int16 when plane16 is 1, else int32.
extern "C" int abpoa_fused_dp(const void* sc, const void* base,
                              const void* pre_idx, const void* pre_cnt,
                              const void* out_idx, const void* out_cnt,
                              const void* remain, const void* row0,
                              const void* qp, void* H, void* E1, void* E2,
                              void* F1, void* F2, void* begend, void* ok,
                              void* ext, void* mplr, int R, int W, int P,
                              int O, int QW, int gap_mode, int mode,
                              int zdrop_on, int plane16, void* stream) {
  int cpt = 1;
  while (cpt * kMaxThreads < W) cpt *= 2;
  if (cpt > 16 || W < 1 || R < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int threads = ((W + cpt - 1) / cpt + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
#define ABPOA_ARGS                                                          \
  gap_mode, threads, s, (const int*)sc, (const int*)base,                   \
      (const int*)pre_idx, (const int*)pre_cnt, (const int*)out_idx,        \
      (const int*)out_cnt, (const int*)remain, (const int*)row0,            \
      (const int*)qp, H, E1, E2, F1, F2, (int*)begend, (int*)ok, (int*)ext, \
      (int*)mplr, R, W, P, O, QW, mode, zdrop_on, plane16
  cudaError_t err;
  switch (cpt) {
    case 1: err = launch_cpt<1>(ABPOA_ARGS); break;
    case 2: err = launch_cpt<2>(ABPOA_ARGS); break;
    case 4: err = launch_cpt<4>(ABPOA_ARGS); break;
    case 8: err = launch_cpt<8>(ABPOA_ARGS); break;
    default: err = launch_cpt<16>(ABPOA_ARGS); break;
  }
#undef ABPOA_ARGS
  return (int)err;
}
