// Banded adaptive-band POA forward DP for one read against one graph,
// written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel abpoa_tpu/align/pallas_kernel.py
// `pallas_banded_dp` (body `_make_kernel`), with the helpers `band_extents`
// and `qp_band_row` of abpoa_tpu/align/pallas_common.py. It computes the
// same thing row for row: convex gaps, global mode, int32 scores. The
// plain PyTorch version is `banded_dp_torch` in align/banded_kernel.py and
// must agree with this kernel bit for bit on all five planes.
//
// What bounds it: the rows form a serial chain. Row i reads the H/E1/E2
// rows of its predecessors and its band start depends on the argmax of
// earlier rows, so the R rows (up to ~60k for a 10 kb read) run one after
// another, each costing a handful of block-wide barriers plus the latency of
// reading the predecessor rows back. The bytes it moves (5*W*4 written and
// about 3*W*4 read per predecessor, per row) and its integer operations are
// far below what the card could stream or compute in that time: it is
// latency bound, not bandwidth or compute bound.
//
// What the design does about it: one thread block owns the whole
// alignment, so rows are ordered by __syncthreads() alone and need no grid
// sync or relaunch per row. Columns go across threads, CPT contiguous
// columns per thread (so W > 1024 works). Predecessor rows are read straight
// from the output planes in device memory; the last rows sit in the 50 MB L2,
// so unlike the TPU kernel there is no ring of recent rows and no ring
// overflow, and `ok` reports band overflow only. The per-row band scalars
// (dp_beg/dp_end, mpl/mpr) live in the begend/mplr outputs in device memory
// (4*R ints do not fit in shared memory); thread 0 alone updates them. The
// two F gap chains are one block-wide max-plus prefix scan in 64-bit
// (warp shuffles, then one carry per warp through shared memory), so no
// intermediate can overflow int32. Making the chain of rows shorter (several
// reads per launch, fewer barriers per row) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCpt = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kScanId = -(1LL << 62);  // identity of the max scan
constexpr int kIntMin = -2147483647 - 1;

__device__ __forceinline__ int max3(int a, int b, int c) {
  return max(max(a, b), c);
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
banded_dp_kernel(const int* __restrict__ sc, const int* __restrict__ base,
                 const int* __restrict__ pre_idx,
                 const int* __restrict__ pre_cnt,
                 const int* __restrict__ out_idx,
                 const int* __restrict__ out_cnt,
                 const int* __restrict__ remain,
                 const int* __restrict__ mpl0, const int* __restrict__ mpr0,
                 const int* __restrict__ qp, const int* __restrict__ row0,
                 int* H, int* E1, int* E2, int* F1, int* F2, int* begend,
                 int* mplr, int* ok_out, int R, int W, int P, int O, int QW) {
  __shared__ int s_beg, s_end, s_ovf;
  __shared__ int s_last_hhat[kMaxThreads];
  __shared__ long long s_warp1[kMaxWarps], s_warp2[kMaxWarps];
  __shared__ int s_wmax[kMaxWarps], s_wleft[kMaxWarps], s_wright[kMaxWarps];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  const int qlen = sc[0], w = sc[1], remain_end = sc[2], inf = sc[3];
  const int e1 = sc[5], oe1 = sc[6], e2 = sc[8], oe2 = sc[9];
  const int gn = sc[10], end0 = sc[11];

  // band state seeded from the host tables; row 0 comes from the host
  for (int k = tid; k < R; k += nthreads) {
    mplr[k] = mpl0[k];
    mplr[R + k] = mpr0[k];
    begend[k] = 0;
    begend[R + k] = 0;
  }
  for (int k = tid; k < W; k += nthreads) {
    H[k] = row0[k];
    E1[k] = row0[W + k];
    E2[k] = row0[2 * W + k];
    F1[k] = row0[3 * W + k];
    F2[k] = row0[4 * W + k];
  }
  __syncthreads();
  if (tid == 0) begend[R] = end0;
  int ok = (end0 + 1 > W) ? 0 : 1;  // block-uniform

  int row = 1;
  for (; row < R; ++row) {
    if (row >= gn - 1 || !ok) break;

    // ---- band of this row (pallas_kernel.py:89-108), thread 0 only
    if (tid == 0) {
      const int r = qlen - (remain[row] - remain_end - 1);
      int beg = max(0, min(mplr[row], r) - w);
      const int end = min(qlen, max(mplr[R + row], r) + w);
      const int npre = pre_cnt[row];
      int min_pre_beg = 1 << 30;
      for (int k = 0; k < npre; ++k)
        min_pre_beg = min(min_pre_beg, begend[pre_idx[(size_t)row * P + k]]);
      beg = max(beg, min_pre_beg);
      begend[row] = beg;
      begend[R + row] = end;
      s_beg = beg;
      s_end = end;
      s_ovf = (end - beg + 1 > W) ? 1 : 0;
    }
    __syncthreads();
    const int beg = s_beg, end = s_end;
    ok = ok && !s_ovf;  // the overflow row itself is still computed

    // ---- max over predecessors of H shifted by one column and of E1/E2
    int mq[CPT], e1r[CPT], e2r[CPT], hhat[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) mq[c] = e1r[c] = e2r[c] = inf;
    const int npre = pre_cnt[row];
    for (int k = 0; k < npre; ++k) {
      const int p = pre_idx[(size_t)row * P + k];
      const int pbeg = begend[p], pend = begend[R + p];
      const int* Hp = H + (size_t)p * W;
      const int* E1p = E1 + (size_t)p * W;
      const int* E2p = E2 + (size_t)p * W;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        if (lane >= W) continue;
        const int col = beg + lane;
        if (col - 1 >= pbeg && col - 1 <= pend && col - 1 - pbeg < W)
          mq[c] = max(mq[c], Hp[col - 1 - pbeg]);
        if (col >= pbeg && col <= pend && col - pbeg < W) {
          e1r[c] = max(e1r[c], E1p[col - pbeg]);
          e2r[c] = max(e2r[c], E2p[col - pbeg]);
        }
      }
    }

    // ---- query profile band (qp_band_row), H-hat = max(M, E1, E2)
    const int* qrow = qp + (size_t)base[row] * QW + beg;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      const bool in_band = lane < W && beg + lane <= end;
      if (in_band) {
        mq[c] += qrow[lane];
      } else {
        mq[c] = e1r[c] = e2r[c] = inf;
      }
      hhat[c] = max3(mq[c], e1r[c], e2r[c]);
    }
    s_last_hhat[tid] = hhat[CPT - 1];
    __syncthreads();

    // ---- F chains: F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext), computed
    // as a prefix max of A[k] + k*ext in 64 bit (pallas_kernel.py:139-154)
    const int hm1_first = tid > 0 ? s_last_hhat[tid - 1] : inf;
    long long t1[CPT], t2[CPT];
    long long run1 = kScanId, run2 = kScanId;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int lane = tid * CPT + c;
      const bool in_band = lane < W && beg + lane <= end;
      const int hm1 = c == 0 ? hm1_first : hhat[c - 1];
      const int src = lane == 0 ? mq[c] : hm1;
      const int a1 = in_band ? src - oe1 : inf;
      const int a2 = in_band ? src - oe2 : inf;
      if (lane < W) {
        run1 = max(run1, (long long)a1 + (long long)lane * e1);
        run2 = max(run2, (long long)a2 + (long long)lane * e2);
      }
      t1[c] = run1;
      t2[c] = run2;
    }
    long long inc1 = run1, inc2 = run2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long v1 = __shfl_up_sync(kFull, inc1, off);
      const long long v2 = __shfl_up_sync(kFull, inc2, off);
      if (lane_id >= off) {
        inc1 = max(inc1, v1);
        inc2 = max(inc2, v2);
      }
    }
    long long ex1 = __shfl_up_sync(kFull, inc1, 1);
    long long ex2 = __shfl_up_sync(kFull, inc2, 1);
    if (lane_id == 0) ex1 = ex2 = kScanId;
    if (lane_id == 31) {
      s_warp1[warp] = inc1;
      s_warp2[warp] = inc2;
    }
    __syncthreads();
    for (int k = 0; k < warp; ++k) {
      ex1 = max(ex1, s_warp1[k]);
      ex2 = max(ex2, s_warp2[k]);
    }

    // ---- H, E updates, band mask, store; local row max
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
      const long long m1 = max(ex1, t1[c]) - (long long)lane * e1;
      const long long m2 = max(ex2, t2[c]) - (long long)lane * e2;
      int f1 = (int)max(m1, (long long)inf);
      int f2 = (int)max(m2, (long long)inf);
      int h = max(hhat[c], max(f1, f2));
      int en1 = max(e1r[c] - e1, h - oe1);
      int en2 = max(e2r[c] - e2, h - oe2);
      if (!in_band) h = en1 = en2 = f1 = f2 = inf;
      const size_t at = (size_t)row * W + lane;
      H[at] = h;
      E1[at] = en1;
      E2[at] = en2;
      F1[at] = f1;
      F2[at] = f2;
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

    // ---- scatter the argmax range into the successors' mpl/mpr
    if (tid == 0) {
      for (int k = 1; k < nwarps; ++k) {
        left = min(left, s_wleft[k]);
        right = max(right, s_wright[k]);
      }
      if (!(mx > inf)) left = right = -1;
      const int nout = out_cnt[row];
      for (int k = 0; k < nout; ++k) {
        const int t = out_idx[(size_t)row * O + k];
        mplr[R + t] = max(mplr[R + t], right + 1);
        mplr[t] = min(mplr[t], left + 1);
      }
    }
  }

  // rows past the last computed one are padding
  const size_t pad_from = (size_t)row * W, total = (size_t)R * W;
  for (size_t k = pad_from + tid; k < total; k += nthreads) {
    H[k] = inf;
    E1[k] = inf;
    E2[k] = inf;
    F1[k] = inf;
    F2[k] = inf;
  }
  if (tid == 0) ok_out[0] = ok;
}

template <int CPT>
void launch(int threads, cudaStream_t stream, const int* sc, const int* base,
            const int* pre_idx, const int* pre_cnt, const int* out_idx,
            const int* out_cnt, const int* remain, const int* mpl0,
            const int* mpr0, const int* qp, const int* row0, int* H, int* E1,
            int* E2, int* F1, int* F2, int* begend, int* mplr, int* ok,
            int R, int W, int P, int O, int QW) {
  banded_dp_kernel<CPT><<<1, threads, 0, stream>>>(
      sc, base, pre_idx, pre_cnt, out_idx, out_cnt, remain, mpl0, mpr0, qp,
      row0, H, E1, E2, F1, F2, begend, mplr, ok, R, W, P, O, QW);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = launched). Pointers are device pointers to int32 arrays.
extern "C" int abpoa_banded_dp(const void* sc, const void* base,
                               const void* pre_idx, const void* pre_cnt,
                               const void* out_idx, const void* out_cnt,
                               const void* remain, const void* mpl0,
                               const void* mpr0, const void* qp,
                               const void* row0, void* H, void* E1, void* E2,
                               void* F1, void* F2, void* begend, void* mplr,
                               void* ok, int R, int W, int P, int O, int QW,
                               void* stream) {
  int cpt = 1;
  while (cpt * kMaxThreads < W) cpt *= 2;
  if (cpt > kMaxCpt || W < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int threads = ((W + cpt - 1) / cpt + 31) / 32 * 32;
  cudaStream_t s = (cudaStream_t)stream;
#define ABPOA_ARGS                                                          \
  threads, s, (const int*)sc, (const int*)base, (const int*)pre_idx,        \
      (const int*)pre_cnt, (const int*)out_idx, (const int*)out_cnt,        \
      (const int*)remain, (const int*)mpl0, (const int*)mpr0,               \
      (const int*)qp, (const int*)row0, (int*)H, (int*)E1, (int*)E2,        \
      (int*)F1, (int*)F2, (int*)begend, (int*)mplr, (int*)ok, R, W, P, O, QW
  switch (cpt) {
    case 1: launch<1>(ABPOA_ARGS); break;
    case 2: launch<2>(ABPOA_ARGS); break;
    case 4: launch<4>(ABPOA_ARGS); break;
    case 8: launch<8>(ABPOA_ARGS); break;
    case 16: launch<16>(ABPOA_ARGS); break;
    default: launch<32>(ABPOA_ARGS); break;
  }
#undef ABPOA_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* abpoa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
