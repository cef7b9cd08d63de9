// Kernel B2u: the per-read DP on whole-row windows, written for Hopper
// (sm_90a) with one thread-block cluster a window.
//
// Replaces: the XLA scan abpoa_tpu/align/jax_backend.py `_dp_scan` with
// `banded=False` (the JAX package's unbanded per-read DP: `-b < 0` in
// global or extend mode, and local mode, which is unbanded), and B2's
// whole-row case (csrc/fused_dp.cu with scalars[13] = 0), which it takes
// over: B2 now refuses such windows. Its plain version is `banded_dp_torch`
// in align/banded_kernel.py, which it must equal bit for bit on every
// output (the planes over rows 0..gn-2, begend, mplr, ok and ext) for the
// windows it takes: scalars[13] = 0 or local mode. Linear, affine or convex
// gaps (template GAP), global, extend (with Z-drop) or local mode, with or
// without `-G`'s path scores, over a ragged batch of B windows (`roff`, as
// B2 reads it), int32 planes.
//
// What bounds it: a window's rows form a serial chain, and a whole row is
// W = qlen + 1 (rounded) columns, ~10 k for a 10 kb read: ~350 KB a row move
// (five plane rows written, the predecessors' rows read), so a read of 12 k
// rows has a byte bound of ~0.7 ms. B2 ran such a row in one block of 1024
// threads at 16 contiguous columns a thread (stores strided 64 B apart, no
// shared-memory ring since three planes of W ints pass 227 KB, every
// predecessor read from device memory one at a time, the row max on the
// chain): ~60 us a row. The chain is latency: per row the predecessors'
// loads, a prefix max across the row, the stores.
//
// What the design does about it:
//  (a) one cluster of CS blocks a window (CS up to 16, launched with
//      cudaLaunchKernelEx and a cluster dimension; the wrapper picks CS from
//      W, align/fused_dp_kernel.py `unbanded_launch_shape`). Block c owns
//      the contiguous lanes [c S, (c + 1) S) of the row, and inside a block
//      warp w the run of 32 K lanes [w 32 K, (w + 1) 32 K): lane l of the
//      warp takes lanes k 32 + l of its run (k < K), so every load and store
//      of the planes is a warp's 32 neighbouring ints;
//  (b) each block keeps the last D rows of its slice of H/E1/E2 (as many as
//      the gap regime reads) in a shared-memory ring (S = 640 at W = 10112
//      and CS = 16: D = 16 fits); a predecessor further back is read from the
//      planes in device memory (its own slice, written by its own threads),
//      which every row still writes (X1w reads them);
//  (c) the gap chains F[j] = max_{k <= j} A[k] + k e - j e run as a warp scan
//      a run of 32 lanes, carried from run to run and from warp to warp
//      through shared memory, and across blocks in one exchange a row: each
//      block sends its chain totals to the later blocks of its cluster
//      through distributed shared memory, then one cluster barrier. Column
//      j - 1 of a predecessor at a slice's left edge is the only value a row
//      needs from another block: block c computes it for block c + 1 (the
//      max over the predecessors of H[p][j - 1] + score, its own last lane)
//      and sends it in the same exchange, with the chain term it gives
//      (H-hat at j, so A[j] (linear) or A[j + 1]), which block c + 1 applies
//      past its first lane and the blocks after it receive folded into block
//      c's total. So there is one cross-block step a row;
//  (d) a whole row's band does not depend on the row's values (an unbanded
//      row spans [its predecessors' least begin, qlen] and pushes nothing),
//      so the row max is off the chain: each block writes its slice's
//      (max, leftmost, rightmost column) a row to a scratch tensor, and after
//      the last row one warp replays the best-cell and Z-drop state machine
//      of local and extend mode (fused_dp.cu's, `_dp_scan` :219-261) over
//      the rows in order; global mode skips both;
//  (e) each block's last warp is a control warp: it stages the table rows
//      kStages - 1 rows ahead with cp.async, gathers the next row's
//      predecessors and band while the others compute this row, and writes
//      the slice's row maxima; `mplr` is the seeds (a whole row pushes
//      nothing, so the final pull of B2 gives them back), `ok` is 0 only
//      where W < qlen + 1.
// Three barriers a row: the block's chain totals, the cluster's exchange,
// and the block's ring rows (a lane reads its left neighbour's).
//
// It relies on what a whole-row DP is: row 0 begins at column 0 and a row's
// begin is its predecessors' least, so every row begins at 0 or is empty (no
// predecessor reaches it: begin 2^30 > end); the lanes of every non-empty
// row are its columns. And on path scores <= 0 (`incre_path_score` is a log
// of a weight ratio <= 1), so a predecessor adds nothing where it does not
// reach.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMin = -2147483647 - 1;
constexpr int kLinear = 0, kAffine = 1, kConvex = 2;
constexpr int kExtend = 1, kLocal = 2;  // mode 0 is global
// Shared-memory layout constants; align/fused_dp_kernel.py
// `unbanded_smem_bytes` computes the same layout.
constexpr int kScalarRing = 256;  // rows of beg/end kept
constexpr int kStages = 4;        // table rows in flight (cp.async)
constexpr int kMaxCluster = 16;
constexpr int kPartInts = 256;    // chain totals (2 x 32), row maxima (2 x 3 x 32)
constexpr int kMsgInts = 96;      // the exchange: see the layout in the kernel

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the max of v over the warp, and the lowest/highest col among the lanes
// that hold it
__device__ __forceinline__ void warp_argmax(int v, int lo, int hi, int* mx,
                                            int* left, int* right) {
  *mx = __reduce_max_sync(kFull, v);
  *left = __reduce_min_sync(kFull, v == *mx ? lo : 0x7fffffff);
  *right = __reduce_max_sync(kFull, v == *mx ? hi : -1);
}

template <int GAP>
__host__ __device__ constexpr int ring_planes() {
  return GAP == kLinear ? 1 : GAP == kAffine ? 2 : 3;
}

// bytes of dynamic shared memory for a launch (see the kernel's layout)
__host__ __device__ inline size_t smem_bytes(int P, int S, int D, int nplanes,
                                             bool ps) {
  const int tab_w = P + 2 + (ps ? P : 0);
  return (size_t)kScalarRing * 8 + (size_t)2 * P * 16 + kPartInts * 4 +
         kMsgInts * 4 + (size_t)kStages * tab_w * 4 +
         (size_t)nplanes * D * S * 4;
}

template <int K, int GAP>
__global__ void __launch_bounds__(kMaxThreads)
unbanded_dp_kernel(const int* __restrict__ sc, const int* __restrict__ roff,
                   const int* __restrict__ base,
                   const int* __restrict__ pre_idx,
                   const int* __restrict__ pre_cnt,
                   const int* __restrict__ remain,
                   const int* __restrict__ mpl0, const int* __restrict__ mpr0,
                   const int* __restrict__ row0, const int* __restrict__ qp,
                   const int* __restrict__ pre_score, int* H, int* E1, int* E2,
                   int* F1, int* F2, int* begend, int* mplr, int* ok_out,
                   int* ext_out, int4* rmax, int W, int P, int QW, int qstride,
                   int S, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int* scw = sc + 16 * b;
  const int mode = scw[12];
  const bool local = mode == kLocal, extend = mode == kExtend;
  if (scw[13] != 0 && !local) {  // a banded window is B2's: refused
    if (c == 0 && threadIdx.x == 0) ok_out[b] = -1;
    return;
  }

  const int r0 = roff[b];
  const int R = roff[b + 1] - r0;
  const int e0 = 2 * r0;
  const size_t pl0 = (size_t)r0 * W;
  const int q0 = qstride * b;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int ncol = (blockDim.x >> 5) - 1;  // column warps; the last is control
  const int ctl = ncol;
  const int qlen = scw[0], inf = scw[3];
  const int e1 = scw[5], oe1 = scw[6], e2 = scw[8], oe2 = scw[9];
  const int gn = scw[10], end0 = scw[11], zdrop = scw[14];
  const bool track = local || extend;
  const bool has_ps = pre_score != nullptr;
  const int tab_w = P + 2 + (has_ps ? P : 0);  // ints of a staged table row
  const int first = c * S;                     // this block's first lane
  const int jn = first + S;                    // the next block's first lane

  int2* s_band = (int2*)smem;                    // kScalarRing: beg, end
  int4* s_pred = (int4*)(s_band + kScalarRing);  // 2 x P records
  int* s_part = (int*)(s_pred + 2 * P);          // kPartInts
  // the exchange (kMsgInts): [par][source block][chain] totals (64), [par]
  // the left neighbour's column and chain terms (64 + 4 par), this block's
  // outgoing ones (72), [par] the row's band record (80 + 8 par)
  int* s_msg = s_part + kPartInts;
  int* s_tab = s_msg + kMsgInts;                 // kStages x tab_w
  int* s_ring = s_tab + kStages * tab_w;         // planes x D x S

  // table row q into its stage, by the control warp (one group per call,
  // maybe empty)
  auto issue = [&](int q) {
    if (q < R && q < gn - 1) {
      int* dst = s_tab + (q % kStages) * tab_w;
      for (int k = lane_id; k < P; k += 32)
        cp_async4(dst + k, pre_idx + (size_t)(r0 + q) * P + k);
      if (has_ps)
        for (int k = lane_id; k < P; k += 32)
          cp_async4(dst + P + 2 + k, pre_score + (size_t)(r0 + q) * P + k);
      if (lane_id == 0) {
        cp_async4(dst + P, base + r0 + q);
        cp_async4(dst + P + 1, pre_cnt + r0 + q);
      }
    }
    cp_async_commit();
  };

  // Row q's predecessor records (row, its beg, its end, ring slot | score
  // << 16) into s_pred's buffer q & 1, and its band record, by the control
  // warp. Every block computes the same band; block 0 writes begend.
  auto prepare = [&](int q) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    const int* tab = s_tab + (q % kStages) * tab_w;
    const int npre = tab[P + 1];
    int4* pred = s_pred + (q & 1) * P;
    int mn_beg = 1 << 30;  // no predecessor: an empty band
    for (int k = lane_id; k < npre; k += 32) {
      const int p = tab[k];
      int2 v;
      if (p < q && q - p < kScalarRing)
        v = s_band[p & (kScalarRing - 1)];
      else  // written by block 0 long ago (or 0): read past the L1
        v = make_int2(__ldcg(begend + e0 + p), __ldcg(begend + e0 + R + p));
      mn_beg = min(mn_beg, v.x);
      const bool in_ring = p < q && q - p < D;
      int slot = in_ring ? (p & (D - 1)) : -1;
      if (has_ps)
        slot = (int)((unsigned)tab[P + 2 + k] << 16) | (slot & 0xffff);
      pred[k] = make_int4(p, v.x, v.y, slot);
    }
    mn_beg = __reduce_min_sync(kFull, mn_beg);
    if (lane_id == 0) {
      if (c == 0) {
        begend[e0 + q] = mn_beg;
        begend[e0 + R + q] = qlen;
      }
      s_band[q & (kScalarRing - 1)] = make_int2(mn_beg, qlen);
      int* sr = s_msg + 80 + 8 * (q & 1);
      sr[0] = mn_beg;
      sr[1] = qlen;
      sr[2] = npre;
      sr[3] = tab[P];
      sr[4] = (qlen - mn_beg + 1 > W) ? 1 : 0;  // the band passes W
    }
    __syncwarp();
    issue(q + kStages - 1);
  };

  // this block's (max, leftmost, rightmost column) of row q from its column
  // warps', to the scratch tensor
  auto flush = [&](int q) {
    const int* rm = s_part + 64 + (q & 1) * 96;
    const bool mine = lane_id < ncol;
    int mx, left, right;
    warp_argmax(mine ? rm[lane_id] : kIntMin, mine ? rm[32 + lane_id] : 0x7fffffff,
                mine ? rm[64 + lane_id] : -1, &mx, &left, &right);
    if (lane_id == 0) rmax[(size_t)(r0 + q) * cs + c] = make_int4(mx, left, right, 0);
  };

  // ---- row 0, begend and mplr
  if (c == 0)
    for (int k = tid; k < R; k += blockDim.x) {
      begend[e0 + k] = 0;
      begend[e0 + R + k] = k == 0 ? end0 : 0;
      mplr[e0 + k] = mpl0[r0 + k];  // a whole row pushes nothing
      mplr[e0 + R + k] = mpr0[r0 + k];
    }
  const int* r0w = row0 + (size_t)5 * W * b;
  for (int i = tid; i < S; i += blockDim.x) {
    const int j = first + i;
    if (j < W) {
      const int v0 = r0w[j], v1 = r0w[W + j], v2 = r0w[2 * W + j];
      H[pl0 + j] = v0;
      E1[pl0 + j] = v1;
      E2[pl0 + j] = v2;
      F1[pl0 + j] = r0w[3 * W + j];
      F2[pl0 + j] = r0w[4 * W + j];
      if (D > 0) {
        s_ring[i] = v0;
        if (GAP != kLinear) s_ring[(size_t)D * S + i] = v1;
        if (GAP == kConvex) s_ring[(size_t)2 * D * S + i] = v2;
      }
    }
  }
  __syncthreads();  // begend zeroed before the control warp writes row 1's

  int ok = end0 + 1 <= W ? 1 : 0;  // uniform over the cluster
  if (warp == ctl) {
    if (lane_id == 0) s_band[0] = make_int2(0, end0);
    __syncwarp();
    for (int q = 1; q < kStages; ++q) issue(q);
    if (ok && 1 < gn - 1 && 1 < R) prepare(1);
  }
  cluster.sync();  // every block running before any remote store

  int last = 0;  // the last computed row
  for (int row = 1; row < R && row < gn - 1 && ok; ++row) {
    const int par = row & 1;
    const int* sr = s_msg + 80 + 8 * par;
    const int beg = sr[0], end = sr[1], npre = sr[2], qb = sr[3];
    ok = !sr[4];  // the overflow row itself is still computed
    last = row;
    int hhat[K], e1r[K], e2r[K], own1[K], own2[K], qv[K];

    if (warp == ctl) {
      // ---- the control warp: the last row's maxima, the next row's inputs
      if (track && row >= 2) flush(row - 1);
      if (ok && row + 1 < gn - 1 && row + 1 < R) prepare(row + 1);
    } else {
      // ---- predecessor maxima: H one column left, E1/E2 (linear: H)
      const int4* pred = s_pred + par * P;
      const int* qrow = qp + q0 + (size_t)qb * QW;
      int mq[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = first + warp * 32 * K + k * 32 + lane_id;
        mq[k] = e1r[k] = e2r[k] = inf;
        qv[k] = (j < W && beg + j <= end) ? __ldg(qrow + beg + j) : 0;
      }
      // the block's last lane also takes the next block's first column
      const bool ph = c + 1 < cs && warp == ncol - 1 && lane_id == 31;
      int mq_ph = inf;
      for (int u = 0; u < npre; ++u) {
        const int4 pr = pred[u];
        const int p = pr.x, pbeg = pr.y, pend = pr.z;
        const int slot = has_ps ? (int)(short)(pr.w & 0xffff) : pr.w;
        const int ps = has_ps ? (pr.w >> 16) : 0;
        const int* rh = s_ring + (size_t)max(slot, 0) * S;
        const int* re1 = rh + (size_t)D * S;
        const int* re2 = re1 + (size_t)D * S;
        const size_t grow = pl0 + (size_t)p * W;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = warp * 32 * K + k * 32 + lane_id;
          const int j = first + i, col = beg + j;
          if (j >= W) continue;
          if (col - 1 >= pbeg && col - 1 <= pend && col - 1 - pbeg < W) {
            // lane 0 of a block > 0: the left neighbour's column comes in
            // the exchange
            if (i > 0)
              mq[k] = max(mq[k], (slot >= 0 ? rh[i - 1] : H[grow + j - 1]) + ps);
          } else if (local && col == 0) {  // column -1's cell: 0
            mq[k] = max(mq[k], ps);
          }
          if (col >= pbeg && col <= pend && col - pbeg < W) {
            if (GAP == kLinear) {
              e1r[k] = max(e1r[k], (slot >= 0 ? rh[i] : H[grow + j]) + ps);
            } else {
              e1r[k] = max(e1r[k], (slot >= 0 ? re1[i] : E1[grow + j]) + ps);
              if (GAP == kConvex)
                e2r[k] = max(e2r[k], (slot >= 0 ? re2[i] : E2[grow + j]) + ps);
            }
          }
        }
        if (ph) {
          const int colx = beg + jn - 1;  // this thread's own last lane
          if (colx >= pbeg && colx <= pend && colx - pbeg < W)
            mq_ph = max(mq_ph, (slot >= 0 ? rh[S - 1] : H[grow + jn - 1]) + ps);
        }
      }

      // ---- query profile, H-hat
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = first + warp * 32 * K + k * 32 + lane_id;
        const bool ib = j < W && beg + j <= end;
        mq[k] = ib ? mq[k] + qv[k] : inf;
        if (GAP == kLinear) {
          e1r[k] = ib ? e1r[k] - e1 : inf;  // E row from the preds' H
          hhat[k] = max(mq[k], e1r[k]);
        } else {
          if (!ib) e1r[k] = e2r[k] = inf;
          hhat[k] = GAP == kConvex ? max(max(mq[k], e1r[k]), e2r[k])
                                   : max(mq[k], e1r[k]);
        }
      }

      // ---- gap chains: warp scans of A[k] + k e a run, carried along the
      // warp's runs (fused_dp.cu's terms: linear A = H-hat, inclusive;
      // otherwise lane k contributes A[k + 1] = H-hat[k] - oe, exclusive,
      // and A[0] = column 0's Mq - oe starts block 0's first warp)
      int carry1 = kIntMin, carry2 = kIntMin;
      if (GAP != kLinear && c == 0 && warp == 0) {
        const int m0 = __shfl_sync(kFull, mq[0], 0);
        const bool ib0 = beg <= end;
        carry1 = ib0 ? m0 - oe1 : inf;
        if (GAP == kConvex) carry2 = ib0 ? m0 - oe2 : inf;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = first + warp * 32 * K + k * 32 + lane_id;
        int t1, t2 = kIntMin;
        if (GAP == kLinear) {
          t1 = j < W ? hhat[k] + j * e1 : kIntMin;
        } else {
          const int jj = j + 1;
          const bool ib = beg + jj <= end;
          t1 = jj < W ? (ib ? hhat[k] - oe1 : inf) + jj * e1 : kIntMin;
          if (GAP == kConvex)
            t2 = jj < W ? (ib ? hhat[k] - oe2 : inf) + jj * e2 : kIntMin;
        }
        int inc1 = t1, inc2 = t2;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v1 = __shfl_up_sync(kFull, inc1, off);
          if (lane_id >= off) inc1 = max(inc1, v1);
          if (GAP == kConvex) {
            const int v2 = __shfl_up_sync(kFull, inc2, off);
            if (lane_id >= off) inc2 = max(inc2, v2);
          }
        }
        if (GAP == kLinear) {
          own1[k] = max(carry1, inc1);
        } else {
          int x1 = __shfl_up_sync(kFull, inc1, 1);
          own1[k] = max(carry1, lane_id == 0 ? kIntMin : x1);
          if (GAP == kConvex) {
            int x2 = __shfl_up_sync(kFull, inc2, 1);
            own2[k] = max(carry2, lane_id == 0 ? kIntMin : x2);
          }
        }
        carry1 = max(carry1, __shfl_sync(kFull, inc1, 31));
        if (GAP == kConvex) carry2 = max(carry2, __shfl_sync(kFull, inc2, 31));
      }
      if (lane_id == 0) {
        s_part[warp] = carry1;
        s_part[32 + warp] = carry2;
      }
      if (ph) {  // the next block's first column and the chain terms it gives
        const bool ibn = jn < W && beg + jn <= end;
        const int qn = ibn ? __ldg(qrow + beg + jn) : 0;
        int x1 = kIntMin, x2 = kIntMin;
        if (GAP == kLinear) {
          if (ibn) x1 = mq_ph + qn + jn * e1;
        } else if (jn + 1 < W && beg + jn + 1 <= end) {
          x1 = mq_ph + qn - oe1 + (jn + 1) * e1;
          if (GAP == kConvex) x2 = mq_ph + qn - oe2 + (jn + 1) * e2;
        }
        s_msg[72] = mq_ph;
        s_msg[73] = x1;
        s_msg[74] = x2;
      }
    }
    __syncthreads();  // barrier 1: the block's chain totals

    // ---- the earlier warps' totals; warp 0 sends the block's to the later
    // blocks (linear: the next block's term folded in, as it covers the
    // next block's every lane; otherwise sent apart, as it starts past the
    // next block's first lane)
    int exw1 = kIntMin, exw2 = kIntMin;
    if (warp < ncol) {
      const bool before = lane_id < warp;
      exw1 = __reduce_max_sync(kFull, before ? s_part[lane_id] : kIntMin);
      if (GAP == kConvex)
        exw2 = __reduce_max_sync(kFull, before ? s_part[32 + lane_id] : kIntMin);
      if (warp == 0 && c + 1 < cs) {
        const bool mine = lane_id < ncol;
        const int T1 = __reduce_max_sync(kFull, mine ? s_part[lane_id] : kIntMin);
        const int T2 = GAP == kConvex
            ? __reduce_max_sync(kFull, mine ? s_part[32 + lane_id] : kIntMin)
            : kIntMin;
        const int d = lane_id;
        if (d > c && d < cs) {
          int* rr = cluster.map_shared_rank(s_msg, d);
          const int x1 = s_msg[73], x2 = s_msg[74];
          const bool apart = d == c + 1 && GAP != kLinear;
          rr[32 * par + 2 * c] = apart ? T1 : max(T1, x1);
          rr[32 * par + 2 * c + 1] = apart ? T2 : max(T2, x2);
          if (d == c + 1) {
            rr[64 + 4 * par] = s_msg[72];
            rr[64 + 4 * par + 1] = x1;
            rr[64 + 4 * par + 2] = x2;
          }
        }
      }
    }
    cluster.sync();  // barrier 2: the exchange

    // ---- H, E, F per regime, store, the slice's row max
    if (warp < ncol) {
      int cin1 = kIntMin, cin2 = kIntMin;
      for (int s = 0; s < c; ++s) {
        cin1 = max(cin1, s_msg[32 * par + 2 * s]);
        if (GAP == kConvex) cin2 = max(cin2, s_msg[32 * par + 2 * s + 1]);
      }
      int xa1 = kIntMin, xa2 = kIntMin;
      if (GAP != kLinear && c > 0) {
        xa1 = s_msg[64 + 4 * par + 1];
        xa2 = s_msg[64 + 4 * par + 2];
        // the first lane's H-hat with the left neighbour's column
        if (warp == 0 && lane_id == 0 && first < W && beg + first <= end)
          hhat[0] = max(hhat[0], s_msg[64 + 4 * par] + qv[0]);
      }
      int t_max = kIntMin, t_left = 0x7fffffff, t_right = -1;
      const int slot = D > 0 ? (row & (D - 1)) : 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = warp * 32 * K + k * 32 + lane_id;
        const int j = first + i;
        if (j >= W) continue;
        const bool ib = beg + j <= end;
        int p1 = max(max(exw1, own1[k]), cin1);
        if (GAP != kLinear && j > first) p1 = max(p1, xa1);
        const int f1 = max(p1 - j * e1, inf);
        int h, en1 = inf, en2 = inf, g1 = inf, g2 = inf;
        if (GAP == kLinear) {
          h = f1;
          if (local) h = max(h, 0);
        } else if (GAP == kAffine) {
          g1 = f1;
          h = max(hhat[k], f1);
          if (local) h = max(h, 0);
          en1 = h == hhat[k] ? max(e1r[k] - e1, h - oe1) : (local ? 0 : inf);
        } else {
          int p2 = max(max(exw2, own2[k]), cin2);
          if (j > first) p2 = max(p2, xa2);
          g1 = f1;
          g2 = max(p2 - j * e2, inf);
          h = max(hhat[k], max(g1, g2));
          if (local) h = max(h, 0);
          en1 = max(e1r[k] - e1, h - oe1);
          en2 = max(e2r[k] - e2, h - oe2);
          if (local) {
            en1 = max(en1, 0);
            en2 = max(en2, 0);
          }
        }
        if (!ib) h = en1 = en2 = g1 = g2 = inf;
        const size_t at = pl0 + (size_t)row * W + j;
        H[at] = h;
        E1[at] = en1;
        E2[at] = en2;
        F1[at] = g1;
        F2[at] = g2;
        if (D > 0) {
          int* rs = s_ring + (size_t)slot * S + i;
          rs[0] = h;
          if (GAP != kLinear) rs[(size_t)D * S] = en1;
          if (GAP == kConvex) rs[(size_t)2 * D * S] = en2;
        }
        if (track && ib) {
          const int col = beg + j;
          if (h > t_max) {
            t_max = h;
            t_left = col;
          }
          if (h >= t_max) t_right = col;
        }
      }
      if (track) {
        int mx, left, right;
        warp_argmax(t_max, t_left, t_right, &mx, &left, &right);
        if (lane_id == 0) {
          int* rm = s_part + 64 + par * 96;
          rm[warp] = mx;
          rm[32 + warp] = left;
          rm[64 + warp] = right;
        }
      }
    }
    __syncthreads();  // barrier 3: the ring row, the row maxima, the next band
  }

  if (warp == ctl) {
    if (track && last >= 1) flush(last);
    cp_async_wait<0>();
  }
  cluster.sync();  // every block's row maxima written; no remote access after
  if (c != 0) return;

  // ---- block 0: the best cell of local and extend mode, replayed over the
  // rows in order from the blocks' row maxima (fused_dp.cu's state machine)
  if (track) {
    for (int q = 1 + tid; q <= last; q += blockDim.x) {
      int4 best = __ldcg(rmax + (size_t)(r0 + q) * cs);
      for (int s = 1; s < cs; ++s) {
        const int4 v = __ldcg(rmax + (size_t)(r0 + q) * cs + s);
        if (v.x > best.x) {
          best = v;
        } else if (v.x == best.x) {
          best.y = min(best.y, v.y);
          best.z = max(best.z, v.z);
        }
      }
      rmax[(size_t)(r0 + q) * cs] = best;
    }
    __syncthreads();
  }
  if (warp != 0) return;
  int bs = inf, bi = 0, bj = 0, brem = 0, zdropped = 0;
  if (track) {
    const bool zdrop_on = zdrop > 0;
    for (int q1 = 1; q1 <= last; q1 += 32) {
      const int q = q1 + lane_id;
      int4 v = make_int4(kIntMin, 0x7fffffff, -1, 0);
      int rem = 0;
      if (q <= last) {
        v = rmax[(size_t)(r0 + q) * cs];
        if (extend) rem = remain[r0 + q];
      }
      const int n = min(32, last - q1 + 1);
      for (int u = 0; u < n; ++u) {
        const int row = q1 + u;
        const int mx = __shfl_sync(kFull, v.x, u);
        int left = __shfl_sync(kFull, v.y, u);
        int right = __shfl_sync(kFull, v.z, u);
        const int cur_rem = __shfl_sync(kFull, rem, u);
        // no cell in the band: mx = INT32_MIN, which no best score passes
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
              const int delta = brem - cur_rem;
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
            brem = cur_rem;
          }
        }
      }
    }
  }
  if (lane_id == 0) {
    ok_out[b] = ok;
    ext_out[4 * b] = track ? bs : inf;
    ext_out[4 * b + 1] = track ? bi : 0;
    ext_out[4 * b + 2] = track ? bj : 0;
    ext_out[4 * b + 3] = track ? zdropped : 0;
  }
}

struct Args {
  const int *sc, *roff, *base, *pre_idx, *pre_cnt, *remain, *mpl0, *mpr0,
      *row0, *qp, *pre_score;
  int *H, *E1, *E2, *F1, *F2, *begend, *mplr, *ok, *ext;
  int4* rmax;
  int B, W, P, QW, qstride, cs, threads, S, D;
  size_t smem;
};

// the launch configuration of a cluster of a.cs blocks a window
template <int K, int GAP>
cudaError_t configure(const Args& a, cudaStream_t s, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  auto kern = unbanded_dp_kernel<K, GAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  if (a.cs > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.B * a.cs, 1, 1);
  cfg->blockDim = dim3(a.threads, 1, 1);
  cfg->dynamicSmemBytes = a.smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int K, int GAP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K, GAP>(a, s, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, unbanded_dp_kernel<K, GAP>, a.sc, a.roff,
                           a.base, a.pre_idx, a.pre_cnt, a.remain, a.mpl0,
                           a.mpr0, a.row0, a.qp, a.pre_score, a.H, a.E1, a.E2,
                           a.F1, a.F2, a.begend, a.mplr, a.ok, a.ext, a.rmax,
                           a.W, a.P, a.QW, a.qstride, a.S, a.D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int K, int GAP>
cudaError_t max_clusters(const Args& a, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<K, GAP>(a, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, unbanded_dp_kernel<K, GAP>, &cfg);
}

// call F<K, GAP>(args...) for the runtime K and gap mode
template <template <int, int> class F, typename... T>
cudaError_t dispatch(int K, int gap, T... args) {
#define UNBANDED_GAP(KK)                                              \
  switch (gap) {                                                      \
    case kLinear: return F<KK, kLinear>::run(args...);                \
    case kAffine: return F<KK, kAffine>::run(args...);                \
    case kConvex: return F<KK, kConvex>::run(args...);                \
    default: return cudaErrorInvalidValue;                            \
  }
  switch (K) {
    case 1: UNBANDED_GAP(1)
    case 2: UNBANDED_GAP(2)
    case 4: UNBANDED_GAP(4)
    case 8: UNBANDED_GAP(8)
    default: return cudaErrorInvalidValue;
  }
#undef UNBANDED_GAP
}

template <int K, int GAP>
struct Launch {
  static cudaError_t run(const Args* a, cudaStream_t s) {
    return launch<K, GAP>(*a, s);
  }
};
template <int K, int GAP>
struct Clusters {
  static cudaError_t run(const Args* a, int* n) {
    return max_clusters<K, GAP>(*a, n);
  }
};

// the shape checks both entries make; fills a's shape fields
bool shape(Args* a, int W, int P, int gap_mode, int cs, int warps, int K,
           int D, int smem, bool ps) {
  const int nplanes = gap_mode == kLinear ? 1 : gap_mode == kAffine ? 2 : 3;
  a->W = W;
  a->P = P;
  a->cs = cs;
  a->threads = (warps + 1) * 32;
  a->S = warps * 32 * K;
  a->D = D;
  a->smem = (size_t)smem;
  return W >= 1 && W <= 32768 && P >= 1 && gap_mode >= 0 && gap_mode <= 2 &&
         (cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == kMaxCluster) &&
         warps >= 1 && a->threads <= kMaxThreads &&
         (K == 1 || K == 2 || K == 4 || K == 8) && (size_t)cs * a->S >= (size_t)W &&
         D >= 0 && (D & (D - 1)) == 0 &&
         (size_t)smem == smem_bytes(P, a->S, D, nplanes, ps);
}

}  // namespace

// Kernel B2u on `stream` (see the header); returns a cudaError_t as an int
// (0 = launched). The arguments are abpoa_banded_dp's, less `lr`, plus
// `rmax` (scratch of Rtot x cs int4: each block's row maxima) and the
// cluster shape of align/fused_dp_kernel.py `unbanded_launch_shape`: cs
// blocks a window, `warps` column warps a block (plus the control warp), K
// lanes a thread in each of a warp's runs (a block's slice is warps x 32 x
// K lanes), ring depth D (0 or a power of two) and `smem` the layout's
// bytes. gap_mode 0/1/2 = linear/affine/convex. A window that is not a
// whole-row one (scalars[13] != 0 outside local mode) is not computed: its
// ok is set to -1.
extern "C" int abpoa_unbanded_dp(
    const void* sc, const void* roff, const void* base, const void* pre_idx,
    const void* pre_cnt, const void* remain, const void* mpl0,
    const void* mpr0, const void* row0, const void* qp,
    const void* pre_score, void* H, void* E1, void* E2, void* F1, void* F2,
    void* begend, void* mplr, void* ok, void* ext, void* rmax, int B, int W,
    int P, int QW, int qstride, int gap_mode, int cs, int warps, int K, int D,
    int smem, void* stream) {
  Args a{(const int*)sc,     (const int*)roff,   (const int*)base,
         (const int*)pre_idx, (const int*)pre_cnt, (const int*)remain,
         (const int*)mpl0,   (const int*)mpr0,   (const int*)row0,
         (const int*)qp,     (const int*)pre_score,
         (int*)H, (int*)E1, (int*)E2, (int*)F1, (int*)F2, (int*)begend,
         (int*)mplr, (int*)ok, (int*)ext, (int4*)rmax};
  a.B = B;
  a.QW = QW;
  a.qstride = qstride;
  if (B < 1 || !shape(&a, W, P, gap_mode, cs, warps, K, D, smem,
                      pre_score != nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(K, gap_mode, (const Args*)&a,
                               (cudaStream_t)stream);
}

// How many clusters of that shape the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *n; 0 means the shape cannot be
// launched (the wrapper then takes 8 blocks a cluster in place of 16).
extern "C" int abpoa_unbanded_max_clusters(int W, int P, int gap_mode,
                                           int path_score, int cs, int warps,
                                           int K, int D, int smem, int* n) {
  Args a{};
  a.B = 1;
  if (!shape(&a, W, P, gap_mode, cs, warps, K, D, smem, path_score != 0))
    return (int)cudaErrorInvalidValue;
  *n = 0;
  return (int)dispatch<Clusters>(K, gap_mode, (const Args*)&a, n);
}
