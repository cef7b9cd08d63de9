// The banded forward DP of one read against one graph, written for Hopper
// (sm_90a): the fused loop's kernels B1 and B3, and the per-read route's
// kernel B2 as the kernel's seeded instantiation.
//
// Replaces: the Pallas TPU kernels abpoa_tpu/align/pallas_fused.py
// `pallas_fused_dp` (body `_make_kernel`, row math `_row_dp_math`) and
// `pallas_fused_dp_local_hbm` (`_make_local_hbm_kernel`), and
// abpoa_tpu/align/pallas_kernel.py `pallas_banded_dp` (B2). It computes the
// same thing row for row: linear, affine or convex gaps (template GAP);
// global, extend (with Z-drop) or local mode (runtime `mode`, uniform over
// the block); int16 or int32 planes (runtime `plane16`), with every value
// computed in int32 and stored in the plane type. The plain PyTorch versions
// are `fused_dp_torch` in align/fused_dp_kernel.py and `banded_dp_torch` in
// align/banded_kernel.py; each must agree with its instantiation bit for
// bit on every output, over the rows it computes.
//
// B2 (template SEEDED, entry `abpoa_banded_dp`) is int32, with linear,
// affine or convex gaps, in every mode of the XLA per-read DP
// (abpoa_tpu/align/jax_backend.py `_dp_scan`): global, extend (with Z-drop)
// or local (the window's scalars[12]), banded or not (scalars[13]; local is
// unbanded: a row spans its predecessors' least begin to qlen, so a row no
// predecessor reaches has an empty band), and with `-G`'s path scores
// (when `pre_score` is given: one score a predecessor slot, staged with the
// table row and added to that predecessor's H, E1 and E2). It also replaces
// the XLA vmap over a seeded read's windows (`_dp_full_batch`): a grid of B
// blocks, block b aligning window b of a ragged batch, whose rows are
// roff[b]..roff[b+1]-1 of the concatenated tables, planes, begend, mplr and
// scratch (each at its own stride), and whose scalars, row 0, query profile,
// ok and ext are row b of theirs. The windows are independent, so the
// blocks share nothing. B2 reads B2's tables: the scalars in
// pallas_kernel.py's layout, `base` with no source bit, and per-row seeds
// mpl0/mpr0, which start each row's band state in place of B1's neutral
// pair (the first row's successors get their 1 from the seeds, and with `-s`
// the seeds are the last launch's mpl/mpr). It also writes `mplr`, every
// row's final mpl/mpr: the computed rows from the loop, the rows it did not
// reach (the end node, or every row after a band overflow) from one pull
// after it. It takes up to 32 columns a thread (W <= 32768).
//
// What bounds it: the rows form a serial chain (each row reads its
// predecessors' rows, and its band comes from their argmax), so a read's
// rows run one after another. The bytes and integer operations of a row are
// far below what the card streams or computes in its time: it is bound by
// the latency of each row's dependent steps (loads, barriers, reductions).
//
// What the design does about it: one block owns the alignment and loops
// over rows. Its column warps take CPT contiguous columns a thread (the warp
// count per band width is chosen in the wrapper from measurement); the
// block's last warp is the control warp, which keeps the band and best-cell
// state (at 32 warps it takes columns too). Per row:
//  (a) only rows 0..last computed are written; rows past it stay as
//      allocated (the wrappers document them as undefined), beg/end are
//      zeroed for every row;
//  (b) a ring of the last D rows of H/E1/E2 (as many planes as the gap
//      regime reads) sits in dynamic shared memory beside a ring of the last
//      kScalarRing rows' beg/end/left/right; a predecessor further back is
//      read from the global planes, which every row still writes (X1 reads
//      them), so there is no overflow condition: `ok` = 0 means only a band
//      wider than W;
//  (c) the band is pulled, not pushed: each row stores left+1/right+1 of its
//      row max (or a neutral pair when Z-drop gates it), and the next row
//      takes min/max over its predecessors, lanes over the predecessor
//      slots; exact because the pre/out tables (the fused loop's, and
//      align/tables.py's for B2) are transposes over rows 1..gn-2, and row 0
//      leaves the neutral pair. The same pass gives min_pre_beg and each
//      predecessor's ring slot;
//  (d) the table rows (pre_idx, base, remain, pre_cnt; B2 also mpl0/mpr0)
//      are copied into shared memory kStages - 1 rows ahead with cp.async,
//      and the control warp gathers row r + 1's predecessors while the
//      column warps compute row r, so between two rows only row r's max,
//      its best-cell update and row r + 1's band remain in the chain;
//  (e) three block barriers a row: after the gap chains' warp totals (both
//      convex chains at once; each thread's chain input is shifted one
//      column so it needs no neighbour's H-hat; int32 scan), after the row
//      max (value and leftmost/rightmost argmax from hardware warp
//      reductions, __reduce_max/min_sync), and after the next row's band.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMin = -2147483647 - 1;  // identity of the max scan
constexpr int kLinear = 0, kAffine = 1, kConvex = 2;
constexpr int kExtend = 1, kLocal = 2;  // mode 0 is global
// Shared-memory layout constants; align/fused_dp_kernel.py `launch_shape`
// computes the same layout.
constexpr int kScalarRing = 256;  // rows of beg/end/left/right kept
constexpr int kStages = 4;        // table rows in flight (cp.async)

// ints of a staged table row past its P predecessors: base, remain,
// pre_cnt and a spare (B1), or base, remain, pre_cnt, mpl0, mpr0 (B2); B2
// with path scores stages P more, the predecessors' scores
template <bool SEEDED>
__host__ __device__ constexpr int tab_extra() {
  return SEEDED ? 5 : 4;
}

// A predecessor record's last word: its ring slot (-1: not in the ring),
// with path scores (ps) the slot's score in the high half
__device__ __forceinline__ int rec_slot(int w, bool ps) {
  return ps ? (int)(short)(w & 0xffff) : w;
}
__device__ __forceinline__ int rec_score(int w, bool ps) {
  return ps ? (w >> 16) : 0;
}

// The pair a row that pushes nothing leaves for its successors to pull (row
// 0; B1's Z-drop): B1's band state starts from (gn, 0), B2's from its
// seeds, so B2's pair must lose to any value.
template <bool SEEDED>
__device__ __forceinline__ int quiet_l(int gn) {
  return SEEDED ? 0x7fffffff : gn;
}
template <bool SEEDED>
__device__ __forceinline__ int quiet_r() {
  return SEEDED ? kIntMin : 0;
}

__device__ __forceinline__ int ld(const void* p, size_t i, bool p16) {
  return p16 ? (int)((const short*)p)[i] : ((const int*)p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, int v, bool p16) {
  if (p16)
    ((short*)p)[i] = (short)v;
  else
    ((int*)p)[i] = v;
}

// the value a plane gives back after a store (int16 planes truncate)
__device__ __forceinline__ int as_plane(int v, bool p16) {
  return p16 ? (int)(short)v : v;
}

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

// inclusive max scan over a warp; returns the exclusive value
__device__ __forceinline__ int warp_scan_excl(int run, int lane_id,
                                             int* total) {
  int inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, off);
    if (lane_id >= off) inc = max(inc, v);
  }
  int ex = __shfl_up_sync(kFull, inc, 1);
  if (lane_id == 0) ex = kIntMin;
  *total = inc;
  return ex;
}

// the max of v over the warp, and the lowest/highest col among the lanes
// that hold it (hardware warp reductions)
__device__ __forceinline__ void warp_argmax(int v, int lo, int hi, int* mx,
                                            int* left, int* right) {
  *mx = __reduce_max_sync(kFull, v);
  *left = __reduce_min_sync(kFull, v == *mx ? lo : 0x7fffffff);
  *right = __reduce_max_sync(kFull, v == *mx ? hi : -1);
}

// bytes of dynamic shared memory for a launch (see launch_shape)
__host__ __device__ inline size_t smem_bytes(int W, int P, int nwarps, int D,
                                             int nplanes, int extra) {
  return (size_t)kScalarRing * 16 + (size_t)kStages * (P + extra) * 4 +
         (size_t)2 * P * 16 + (size_t)nwarps * 32 +
         (size_t)nplanes * D * W * 4;
}

template <int GAP>
__host__ __device__ constexpr int ring_planes() {
  return GAP == kLinear ? 1 : GAP == kAffine ? 2 : 3;
}

template <int CPT, int GAP, bool SEEDED>
__global__ void __launch_bounds__(kMaxThreads)
fused_dp_kernel(const int* __restrict__ sc, const int* __restrict__ base,
                const int* __restrict__ pre_idx,
                const int* __restrict__ pre_cnt,
                const int* __restrict__ remain, const int* __restrict__ row0,
                const int* __restrict__ qp, void* H, void* E1, void* E2,
                void* F1, void* F2, int* begend, int* ok_out, int* ext_out,
                int* lr, int R, int W, int P, int QW, int D, int mode,
                int zdrop_on, int plane16, const int* __restrict__ mpl0,
                const int* __restrict__ mpr0, int* mplr,
                const int* __restrict__ roff, int qstride,
                const int* __restrict__ pre_score) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_beg, s_end, s_ovf, s_npre, s_qb, s_allring;

  // This block's window of a ragged batch (B2): its first row r0 in the
  // per-row inputs and outputs (its pairs start at e0 = 2 r0 in begend, mplr
  // and lr; its plane rows at pl0) and its entry b of the per-window ones.
  // B1's one problem is window 0. Offsets, not moved pointers, so that the
  // pointer parameters stay out of registers.
  int b = 0, r0 = 0;
  if constexpr (SEEDED) {
    b = blockIdx.x;
    r0 = roff[b];
    R = roff[b + 1] - r0;
  }
  const int e0 = 2 * r0;
  const size_t pl0 = (size_t)r0 * W;
  const int q0 = qstride * b;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int ctl = nwarps - 1;  // the control warp (columns too if any)
  const int ncol_warps = min(nwarps, (W + 32 * CPT - 1) / (32 * CPT));
  const bool has_cols = warp < ncol_warps;
  const bool p16 = !SEEDED && plane16 != 0;
  // B2 takes its window's mode from the scalars
  const bool local = (SEEDED ? sc[16 * b + 12] : mode) == kLocal;
  const bool extend = (SEEDED ? sc[16 * b + 12] : mode) == kExtend;
  constexpr int kTab = tab_extra<SEEDED>();
  // B2 with -G stages P more ints a table row; B1 names none of the
  // variables B2 adds inside its lambdas, so its code stays as it was
  const bool has_ps = SEEDED && pre_score != nullptr;
  const int tab_w = P + kTab + (has_ps ? P : 0);  // ints of a staged table row

  int4* s_sring = (int4*)smem;                         // kScalarRing
  int* s_tab = (int*)(s_sring + kScalarRing);          // kStages x tab_w
  int4* s_pred = (int4*)(s_tab + kStages * (SEEDED ? tab_w : P + kTab));  // 2 x P
  int* s_part = (int*)(s_pred + 2 * P);                // 8 x nwarps
  int* s_ring = s_part + 8 * nwarps;                   // planes x D x W

  // the scalars in B1's layout, or in B2's (pallas_kernel.py) when seeded
  const int* scw = sc + 16 * b;
  const int qlen = scw[0], w = scw[1], remain_end = scw[2], inf = scw[3];
  const int e1 = scw[SEEDED ? 5 : 4], oe1 = scw[SEEDED ? 6 : 5];
  const int e2 = scw[SEEDED ? 8 : 6], oe2 = scw[SEEDED ? 9 : 7];
  const int gn = scw[SEEDED ? 10 : 8], end0 = scw[SEEDED ? 11 : 9];
  const int zdrop = SEEDED ? scw[14] : scw[10];
  if constexpr (SEEDED) zdrop_on = zdrop > 0;
  const bool unbanded = SEEDED && scw[13] == 0;

  // table row q into its stage, by the control warp (one group per call,
  // maybe empty)
  auto issue = [&](int q) {
    if (q < R && q < gn - 1) {
      int* dst;
      if constexpr (SEEDED)
        dst = s_tab + (q % kStages) * tab_w;
      else
        dst = s_tab + (q % kStages) * (P + kTab);
      for (int k = lane_id; k < P; k += 32)
        cp_async4(dst + k, pre_idx + (size_t)(r0 + q) * P + k);
      if constexpr (SEEDED)
        if (has_ps)
          for (int k = lane_id; k < P; k += 32)
            cp_async4(dst + P + kTab + k, pre_score + (size_t)(r0 + q) * P + k);
      if (lane_id == 0) {
        cp_async4(dst + P, base + r0 + q);
        cp_async4(dst + P + 1, remain + r0 + q);
        cp_async4(dst + P + 2, pre_cnt + r0 + q);
        if constexpr (SEEDED) {
          cp_async4(dst + P + 3, mpl0 + r0 + q);
          cp_async4(dst + P + 4, mpr0 + r0 + q);
        }
      }
    }
    cp_async_commit();
  };

  for (int k = tid; k < R; k += nthreads) {
    begend[e0 + k] = 0;
    begend[e0 + R + k] = k == 0 ? end0 : 0;
    if constexpr (SEEDED) {  // row 0 and the rows past gn keep their seed;
      mplr[e0 + k] = mpl0[r0 + k];  // lr's -1: a row the loop does not reach
      mplr[e0 + R + k] = mpr0[r0 + k];
      lr[e0 + R + k] = -1;
    }
  }
  const int* r0w = row0 + (size_t)5 * W * b;
  for (int k = tid; k < W; k += nthreads) {
    const int v[5] = {r0w[k], r0w[W + k], r0w[2 * W + k], r0w[3 * W + k],
                      r0w[4 * W + k]};
    st(H, pl0 + k, v[0], p16);
    st(E1, pl0 + k, v[1], p16);
    st(E2, pl0 + k, v[2], p16);
    st(F1, pl0 + k, v[3], p16);
    st(F2, pl0 + k, v[4], p16);
    if (D > 0)
      for (int q = 0; q < ring_planes<GAP>(); ++q)
        s_ring[(size_t)q * D * W + k] = as_plane(v[q], p16);
  }
  __syncthreads();  // begend zeroed before the control warp writes row 1's

  int ok = (end0 + 1 > W) ? 0 : 1;  // block-uniform
  // The control warp's state, the same in every lane: the best cell (score,
  // row, column, remain, zdropped), the band of the row in flight (cur_*),
  // and what `prepare` gathered for the next row (nx_*).
  int bs = inf, bi = 0, bj = 0, brem = 0, zdropped = 0;
  int cur_beg = 0, cur_end = end0, cur_rem = 0;
  int nx_npre = 0, nx_bp = 0, nx_rem = 0, nx_mnbeg = 0, nx_mnl = 0,
      nx_mxr = 0;
  bool nx_has_cur = false, nx_allring = false;

  // Gather the band inputs of row q from its predecessors, all closed
  // except possibly row q - 1 (whose pulled pair `finish` adds), into
  // s_pred's buffer q & 1.
  auto prepare = [&](int q) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    const int* tab;
    if constexpr (SEEDED)
      tab = s_tab + (q % kStages) * tab_w;
    else
      tab = s_tab + (q % kStages) * (P + kTab);
    const int npre = tab[P + 2];
    nx_npre = npre;
    nx_bp = tab[P];
    nx_rem = tab[P + 1];
    int4* pred = s_pred + (q & 1) * P;
    int mn_l = gn, mx_r = 0, mn_beg = 1 << 30;
    if constexpr (SEEDED) {
      mn_l = tab[P + 3];
      mx_r = tab[P + 4];
    }
    bool has_cur = false, far = false;
    for (int k = lane_id; k < npre; k += 32) {
      const int p = tab[k];
      int4 v;
      if (p == q - 1) {  // its pulled pair comes at `finish`
        v = make_int4(cur_beg, cur_end, quiet_l<SEEDED>(gn), quiet_r<SEEDED>());
        has_cur = true;
      } else if (p < q && q - p < kScalarRing) {
        v = s_sring[p & (kScalarRing - 1)];
      } else {
        const bool back = p < q;
        v = make_int4(begend[e0 + p], begend[e0 + R + p],
                      back ? lr[e0 + p] : quiet_l<SEEDED>(gn),
                      back ? lr[e0 + R + p] : quiet_r<SEEDED>());
      }
      mn_beg = min(mn_beg, v.x);
      mn_l = min(mn_l, v.z);
      mx_r = max(mx_r, v.w);
      const bool in_ring = p < q && q - p < D;
      far = far || !in_ring;
      int slot = in_ring ? (p & (D - 1)) : -1;
      if constexpr (SEEDED)
        if (has_ps)
          slot = (int)((unsigned)tab[P + kTab + k] << 16) | (slot & 0xffff);
      pred[k] = make_int4(p, v.x, v.y, slot);
    }
    nx_mnbeg = __reduce_min_sync(kFull, mn_beg);
    nx_mnl = __reduce_min_sync(kFull, mn_l);
    nx_mxr = __reduce_max_sync(kFull, mx_r);
    nx_has_cur = __any_sync(kFull, has_cur);
    nx_allring = !__any_sync(kFull, far);
    issue(q + kStages - 1);
  };

  // Row q's band, from `prepare` and the pair row q - 1 left (pl, pr),
  // published for the block.
  auto finish = [&](int q, int pl, int pr) {
    int mn_l = nx_mnl, mx_r = nx_mxr;
    if (nx_has_cur) {
      mn_l = min(mn_l, pl);
      mx_r = max(mx_r, pr);
    }
    bool whole = local;  // the row spans the query
    if constexpr (SEEDED) whole = whole || unbanded;
    if (whole) {  // B2: from its predecessors' least begin (none: empty)
      if constexpr (SEEDED)
        cur_beg = nx_mnbeg;
      else
        cur_beg = 0;
      cur_end = qlen;
    } else {
      if (nx_bp & 0x100) {  // a successor of the source row
        mn_l = min(mn_l, 1);
        mx_r = max(mx_r, 1);
      }
      const int r = qlen - (nx_rem - remain_end - 1);
      cur_beg = max(max(0, min(mn_l, r) - w), nx_mnbeg);
      cur_end = min(qlen, max(mx_r, r) + w);
    }
    cur_rem = nx_rem;
    if (lane_id == 0) {
      begend[e0 + q] = cur_beg;
      begend[e0 + R + q] = cur_end;
      if constexpr (SEEDED) {  // the row's final mpl/mpr: all pushes came
        mplr[e0 + q] = mn_l;
        mplr[e0 + R + q] = mx_r;
      }
      s_beg = cur_beg;
      s_end = cur_end;
      s_ovf = (cur_end - cur_beg + 1 > W) ? 1 : 0;
      s_npre = nx_npre;
      s_qb = nx_bp & 0xFF;
      s_allring = nx_allring ? 1 : 0;
    }
  };

  if (warp == ctl) {
    if (lane_id == 0) {
      lr[e0] = quiet_l<SEEDED>(gn);
      lr[e0 + R] = quiet_r<SEEDED>();
      s_sring[0] = make_int4(0, end0, quiet_l<SEEDED>(gn), quiet_r<SEEDED>());
    }
    for (int q = 1; q < kStages; ++q) issue(q);
    if (ok && 1 < gn - 1 && 1 < R) {
      prepare(1);
      finish(1, quiet_l<SEEDED>(gn), quiet_r<SEEDED>());
    }
  }
  __syncthreads();

  for (int row = 1; row < R; ++row) {
    if (row >= gn - 1 || !ok) break;
    const int beg = s_beg, end = s_end, npre = s_npre;
    ok = ok && !s_ovf;  // the overflow row itself is still computed
    const int4* pred = s_pred + (row & 1) * P;

    // ---- the control warp gathers the next row's predecessors while the
    // others compute this row
    if (warp == ctl && ok && row + 1 < gn - 1 && row + 1 < R) prepare(row + 1);

    // ---- predecessor maxima: H one column left, and E1/E2 (linear: H)
    int mq[CPT], e1r[CPT], e2r[CPT], hhat[CPT];
    int own1[CPT], own2[CPT];
    int run1 = kIntMin, run2 = kIntMin;
    if (has_cols) {
      const int* qrow = qp + q0 + (size_t)s_qb * QW + beg;
      int qv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        mq[c] = e1r[c] = e2r[c] = inf;
        qv[c] = (lane < W && beg + lane <= end) ? qrow[lane] : 0;
      }
      if (s_allring) {
        // every predecessor in the ring: four at a time, loads at clamped
        // addresses and selects, so their loads overlap
        for (int k0 = 0; k0 < npre; k0 += 4) {
          int4 pr[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)  // an empty record matches no column
            pr[u] = k0 + u < npre ? pred[k0 + u] : make_int4(0, 1, 0, 0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int pbeg = pr[u].y, pend = pr[u].z;
            const int ps = rec_score(pr[u].w, has_ps);
            // column -1's cell: 0 in B2's local mode (B1 adds it below)
            const int lead = local && k0 + u < npre ? 0 : inf;
            const int* rh = s_ring + (size_t)rec_slot(pr[u].w, has_ps) * W;
            const int* re1 = rh + (size_t)D * W;
            const int* re2 = re1 + (size_t)D * W;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const int col = beg + tid * CPT + c;
              const int x = col - 1 - pbeg, y = col - pbeg;
              const int xc = min(max(x, 0), W - 1), yc = min(max(y, 0), W - 1);
              const bool hx = col - 1 >= pbeg && col - 1 <= pend && x < W;
              const bool hy = col >= pbeg && col <= pend && y < W;
              if constexpr (SEEDED) {
                mq[c] = max(mq[c], (hx ? rh[xc] : col == 0 ? lead : inf) + ps);
                if (GAP == kLinear) {
                  e1r[c] = max(e1r[c], (hy ? rh[yc] : inf) + ps);
                } else {
                  e1r[c] = max(e1r[c], (hy ? re1[yc] : inf) + ps);
                  if (GAP == kConvex)
                    e2r[c] = max(e2r[c], (hy ? re2[yc] : inf) + ps);
                }
              } else {
                mq[c] = max(mq[c], hx ? rh[xc] : inf);
                if (GAP == kLinear) {
                  e1r[c] = max(e1r[c], hy ? rh[yc] : inf);
                } else {
                  e1r[c] = max(e1r[c], hy ? re1[yc] : inf);
                  if (GAP == kConvex) e2r[c] = max(e2r[c], hy ? re2[yc] : inf);
                }
              }
            }
          }
        }
      } else {
        for (int k = 0; k < npre; ++k) {
          const int4 pr = pred[k];
          const int p = pr.x, pbeg = pr.y, pend = pr.z;
          const int slot = rec_slot(pr.w, has_ps), ps = rec_score(pr.w, has_ps);
          const size_t grow = pl0 + (size_t)p * W;
          const int* rh = s_ring + (size_t)max(slot, 0) * W;
          const int* re1 = rh + (size_t)D * W;
          const int* re2 = re1 + (size_t)D * W;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int lane = tid * CPT + c;
            if (lane >= W) continue;
            const int col = beg + lane;
            const int x = col - 1 - pbeg;
            if constexpr (SEEDED) {
              if (col - 1 >= pbeg && col - 1 <= pend && x < W)
                mq[c] = max(mq[c], (slot >= 0 ? rh[x] : ld(H, grow + x, p16)) + ps);
              else if (local && col == 0)  // column -1's cell: 0
                mq[c] = max(mq[c], ps);
            } else if (col - 1 >= pbeg && col - 1 <= pend && x < W) {
              mq[c] = max(mq[c], slot >= 0 ? rh[x] : ld(H, grow + x, p16));
            }
            const int y = col - pbeg;
            if (col >= pbeg && col <= pend && y < W) {
              if (GAP == kLinear) {
                e1r[c] =
                    max(e1r[c], (slot >= 0 ? rh[y] : ld(H, grow + y, p16)) + ps);
              } else {
                e1r[c] =
                    max(e1r[c], (slot >= 0 ? re1[y] : ld(E1, grow + y, p16)) + ps);
                if (GAP == kConvex)
                  e2r[c] = max(e2r[c],
                               (slot >= 0 ? re2[y] : ld(E2, grow + y, p16)) + ps);
              }
            }
          }
        }
      }

      // ---- query profile band, local lead cell, H-hat
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        const bool in_band = lane < W && beg + lane <= end;
        if (!SEEDED && local && beg + lane == 0) mq[c] = max(mq[c], 0);
        mq[c] = in_band ? mq[c] + qv[c] : inf;
        if (GAP == kLinear) {
          e1r[c] = in_band ? e1r[c] - e1 : inf;  // E row from the preds' H
          hhat[c] = max(mq[c], e1r[c]);
        } else {
          if (!in_band) e1r[c] = e2r[c] = inf;
          hhat[c] = GAP == kConvex ? max(max(mq[c], e1r[c]), e2r[c])
                                   : max(mq[c], e1r[c]);
        }
      }

      // ---- gap chains F[j] = max(inf, max_{k<=j} A[k] - (j-k)*ext) as a
      // prefix max of A[k] + k*ext. Linear: A = H-hat. Otherwise A[0] =
      // mq[0] - oe and A[k] = H-hat[k-1] - oe, so the thread that holds
      // H-hat[k-1] contributes A[k]: own[c] covers k <= this thread's
      // column c. int32 holds every term: A >= inf - oe stays above
      // INT32_MIN by inf's 512 * ext margin (oracle.dp_inf_min), k * ext
      // only adds, and a prefix max at column j less j * ext is at least
      // A[j], so no width (B2's 32768 included) takes it below inf - oe
      if (GAP != kLinear && tid == 0) {  // A[0], from column 0's own mq
        const bool ib = beg <= end;
        run1 = ib ? mq[0] - oe1 : inf;
        if (GAP == kConvex) run2 = ib ? mq[0] - oe2 : inf;
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        if (GAP == kLinear) {
          if (lane < W) run1 = max(run1, hhat[c] + lane * e1);
          own1[c] = run1;
        } else {
          own1[c] = run1;
          own2[c] = run2;
          const int k = lane + 1;
          if (k < W) {
            const bool ib = beg + k <= end;
            run1 = max(run1, (ib ? hhat[c] - oe1 : inf) + k * e1);
            if (GAP == kConvex)
              run2 = max(run2, (ib ? hhat[c] - oe2 : inf) + k * e2);
          }
        }
      }
    }
    int tot1, tot2 = kIntMin;
    int ex1 = warp_scan_excl(run1, lane_id, &tot1);
    int ex2 = kIntMin;
    if (GAP == kConvex) ex2 = warp_scan_excl(run2, lane_id, &tot2);
    if (lane_id == 31) {
      s_part[warp] = tot1;
      s_part[nwarps + warp] = tot2;
    }
    __syncthreads();  // barrier 2: the chains' warp totals

    // ---- H, E, F per regime (pallas_fused.py:59-123), store, row max
    if (has_cols) {
      if (warp > 0) {  // the earlier warps' totals, one a lane
        const bool before = lane_id < warp;
        ex1 = max(ex1, __reduce_max_sync(kFull, before ? s_part[lane_id] : kIntMin));
        if (GAP == kConvex)
          ex2 = max(ex2, __reduce_max_sync(
                             kFull, before ? s_part[nwarps + lane_id] : kIntMin));
      }
      int t_max = kIntMin, t_left = 0x7fffffff, t_right = -1;
      const int slot = D > 0 ? (row & (D - 1)) : 0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int lane = tid * CPT + c;
        if (lane >= W) continue;
        const bool in_band = beg + lane <= end;
        const int f1 = max(max(ex1, own1[c]) - lane * e1, inf);
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
          g2 = max(max(ex2, own2[c]) - lane * e2, inf);
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
        const size_t at = pl0 + (size_t)row * W + lane;
        st(H, at, h, p16);
        st(E1, at, en1, p16);
        st(E2, at, en2, p16);
        st(F1, at, g1, p16);
        st(F2, at, g2, p16);
        if (D > 0) {
          int* rs = s_ring + (size_t)slot * W + lane;
          rs[0] = as_plane(h, p16);
          if (GAP != kLinear) rs[(size_t)D * W] = as_plane(en1, p16);
          if (GAP == kConvex) rs[(size_t)2 * D * W] = as_plane(en2, p16);
        }
        if (in_band) {  // the row max and its lowest / highest column
          const int col = beg + lane;
          if (h > t_max) {
            t_max = h;
            t_left = col;
          }
          if (h >= t_max) t_right = col;
        }
      }
      int mx, left, right;
      warp_argmax(t_max, t_left, t_right, &mx, &left, &right);
      if (lane_id == 0) {
        s_part[2 * nwarps + warp] = mx;
        s_part[3 * nwarps + warp] = left;
        s_part[4 * nwarps + warp] = right;
      }
    }
    __syncthreads();  // barrier 3: the row max and its columns

    // ---- the control warp closes the row (best cell in local and extend
    // + Z-drop, the pair the successors pull) and publishes the next band
    if (warp == ctl) {
      const bool mine = lane_id < ncol_warps;
      int mx, left, right;
      warp_argmax(mine ? s_part[2 * nwarps + lane_id] : kIntMin,
                  mine ? s_part[3 * nwarps + lane_id] : 0x7fffffff,
                  mine ? s_part[4 * nwarps + lane_id] : -1, &mx, &left,
                  &right);
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
      int pl, pr;
      if constexpr (SEEDED) {  // an unbanded row pushes nothing either
        const bool push =
            !local && !unbanded && !(extend && zdrop_on && zdropped);
        pl = push ? left + 1 : quiet_l<SEEDED>(gn);
        pr = push ? right + 1 : quiet_r<SEEDED>();
      } else {
        const bool push = !local && !(extend && zdrop_on && zdropped);
        pl = push ? left + 1 : gn;
        pr = push ? right + 1 : 0;
      }
      if (lane_id == 0) {
        s_sring[row & (kScalarRing - 1)] = make_int4(cur_beg, cur_end, pl, pr);
        lr[e0 + row] = pl;
        lr[e0 + R + row] = pr;
      }
      if (ok && row + 1 < gn - 1 && row + 1 < R) finish(row + 1, pl, pr);
      __syncwarp();
    }
    __syncthreads();  // barrier 1: the next row's band and predecessors
  }

  if constexpr (SEEDED) {
    // the rows the loop did not reach (the sink; after a band overflow,
    // every later row) take the pairs their computed predecessors left, as
    // Pallas's pushes leave them
    __syncthreads();
    for (int t = 1 + tid; t < gn; t += nthreads) {
      if (lr[e0 + R + t] != -1) continue;
      int mn_l = mpl0[r0 + t], mx_r = mpr0[r0 + t];
      const int npre = pre_cnt[r0 + t];
      for (int k = 0; k < npre; ++k) {
        const int p = pre_idx[(size_t)(r0 + t) * P + k];
        if (p >= 1 && lr[e0 + R + p] != -1) {
          mn_l = min(mn_l, lr[e0 + p]);
          mx_r = max(mx_r, lr[e0 + R + p]);
        }
      }
      mplr[e0 + t] = mn_l;
      mplr[e0 + R + t] = mx_r;
    }
  }
  if (warp == ctl) cp_async_wait<0>();
  if (warp == ctl && lane_id == 0) {
    ok_out[b] = ok;
    const bool track = local || extend;
    ext_out[4 * b] = track ? bs : inf;
    ext_out[4 * b + 1] = track ? bi : 0;
    ext_out[4 * b + 2] = track ? bj : 0;
    ext_out[4 * b + 3] = track ? zdropped : 0;
  }
}

struct Args {
  const int *sc, *base, *pre_idx, *pre_cnt, *remain, *row0, *qp;
  void *H, *E1, *E2, *F1, *F2;
  int *begend, *ok, *ext, *lr;
  int R, W, P, QW, D, mode, zdrop_on, plane16;
  const int *mpl0, *mpr0;  // B2 only
  int* mplr;
  const int* roff;
  int qstride, grid;
  const int* pre_score;  // B2 with path scores only
};

template <int CPT, int GAP, bool SEEDED>
cudaError_t launch(const Args& a, int threads, size_t smem, cudaStream_t s) {
  auto kern = fused_dp_kernel<CPT, GAP, SEEDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<a.grid, threads, smem, s>>>(
      a.sc, a.base, a.pre_idx, a.pre_cnt, a.remain, a.row0, a.qp, a.H, a.E1,
      a.E2, a.F1, a.F2, a.begend, a.ok, a.ext, a.lr, a.R, a.W, a.P, a.QW, a.D,
      a.mode, a.zdrop_on, a.plane16, a.mpl0, a.mpr0, a.mplr, a.roff,
      a.qstride, a.pre_score);
  return cudaGetLastError();
}

template <int CPT, bool SEEDED>
cudaError_t launch_gap(int gap, const Args& a, int threads, size_t smem,
                       cudaStream_t s) {
  switch (gap) {
    case kLinear: return launch<CPT, kLinear, SEEDED>(a, threads, smem, s);
    case kAffine: return launch<CPT, kAffine, SEEDED>(a, threads, smem, s);
    case kConvex: return launch<CPT, kConvex, SEEDED>(a, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// columns a thread for W over `threads` threads: a power of two
int cols_per_thread(int W, int threads) {
  int cpt = 1;
  while (cpt * threads < W) cpt *= 2;
  return cpt;
}

}  // namespace

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = launched). gap_mode 0/1/2 = linear/affine/convex; mode 0/1/2 =
// global/extend/local. Planes are int16 when plane16 is 1, else int32.
// `warps` sets the block, column warps and the control warp (CPT = W /
// (32 warps), a power of two up to 16),
// D the shared-memory ring's rows (0 or a power of two); `smem` must be the
// layout's byte count, which the wrapper computes the same way.
extern "C" int abpoa_fused_dp(const void* sc, const void* base,
                              const void* pre_idx, const void* pre_cnt,
                              const void* remain, const void* row0,
                              const void* qp, void* H, void* E1, void* E2,
                              void* F1, void* F2, void* begend, void* ok,
                              void* ext, void* lr, int R, int W, int P,
                              int QW, int gap_mode, int mode, int zdrop_on,
                              int plane16, int warps, int D, int smem,
                              void* stream) {
  const int threads = warps * 32;
  if (warps < 1 || threads > kMaxThreads || W < 1 || R < 1 || P < 1 ||
      mode < 0 || mode > 2 || gap_mode < 0 || gap_mode > 2 || D < 0 ||
      (D & (D - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int cpt = cols_per_thread(W, threads);
  const int nplanes = gap_mode == kLinear ? 1 : gap_mode == kAffine ? 2 : 3;
  if (cpt > 16 || (size_t)smem != smem_bytes(W, P, warps, D, nplanes,
                                             tab_extra<false>()))
    return (int)cudaErrorInvalidValue;
  Args a{(const int*)sc,      (const int*)base, (const int*)pre_idx,
         (const int*)pre_cnt, (const int*)remain, (const int*)row0,
         (const int*)qp,      H, E1, E2, F1, F2, (int*)begend, (int*)ok,
         (int*)ext,           (int*)lr, R, W, P, QW, D, mode, zdrop_on,
         plane16,             nullptr, nullptr, nullptr, nullptr, 0, 1,
         nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (cpt) {
    case 1: err = launch_gap<1, false>(gap_mode, a, threads, smem, s); break;
    case 2: err = launch_gap<2, false>(gap_mode, a, threads, smem, s); break;
    case 4: err = launch_gap<4, false>(gap_mode, a, threads, smem, s); break;
    case 8: err = launch_gap<8, false>(gap_mode, a, threads, smem, s); break;
    default: err = launch_gap<16, false>(gap_mode, a, threads, smem, s); break;
  }
  return (int)err;
}

// Kernel B2: the seeded instantiation (int32 planes, gap_mode 0/1/2 =
// linear/affine/convex; each window's mode, band and Z-drop in its
// scalars) on B2's tables, one block for each of the B windows of a ragged
// batch; see the header. `roff` (B + 1) gives each window's first row in
// the concatenated per-row inputs and outputs (rows of the planes, pairs of
// begend, mplr and lr); sc (B x 16), row0 (B x 5 x W), qp (B x qstride
// ints, QW columns a base), ok (B) and ext (B x 4: best score, row,
// column, zdropped of extend and local mode) hold one entry a window.
// `pre_score` (rows x P, the rows as pre_idx's) gives the path scores, or
// is null. Up to 32 columns a thread. `lr` is scratch; the
// other arguments are as for abpoa_fused_dp.
extern "C" int abpoa_banded_dp(const void* sc, const void* roff,
                               const void* base, const void* pre_idx,
                               const void* pre_cnt, const void* remain,
                               const void* mpl0, const void* mpr0,
                               const void* row0, const void* qp,
                               const void* pre_score, void* H, void* E1,
                               void* E2, void* F1, void* F2, void* begend,
                               void* mplr, void* ok, void* ext, void* lr,
                               int B, int W, int P, int QW, int qstride,
                               int gap_mode, int warps, int D, int smem,
                               void* stream) {
  const int threads = warps * 32;
  if (B < 1 || warps < 1 || threads > kMaxThreads || W < 1 || P < 1 ||
      gap_mode < 0 || gap_mode > 2 || D < 0 || (D & (D - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int cpt = cols_per_thread(W, threads);
  const int nplanes = gap_mode == kLinear ? 1 : gap_mode == kAffine ? 2 : 3;
  const int extra = tab_extra<true>() + (pre_score ? P : 0);
  if (cpt > 32 || (size_t)smem != smem_bytes(W, P, warps, D, nplanes, extra))
    return (int)cudaErrorInvalidValue;
  Args a{(const int*)sc,      (const int*)base, (const int*)pre_idx,
         (const int*)pre_cnt, (const int*)remain, (const int*)row0,
         (const int*)qp,      H, E1, E2, F1, F2, (int*)begend, (int*)ok,
         (int*)ext,           (int*)lr, 0, W, P, QW, D, 0, 0, 0,
         (const int*)mpl0,    (const int*)mpr0, (int*)mplr,
         (const int*)roff,    qstride, B, (const int*)pre_score};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cpt) {
    case 1: return (int)launch_gap<1, true>(gap_mode, a, threads, smem, s);
    case 2: return (int)launch_gap<2, true>(gap_mode, a, threads, smem, s);
    case 4: return (int)launch_gap<4, true>(gap_mode, a, threads, smem, s);
    case 8: return (int)launch_gap<8, true>(gap_mode, a, threads, smem, s);
    case 16: return (int)launch_gap<16, true>(gap_mode, a, threads, smem, s);
    default: return (int)launch_gap<32, true>(gap_mode, a, threads, smem, s);
  }
}

extern "C" const char* abpoa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
