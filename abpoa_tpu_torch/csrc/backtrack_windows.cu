// Kernel X1w: the best cell and the backtrack of each window of one B2 (or
// B2u) launch, written for Hopper (sm_90a) with one block a window: a walker
// warp that walks from tiles of the planes in shared memory, and a loader
// warp that stages those tiles ahead of it with bulk asynchronous copies.
//
// Replaces: abpoa_tpu/align/jax_backtrack.py `device_backtrack` as
// jax_backend.py `_dp_full_batch` vmaps it over a seeded read's windows,
// with `_dp_full`'s best cell of each mode (jax_backend.py:662-681), the
// local stop and `-G`'s path scores, and `_backtrack_w` over the lanes of
// the K-lane chunk (dp_chunk.py `run_dp_chunk`). The plain PyTorch version
// is `backtrack_windows_torch` in align/backtrack_kernel.py, which this
// kernel must equal on every output it defines.
//
// Block k takes window plan[k][0] of the launch: its rows start at
// roff[slot] in B2's ragged planes, tables and band (read in place), and its
// scalars are B2's (scalars[12] its mode: 0 global, 1 extend, 2 local). The
// loader copies the window's final mpl/mpr into the packed output. The
// walker takes the best cell (global mode: over the end row's predecessors
// in in-edge order, lane k slot k, the first strict maximum winning as
// jnp.argmax, row 0 for an end row without predecessors; extend and local
// mode: B2's `ext`) and walks with abPOA's op priority
// (src/abpoa_align_simd.c:309-458), as X1's `walk` in backtrack.cu does:
// match unless put_gap_on_right or a pending put_gap_at_end, then deletion
// through E1/E2, insertion through F1/F2, then match; among predecessor
// slots the first hit wins (`__ffs` of a ballot, 32 slots at a time); a
// local walk stops before a zero cell; with PS each slot's path score
// pre_score[i P + k] enters every equality that crosses to it. Lane 0 writes
// the header [n_ops, fin_i, fin_j, n_aln, n_match, start_i, start_j, err,
// best_score, best_i, best_j] and the op stream.
//
// What bounds it: the walk is a chain. A step reads the cells of the cell
// the last step chose in three dependent rounds (the row's band and tables;
// its H/E/F cells and its predecessors' bands; the predecessors' cells), a
// few hundred bytes in all, and a read's planes (114-3165 MiB) are far past
// the 50 MB L2, so each round waits on device memory: ~1.7 us a step when
// the walk read them there (PR 9's design, one warp a window), against a
// byte bound four orders of magnitude lower. It is bound by latency.
//
// What the design does about it: a step moves to (i, j-1), (p, j) or
// (p, j-1), p a predecessor of row i, and in row order the predecessors lie
// close to their row. So the cells the next steps read lie in a box of rows
// [ai - R + 1, ai] x columns [aj - C + 1, aj] below and left of the walk's
// cell (ai, aj), known before the walk gets there:
//  (a) one block a window: warp 0 walks, warp 1 loads. Two stages of shared
//      memory each hold one tile: the box's rows of the planes the gap mode
//      reads (H; H, E1, F1; H, E1, E2, F1, F2), the rows' beg, end,
//      pre_cnt, base, pre_idx and pre_score (when P <= kMaxStagedP), and the
//      query's C bases. R is as many rows as two stages fit in 227 KB
//      (`tile_shape`), at most kMaxRows;
//  (b) the loader copies a tile's tables with one bulk copy each
//      (cp.async.bulk ... mbarrier::complete_tx) and each row's plane
//      segments with 16-byte cp.async copies, a lane a row, whose
//      completion its stage's mbarrier tracks (cp.async.mbarrier.arrive);
//      it writes the column each segment's first int holds (`kb`). One
//      bulk copy a row and plane (~700 a tile) was tried first: small bulk
//      copies ran one after another at ~30-45 ns each on an H100, ~22 us a
//      tile, and paced the walk at 1.2-1.4 us a step;
//  (c) the walker reads every cell through one test: outside the row's
//      window [0, W) the cell is inf (as X1's `Planes::cell`); inside the
//      current tile's box it comes from shared memory; else from device
//      memory (out of line: `row_from_memory`, `cells_from_memory`). A step
//      the current tile holds (row i, every predecessor of row i, columns
//      j - 1 and j; one vote) makes its three rounds in shared memory, and
//      every lane reads the tile, so no lane's load waits on device memory;
//  (d) the prefetch rule: once the walk has crossed half of the current
//      tile in rows or columns, the walker publishes its cell and the
//      loader stages the tile anchored there into the other stage. The
//      walker changes stage at a step the current tile does not hold and
//      the other one does, waiting for its barrier then. A request the walk
//      has passed below or left of can hold no later step: the walker waits
//      for it and asks again. The output does not depend on the schedule,
//      only the time does; `chip_smoke.tile_replay` replays the rule on the
//      plain version's ops to count the steps tiles hold;
//  (e) the gap mode is compiled in (GAP), and the first hits among the
//      slots are taken without a branch.
// What bounds it now: the walker's own instructions. With every step in
// shared memory and the refills ~2 % of its clock, a step is ~1500 cycles
// on an H100 (0.78 us; 10057 steps of a 41-read graph, tools/x1w_tiles.py):
// a few hundred dependent instructions of one warp, where the three rounds
// of shared-memory loads are ~100 cycles.
//
// Traps:
//  - row r's band starts at beg[r], so column c of row r is plane index
//    r W + c - beg[r]: the offset differs from row to row (no 2-D box
//    describes a tile), and W is in general no multiple of 4, so a row's
//    segment is not 16-byte aligned. Each copy's source is rounded down to
//    16 bytes and its length up; the shift is recorded a row and plane
//    (`kb`: the column the copy's first int holds). The rounded ends stay
//    inside the 16-byte units of the segment's first and last ints, which
//    lie inside the tensor's allocation (CUDA allocations are aligned to at
//    least 256 bytes);
//  - a segment is clamped to the row's window [0, W); a cell outside the
//    window is inf before any tile is asked, so no copied value past either
//    end is ever used (a row whose window misses the box's columns gets no
//    copy and is never read);
//  - B2u's whole-row planes (W ~ 10112) and B2's (W 512) take the same path;
//  - the K lanes and the seeded windows are ragged: a window's rows start at
//    roff[slot];
//  - ops is written by lane 0 of the walker only;
//  - the walker waits for every copy it asked for before the block ends.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef X1W_TILE_COLS
#define X1W_TILE_COLS 32
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLinear = 0, kConvex = 2;
constexpr int kM = 0x1, kE1 = 0x2, kE2 = 0x4, kE = 0x6, kF1 = 0x8, kF2 = 0x10,
              kF = 0x18, kAll = 0x1F;

constexpr int kCols = X1W_TILE_COLS;  // C: columns a tile
static_assert(kCols % 4 == 0 && kCols >= 8 && kCols <= 256, "tile columns");
constexpr int kStride = kCols + 4;    // ints a tile row: C and a copy's shift
constexpr int kMaxRows = 256;         // R at most
constexpr int kMaxStagedP = 32;       // pre_idx / pre_score staged up to this P
constexpr int kSmemBytes = 232448;    // dynamic shared memory a block may have
constexpr int kCtl = 32;              // ints of the control block
constexpr int kThreads = 64;          // the walker warp and the loader warp

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// A block's shared memory, in ints: the control block ([0, 6) the stages'
// mbarriers and the request's, [6, 9) the request (row, column, stage),
// [16 + 8 s, 24 + 8 s) stage s's table shifts), mat (m x m), then two
// stages, each [beg | end | pre_cnt | base | pre_idx | pre_score | query |
// kb (np x R) | planes (np x R x kStride)]. Every region starts on 16 bytes.
struct Shape {
  int np;    // planes a tile holds
  int ps;    // pre_idx (and pre_score) slots a tile row holds: P, or 0
  int R;     // rows a tile
  int mat;   // ints before the first stage
  int o_end, o_cnt, o_base, o_pre, o_psc, o_q, o_kb, o_pl, stage;
  int smem;  // bytes
};

// Mirrored by align/backtrack_kernel.py `tile_shape`.
__host__ __device__ inline Shape tile_shape(int gap_mode, int P,
                                            bool path_score, int m) {
  Shape s;
  s.np = gap_mode == kLinear ? 1 : gap_mode == kConvex ? 5 : 3;
  s.ps = P <= kMaxStagedP ? P : 0;
  const int tabs = s.ps ? (path_score ? 2 : 1) : 0;
  s.mat = kCtl + round4(m * m);
  const int half = (kSmemBytes / 4 - s.mat) / 2;
  const int fixed = 4 * 4 + 4 * tabs + kStride;
  const int per_row = 4 + s.ps * tabs + s.np * (kStride + 1);
  const int R = (half - fixed) / per_row;
  s.R = (R < kMaxRows ? R : kMaxRows) & ~7;
  const int t = s.R + 4, pre = s.ps ? s.R * s.ps + 4 : 0;
  s.o_end = t;
  s.o_cnt = 2 * t;
  s.o_base = 3 * t;
  s.o_pre = 4 * t;
  s.o_psc = s.o_pre + pre;
  s.o_q = s.o_psc + (tabs == 2 ? pre : 0);
  s.o_kb = s.o_q + kStride;
  s.o_pl = s.o_kb + s.np * s.R;
  s.stage = s.o_pl + s.np * s.R * kStride;
  s.smem = 4 * (s.mat + 2 * s.stage);
  return s;
}

// the plane a tile's slot holds (H 0, E1 1, E2 2, F1 3, F2 4)
__device__ __forceinline__ int plane_of(int slot, int np) {
  return np == 3 && slot == 2 ? 3 : slot;
}

// The box of the tile anchored at cell (ai, aj): rows [rlo, rhi], columns
// [clo, chi], query indices [qlo, qhi].
struct Box {
  int rlo, rhi, clo, chi, qlo, qhi;
};

__device__ __forceinline__ Box box_at(int R, int ai, int aj, int qlen) {
  Box b;
  b.rlo = max(ai - R + 1, 0);
  b.rhi = ai;
  b.clo = aj - kCols + 1;
  b.chi = aj;
  b.qlo = max(b.clo - 1, 0);
  b.qhi = min(b.chi - 1, qlen - 1);
  return b;
}

// The tile holds the step at (i, j) whose least predecessor row is pmin.
__device__ __forceinline__ bool holds(const Box& b, int i, int j, int pmin) {
  return i >= b.rlo && i <= b.rhi && j - 1 >= b.clo && j <= b.chi &&
         pmin >= b.rlo;
}

// ---- mbarriers and bulk copies (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// count ints from src into dst (16-byte aligned) in one bulk copy that
// completes on bar; the source is rounded down to 16 bytes, so dst[shift]
// is src[0]. Returns the shift.
__device__ __forceinline__ int bulk_copy(int* dst, const int* src, int count,
                                         uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int shift = static_cast<int>(a & 15) >> 2;
  const int bytes = ((count + shift) * 4 + 15) & ~15;
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(a - 4 * shift), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
  return shift;
}

// 16 bytes from src into dst (both 16-byte aligned), a cp.async of the
// calling thread
__device__ __forceinline__ void copy16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One window's arrays in device memory, at its row 0.
struct Win {
  const int* H;  // row r, band index k at r W + k; E1, E2, F1, F2 follow
  const int* beg;
  const int* end;
  const int* cnt;
  const int* base;
  const int* pre;
  const int* psc;
  const int* query;
  size_t plane;  // ints from one plane to the next (H, E1, E2, F1, F2)
  int W, P, qlen, inf;
};

// a cell from device memory: inf outside the row's window (or where `in`
// is false), the load made at a clamped address either way
__device__ __forceinline__ int gcell(const int* p, int r, int rbeg, int c,
                                     bool in, int W, int inf) {
  const int k = c - rbeg;
  const int v = p[(size_t)r * W + min(max(k, 0), W - 1)];
  return in && k >= 0 && k < W ? v : inf;
}

// a cell from a tile row (row: the slot's row of the tile; cb: the column
// its first int holds), inf outside the row's window
__device__ __forceinline__ int tcell(const int* row, int cb, int rbeg, int c,
                                     bool in, int W, int inf) {
  const int k = c - rbeg;
  const int v = row[min(max(c - cb, 0), kStride - 1)];
  return in && k >= 0 && k < W ? v : inf;
}

// Stage s of the loader: the tile anchored at (ai, aj). One bulk copy a
// table (a lane each), then a lane a row (rows lane, lane + 32, ...): each
// plane's segment in 16-byte cp.async copies. Stage s's barrier completes
// once the bulk copies' bytes have landed, every lane's cp.async copies
// have completed (cp.async.mbarrier.arrive) and every lane has arrived
// after writing its rows' kb.
template <bool PS>
__device__ __forceinline__ void stage_tile(int* S, const Shape& sh,
                                           const Win& g, int s, int ai, int aj,
                                           int lane) {
  const Box bx = box_at(sh.R, ai, aj, g.qlen);
  int* st = S + sh.mat + s * sh.stage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(S) + s;
  const int n = bx.rhi - bx.rlo + 1;
  int shift = 0;
  if (lane == 0) {
    shift = bulk_copy(st, g.beg + bx.rlo, n, bar);
  } else if (lane == 1) {
    shift = bulk_copy(st + sh.o_end, g.end + bx.rlo, n, bar);
  } else if (lane == 2) {
    shift = bulk_copy(st + sh.o_cnt, g.cnt + bx.rlo, n, bar);
  } else if (lane == 3) {
    shift = bulk_copy(st + sh.o_base, g.base + bx.rlo, n, bar);
  } else if (lane == 4 && sh.ps) {
    shift = bulk_copy(st + sh.o_pre, g.pre + (size_t)bx.rlo * g.P, n * g.P,
                      bar);
  } else if (lane == 5 && PS && sh.ps) {
    shift = bulk_copy(st + sh.o_psc, g.psc + (size_t)bx.rlo * g.P, n * g.P,
                      bar);
  } else if (lane == 6 && bx.qhi >= bx.qlo) {
    shift = bulk_copy(st + sh.o_q, g.query + bx.qlo, bx.qhi - bx.qlo + 1, bar);
  }
  if (lane < 7) S[16 + 8 * s + lane] = shift;
  // every row's band start first (one round of loads), then its copies
  int b[kMaxRows / 32];
#pragma unroll
  for (int t = 0; t < kMaxRows / 32; ++t) {
    const int rr = lane + 32 * t;
    b[t] = rr < n ? g.beg[bx.rlo + rr] : 0;
  }
#pragma unroll
  for (int t = 0; t < kMaxRows / 32; ++t) {
    const int rr = lane + 32 * t;
    const int klo = max(bx.clo - b[t], 0), khi = min(bx.chi - b[t], g.W - 1);
    if (rr >= n || klo > khi) continue;
    const size_t at = (size_t)(bx.rlo + rr) * g.W + klo;
    for (int slot = 0; slot < sh.np; ++slot) {
      const int* src = g.H + plane_of(slot, sh.np) * g.plane + at;
      const int sft =
          static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) >> 2;
      const int chunks = (khi - klo + 1 + sft + 3) >> 2;
      int* dst = st + sh.o_pl + (slot * sh.R + rr) * kStride;
      for (int c = 0; c < chunks; ++c) copy16(dst + 4 * c, src - sft + 4 * c);
      st[sh.o_kb + slot * sh.R + rr] = b[t] + klo - sft;
    }
  }
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
  bar_arrive(bar);
}

// The walker's view of the current stage: its box and the offsets in S of
// row rlo's table entries (and query index qlo's base).
struct View {
  Box b;
  int beg, end, cnt, base, pre, psc, q, kb, pl;
};

__device__ __forceinline__ View view_of(const int* S, const Shape& sh, int s,
                                        int ai, int aj, int qlen) {
  View v;
  v.b = box_at(sh.R, ai, aj, qlen);
  const int o = sh.mat + s * sh.stage;
  const int* sft = S + 16 + 8 * s;
  v.beg = o + sft[0];
  v.end = o + sh.o_end + sft[1];
  v.cnt = o + sh.o_cnt + sft[2];
  v.base = o + sh.o_base + sft[3];
  v.pre = o + sh.o_pre + sft[4];
  v.psc = o + sh.o_psc + sft[5];
  v.q = o + sh.o_q + sft[6];
  v.kb = o + sh.o_kb;
  v.pl = o + sh.o_pl;
  return v;
}

struct Walk {
  int i, j, n_ops, n_aln, n_match, err, si, sj;
};

// A row's tables and its first 32 predecessor slots (lane k slot k), and
// its cells at columns j and j - 1, read from device memory: a step the
// current tile does not hold. Out of line, so that a step the tile holds
// carries none of their address arithmetic.
struct RowTab {
  int beg, end, cnt, base, p0, ps0;
};

template <bool PS>
__device__ __noinline__ RowTab row_from_memory(const int* beg, const int* end,
                                               const int* cnt, const int* base,
                                               const int* pre, const int* psc,
                                               int i, int P, int lane) {
  RowTab t{beg[i], end[i], cnt[i], base[i] & 0xFF, 0, 0};
  if (lane < P) {
    t.p0 = pre[(size_t)i * P + lane];
    if (PS) t.ps0 = psc[(size_t)i * P + lane];
  }
  return t;
}

struct RowCells {
  int H_ij, H_ijm1, E1_ij, E2_ij, F1_ij, F1_ijm1, F2_ij, F2_ijm1;
};

template <int GAP>
__device__ __noinline__ RowCells cells_from_memory(const int* H, size_t plane,
                                                   int i, int rbeg, int j,
                                                   bool at_j, bool at_jm1,
                                                   int W, int inf) {
  RowCells c{inf, inf, inf, inf, inf, inf, inf, inf};
  c.H_ij = gcell(H, i, rbeg, j, at_j, W, inf);
  c.H_ijm1 = gcell(H, i, rbeg, j - 1, at_jm1, W, inf);
  if (GAP != kLinear) {
    c.E1_ij = gcell(H + plane, i, rbeg, j, at_j, W, inf);
    c.F1_ij = gcell(H + 3 * plane, i, rbeg, j, at_j, W, inf);
    c.F1_ijm1 = gcell(H + 3 * plane, i, rbeg, j - 1, at_jm1, W, inf);
    if (GAP == kConvex) {
      c.E2_ij = gcell(H + 2 * plane, i, rbeg, j, at_j, W, inf);
      c.F2_ij = gcell(H + 4 * plane, i, rbeg, j, at_j, W, inf);
      c.F2_ijm1 = gcell(H + 4 * plane, i, rbeg, j - 1, at_jm1, W, inf);
    }
  }
  return c;
}

// the least of pre[k] over slots k in [32, npre) (rows with more than 32
// predecessors: only where P > kMaxStagedP, so from device memory)
__device__ __noinline__ int least_past_32(const int* pre, int npre, int lane) {
  int least = INT_MAX;
  for (int c0 = 32; c0 < npre; c0 += 32) {
    const int k = c0 + lane;
    least = min(least, __reduce_min_sync(kFull, k < npre ? pre[k] : INT_MAX));
  }
  return least;
}

// The walk from cell (i, j) back to row 0 (or, in local mode, to a zero
// cell): X1's `walk` (backtrack.cu) step for step, each cell read from the
// current tile where it holds it. Returns the end cell, the counts, err and
// the cell the last step started from.
template <bool PS, int GAP>
__device__ __forceinline__ Walk walk_tiles(int* S, const Shape& sh,
                                           const Win& g, int* ops, int i,
                                           int j, int e1, int oe1, int e2,
                                           int oe2, int max_ops, int m,
                                           int flags, int lane) {
  const bool gap_on_right = flags & 1, local = flags & 4;
  constexpr bool linear = GAP == kLinear, convex = GAP == kConvex;
  const int W = g.W, P = g.P, inf = g.inf, R = sh.R;
  constexpr int sF1 = convex ? 3 : 2;  // F1's slot (E1 1; E2 2, F2 4)
  const int plane = R * kStride;       // ints between a tile's slots
  const int* mat = S + kCtl;
  uint64_t* bars = reinterpret_cast<uint64_t*>(S);
  int phases = 0;  // bit s: the parity stage s's barrier waits for next
  auto request = [&](int s, int ai, int aj) {
    if (lane == 0) {
      S[6] = ai;
      S[7] = aj;
      S[8] = s;
      bar_arrive(bars + 2);
    }
    __syncwarp();
  };
  auto wait_stage = [&](int s) {
    bar_wait(bars + s, (phases >> s) & 1);
    phases ^= 1 << s;
  };

  // the first tile, anchored at the start cell; a request's box, and the
  // row and column that cross half of the current tile
  int cur = 0, o_ai = 0, o_aj = 0;
  bool pending = false;  // the other stage has a request in flight
  Box ob{};
  request(0, i, j);
  wait_stage(0);
  View v = view_of(S, sh, 0, i, j, g.qlen);
  int half_r = v.b.rhi - R / 2, half_c = v.b.chi - kCols / 2;

  int cur_op = kAll, look_gap = (flags & 2) ? 1 : 0;
  int n_ops = 0, n_aln = 0, n_match = 0, err = 0;
  Walk w;
  w.si = i;
  w.sj = j;

  while (i > 0 && j > 0) {
    // round 1: the row's tables, its first 32 predecessor slots and the
    // query base, from the tile where it holds them
    bool rin = i >= v.b.rlo && i <= v.b.rhi;
    int rr = i - v.b.rlo;
    int rbeg, rend, npre, bi, p0 = 0, ps0 = 0;
    int kb0 = 0, kb1 = 0, kb2 = 0, kb3 = 0, kb4 = 0;
    if (rin) {
      rbeg = S[v.beg + rr];
      rend = S[v.end + rr];
      npre = S[v.cnt + rr];
      bi = S[v.base + rr] & 0xFF;
      if (lane < P) {
        p0 = sh.ps ? S[v.pre + rr * P + lane] : g.pre[(size_t)i * P + lane];
        if (PS)
          ps0 = sh.ps ? S[v.psc + rr * P + lane] : g.psc[(size_t)i * P + lane];
      }
    } else {
      const RowTab t = row_from_memory<PS>(g.beg, g.end, g.cnt, g.base, g.pre,
                                           g.psc, i, P, lane);
      rbeg = t.beg;
      rend = t.end;
      npre = t.cnt;
      bi = t.base;
      p0 = t.p0;
      ps0 = t.ps0;
    }
    auto load_kb = [&]() {
      kb0 = S[v.kb + rr];
      if (!linear) {
        kb1 = S[v.kb + R + rr];
        kb2 = S[v.kb + 2 * R + rr];
        if (convex) {
          kb3 = S[v.kb + 3 * R + rr];
          kb4 = S[v.kb + 4 * R + rr];
        }
      }
    };
    if (rin) load_kb();
    const int qb = j - 1 >= v.b.qlo && j - 1 <= v.b.qhi
                       ? S[v.q + j - 1 - v.b.qlo]
                       : g.query[j - 1];
    // the current tile holds the step: row i, columns j - 1 and j, and
    // every predecessor (a vote, and past 32 slots their least row)
    const bool preds_in = __all_sync(kFull, lane >= npre || p0 >= v.b.rlo);
    bool held = rin && j - 1 >= v.b.clo && j <= v.b.chi && preds_in &&
                (npre <= 32 ||
                 least_past_32(g.pre + (size_t)i * P, npre, lane) >= v.b.rlo);
    // the stage change: to the other tile where it holds the step and the
    // current one does not
    if (pending && !held) {
      int pmin = __reduce_min_sync(kFull, lane < npre ? p0 : INT_MAX);
      if (npre > 32)
        pmin = min(pmin, least_past_32(g.pre + (size_t)i * P, npre, lane));
      if (holds(ob, i, j, pmin)) {
        cur ^= 1;
        wait_stage(cur);
        pending = false;
        v = view_of(S, sh, cur, o_ai, o_aj, g.qlen);
        half_r = v.b.rhi - R / 2;
        half_c = v.b.chi - kCols / 2;
        held = rin = true;
        rr = i - v.b.rlo;
        load_kb();
      }
    }
    const bool cols = j - 1 >= v.b.clo && j <= v.b.chi;

    // round 2: the row's cells
    const int s = mat[bi * m + qb];
    const bool at_j = j <= rend, at_jm1 = j - 1 <= rend;
    int H_ij, H_ijm1, E1_ij = inf, E2_ij = inf, F1_ij = inf, F1_ijm1 = inf,
                      F2_ij = inf, F2_ijm1 = inf;
    if (rin && cols) {
      const int* row = S + v.pl + rr * kStride;
      H_ij = tcell(row, kb0, rbeg, j, at_j, W, inf);
      H_ijm1 = tcell(row, kb0, rbeg, j - 1, at_jm1, W, inf);
      if (!linear) {
        E1_ij = tcell(row + plane, kb1, rbeg, j, at_j, W, inf);
        const int* f1 = row + sF1 * plane;
        const int kbf1 = convex ? kb3 : kb2;
        F1_ij = tcell(f1, kbf1, rbeg, j, at_j, W, inf);
        F1_ijm1 = tcell(f1, kbf1, rbeg, j - 1, at_jm1, W, inf);
        if (convex) {
          E2_ij = tcell(row + 2 * plane, kb2, rbeg, j, at_j, W, inf);
          F2_ij = tcell(row + 4 * plane, kb4, rbeg, j, at_j, W, inf);
          F2_ijm1 = tcell(row + 4 * plane, kb4, rbeg, j - 1, at_jm1, W, inf);
        }
      }
    } else {
      const RowCells c = cells_from_memory<GAP>(g.H, g.plane, i, rbeg, j,
                                                at_j, at_jm1, W, inf);
      H_ij = c.H_ij;
      H_ijm1 = c.H_ijm1;
      E1_ij = c.E1_ij;
      E2_ij = c.E2_ij;
      F1_ij = c.F1_ij;
      F1_ijm1 = c.F1_ijm1;
      F2_ij = c.F2_ij;
      F2_ijm1 = c.F2_ijm1;
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
      const int p = c0 == 0 ? p0 : (has ? g.pre[(size_t)i * P + k] : 0);
      const int ps =
          PS && has ? (c0 == 0 ? ps0 : g.psc[(size_t)i * P + k]) : 0;
      // a lane without a slot reads nothing (in device memory its loads
      // would hold up the warp's ballot)
      int pb = 0, pe = -1, ph_m = inf, ph = inf, pe1 = inf, pe2 = inf;
      auto from_tile = [&](int pr) {
        pb = S[v.beg + pr];
        pe = S[v.end + pr];
        const int* row = S + v.pl + pr * kStride;
        const int kh = S[v.kb + pr];
        ph_m = tcell(row, kh, pb, j - 1, true, W, inf);
        ph = tcell(row, kh, pb, j, true, W, inf);
        if (!linear)
          pe1 = tcell(row + plane, S[v.kb + R + pr], pb, j, true, W, inf);
        if (convex)
          pe2 = tcell(row + 2 * plane, S[v.kb + 2 * R + pr], pb, j, true, W,
                      inf);
      };
      if (held) {  // every lane reads the tile (a lane without a slot row rlo)
        from_tile(has ? p - v.b.rlo : 0);
      } else if (!has) {
      } else if (cols && p >= v.b.rlo && p <= v.b.rhi) {
        from_tile(p - v.b.rlo);
      } else {
        pb = g.beg[p];
        pe = g.end[p];
        ph_m = gcell(g.H, p, pb, j - 1, true, W, inf);
        ph = gcell(g.H, p, pb, j, true, W, inf);
        if (!linear) pe1 = gcell(g.H + g.plane, p, pb, j, true, W, inf);
        if (convex) pe2 = gcell(g.H + 2 * g.plane, p, pb, j, true, W, inf);
      }
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
      // the first hits, taken without a branch
      const unsigned bm = __ballot_sync(kFull, m_hit);
      const unsigned bd = __ballot_sync(kFull, d_hit);
      const int sm = (__ffs(bm) - 1) & 31, sd = (__ffs(bd) - 1) & 31;
      const int pm_c = __shfl_sync(kFull, p, sm);
      const int pd_c = __shfl_sync(kFull, p, sd);
      const int op_c = __shfl_sync(kFull, op, sd);
      const bool new_m = first_m < 0 && bm, new_d = first_d < 0 && bd;
      first_m = new_m ? c0 + sm : first_m;
      pm = new_m ? pm_c : pm;
      first_d = new_d ? c0 + sd : first_d;
      pd = new_d ? pd_c : pd;
      d_new_op = new_d ? op_c : d_new_op;
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
    // the prefetch rule, at the cell the walk moved to
    if (i > 0 && j > 0) {
      // a request the walk has passed can hold no later step
      if (pending && (i < ob.rlo || j - 1 < ob.clo)) {
        wait_stage(cur ^ 1);
        pending = false;
      }
      if (!pending && (i <= half_r || j <= half_c)) {
        request(cur ^ 1, i, j);
        pending = true;
        o_ai = i;
        o_aj = j;
        ob = box_at(R, i, j, g.qlen);
      }
    }
  }
  if (pending) wait_stage(cur ^ 1);  // no copy may land after the block ends
  request(0, -1, 0);            // the loader stops
  w.i = i;
  w.j = j;
  w.n_ops = n_ops;
  w.n_aln = n_aln;
  w.n_match = n_match;
  w.err = err;
  return w;
}

template <bool PS, int GAP>
__global__ void __launch_bounds__(kThreads, 1)
backtrack_windows_kernel(const int* __restrict__ planes,
                         const int* __restrict__ begend,
                         const int* __restrict__ mplr,
                         const int* __restrict__ ext,
                         const int* __restrict__ pre_idx_all,
                         const int* __restrict__ pre_cnt_all,
                         const int* __restrict__ base_all,
                         const int* __restrict__ scalars,
                         const int* __restrict__ roff,
                         const int* __restrict__ mat,
                         const int* __restrict__ query_all,
                         const int* __restrict__ plan,
                         const int* __restrict__ pre_score_all, int* packed,
                         int Rtot, int W, int P, int m, int flags) {
  extern __shared__ __align__(16) int S[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* pk = plan + 6 * blockIdx.x;
  const int* sc = scalars + 16 * pk[0];
  const int qlen = sc[0], inf = sc[3], e1 = sc[5], oe1 = sc[6], e2 = sc[8],
            oe2 = sc[9], gn = sc[10], mode = sc[12];
  const int r0 = roff[pk[0]];
  const size_t plane = (size_t)Rtot * W;
  const Shape sh = tile_shape(GAP, P, PS, m);
  Win g;
  g.H = planes + (size_t)r0 * W;
  g.beg = begend + 2 * r0;
  g.end = g.beg + gn;
  g.cnt = pre_cnt_all + r0;
  g.base = base_all + r0;
  g.pre = pre_idx_all + (size_t)r0 * P;
  g.psc = PS ? pre_score_all + (size_t)r0 * P : nullptr;
  g.query = query_all + pk[1];
  g.plane = plane;
  g.W = W;
  g.P = P;
  g.qlen = qlen;
  g.inf = inf;

  for (int t = threadIdx.x; t < m * m; t += kThreads) S[kCtl + t] = mat[t];
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(S);
    bar_init(bars, 32);
    bar_init(bars + 1, 32);
    bar_init(bars + 2, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {
    // the loader: the window's final mpl/mpr, then a tile a request
    for (int t = lane; t < 2 * gn; t += 32)
      packed[pk[3] + t] = mplr[2 * r0 + t];
    uint64_t* req = reinterpret_cast<uint64_t*>(S) + 2;
    for (int parity = 0;; parity ^= 1) {
      bar_wait(req, parity);
      const int ai = S[6], aj = S[7], s = S[8];
      if (ai < 0) return;
      stage_tile<PS>(S, sh, g, s, ai, aj, lane);
    }
  }

  // the best cell: B2's in extend and local mode, else the best over the
  // end row's predecessors
  const int nsink = g.cnt[gn - 1];
  const int ncand = mode != 0 ? 0 : nsink > 0 ? nsink : 1;
  int best = inf, best_i = 0, best_j = 0;
  if (mode != 0) {
    best = ext[4 * pk[0]];
    best_i = ext[4 * pk[0] + 1];
    best_j = ext[4 * pk[0] + 2];
  }
  for (int c0 = 0; c0 < ncand; c0 += 32) {
    const int slot = c0 + lane;
    const bool has = slot < ncand;
    int p = 0, e = 0, v = INT_MIN, at = INT_MAX;
    if (has) {
      p = nsink > 0 ? g.pre[(size_t)(gn - 1) * P + slot] : 0;
      e = min(qlen, g.end[p]);
      v = gcell(g.H, p, g.beg[p], e, true, W, inf);
      at = slot;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(kFull, v, off);
      const int oat = __shfl_xor_sync(kFull, at, off);
      if (ov > v || (ov == v && oat < at)) {
        v = ov;
        at = oat;
      }
    }
    const int bp = __shfl_sync(kFull, p, at - c0);
    const int be = __shfl_sync(kFull, e, at - c0);
    if (c0 == 0 || v > best) {
      best = v;
      best_i = bp;
      best_j = be;
    }
  }

  const Walk w = walk_tiles<PS, GAP>(S, sh, g, packed + pk[4], best_i, best_j,
                                     e1, oe1, e2, oe2, pk[5], m,
                                     (flags & 3) | (mode == 2 ? 4 : 0), lane);
  if (lane == 0) {
    int* hdr = packed + pk[2];
    hdr[0] = w.n_ops;
    hdr[1] = w.i;
    hdr[2] = w.j;
    hdr[3] = w.n_aln;
    hdr[4] = w.n_match;
    hdr[5] = w.si;
    hdr[6] = w.sj;
    hdr[7] = w.err;
    hdr[8] = best;
    hdr[9] = best_i;
    hdr[10] = best_j;
  }
}

}  // namespace

// Launches X1w, one block a walk (n walks), on `stream`; returns a
// cudaError_t as an int (0 = launched). `planes` is B2's (5, Rtot, W) int32
// output, begend/mplr its (2 Rtot,) outputs, ext its (B, 4) best cells,
// pre_idx (Rtot, P), pre_cnt and base (Rtot,), scalars (B, 16) and roff
// (B + 1,) its inputs, pre_score its (Rtot, P) path scores or null; query
// holds the walked windows' queries one after another, plan (n, 6) each
// walk's [slot, query offset, header, band and op offsets in packed,
// max_ops]. flags: 1 put_gap_on_right, 2 put_gap_at_end. The kernel's
// shared memory (`abpoa_backtrack_windows_tile`) is set on every call; an
// error there is returned and nothing is launched.
extern "C" int abpoa_backtrack_windows(
    const void* planes, const void* begend, const void* mplr,
    const void* ext, const void* pre_idx, const void* pre_cnt,
    const void* base, const void* scalars, const void* roff, const void* mat,
    const void* query, const void* plan, const void* pre_score, void* packed,
    int n, int Rtot, int W, int P, int m, int gap_mode, int flags,
    void* stream) {
  if (n < 1 || Rtot < 1 || W < 1 || P < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  const Shape sh = tile_shape(gap_mode, P, pre_score != nullptr, m);
  if (sh.R < 8 || gap_mode < 0 || gap_mode > kConvex)
    return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const int*, const int*, const int*, const int*,
                          const int*, const int*, const int*, const int*,
                          const int*, const int*, const int*, const int*,
                          const int*, int*, int, int, int, int, int);
  const Kernel kernels[2][3] = {
      {backtrack_windows_kernel<false, 0>, backtrack_windows_kernel<false, 1>,
       backtrack_windows_kernel<false, 2>},
      {backtrack_windows_kernel<true, 0>, backtrack_windows_kernel<true, 1>,
       backtrack_windows_kernel<true, 2>}};
  const Kernel kern = kernels[pre_score != nullptr][gap_mode];
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<n, kThreads, sh.smem, (cudaStream_t)stream>>>(
      (const int*)planes, (const int*)begend, (const int*)mplr,
      (const int*)ext, (const int*)pre_idx, (const int*)pre_cnt,
      (const int*)base, (const int*)scalars, (const int*)roff,
      (const int*)mat, (const int*)query, (const int*)plan,
      (const int*)pre_score, (int*)packed, Rtot, W, P, m, flags);
  return (int)cudaGetLastError();
}

// X1w's tile for a gap mode, P predecessor slots, path scores or not and an
// m x m score matrix: out = [R rows, C columns, planes held, pre_idx slots
// staged a row (0: read from device memory), shared-memory bytes a block].
extern "C" int abpoa_backtrack_windows_tile(int gap_mode, int P,
                                            int path_score, int m, int* out) {
  const Shape sh = tile_shape(gap_mode, P, path_score != 0, m);
  out[0] = sh.R;
  out[1] = kCols;
  out[2] = sh.np;
  out[3] = sh.ps;
  out[4] = sh.smem;
  return 0;
}
