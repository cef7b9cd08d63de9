// The fused loop's per-read edge sort (S1) and its Kahn repair of the
// topological order (K1), written for Hopper (sm_90a).
//
// Replaces:
//   S1  the XLA steps that end a fusion in abpoa_tpu/align/fused_loop.py
//       (:1446-1452): the whole-graph span update (n_span + 1 below node_n)
//       and `_edge_sort` (:145), abPOA's weight-descending exchange sort of
//       every node's in and out slots, with its unstable tie order
//       (src/abpoa_graph.c:192-219);
//   K1  the XLA function abpoa_tpu/align/device_graph.py `topo_sort`
//       (reference src/abpoa_graph.c:192-357), run when the spliced order of
//       the fused loop is not a valid topological order. Three passes:
//         1. Kahn BFS from the source over the edge slots as given; a node
//            is queued only when its whole aligned group has in-degree 0,
//            and its group follows it (aligned-group atomicity);
//         2. the exchange sort of S1;
//         3. reverse BFS from the sink: remain[v] = remain[heaviest
//            out-edge target] + 1 (slot 0 after the sort), -1 at the sink.
// The plain PyTorch versions are `finish_fusion_torch_` and `edge_sort_torch`
// (align/edge_sort_kernel.py) and `topo_sort_torch` (align/topo_kernel.py,
// whose pass 2 is `edge_sort_torch`); the kernels must agree with them
// exactly.
//
// What bounds them: S1 follows one read's fusion, which changed only the
// rows of that read's path (a weight raised by the read's weight, or an edge
// appended last at the read's weight, which ties or loses and so never
// swaps). It must read both counts and n_span below node_n, the weights of
// the rows with two or more slots, and read and write the few hundred rows
// that move: about a megabyte at the headline's final graph (node_n =
// 52163, E = 16), well under a microsecond of HBM time, so the launch itself
// sets its floor. K1's two BFS passes visit ~node_n nodes one after another;
// each visit is a few dependent loads (the node's slots, the targets'
// degrees, their aligned groups) and the warp's own steps, so the passes are
// bound by the latency of that chain, far from the card's bytes and
// operations.
//
// What the design does about it:
//  - S1 is one launch, in place, one thread a row and a side (blockIdx.y: 0
//    in, 1 out) and a block row a lane (blockIdx.z: the device lockstep's
//    lanes, N rows apart; one read set is lane 0). It reads node_n on the
//    card (no host sync); a block whose
//    rows all lie past node_n returns, and rows past node_n are neither read
//    nor written. Side 0 adds 1 to n_span below node_n (when given). A row
//    with two or more slots reads its weights (16-byte loads where E is a
//    multiple of 4) and stops at the first weight above the one before it;
//    a row without one is left exactly as it is, since the exchange sort
//    swaps only on a strictly larger later weight. Only the rows that move
//    read their ids; the row's own thread runs the exchange sort on its
//    copy in shared memory (rows padded to E + 1 words), so a warp's
//    moving rows sort side by side, and writes it back. (A warp a row,
//    where pass j is a prefix max of the later weights, was slower on the
//    card at the fused loop's inputs and on tie-heavy rows: a warp's moving
//    rows wait for each other; PERF.md.) K1's pass 2 copies its inputs into
//    its outputs on the stream and runs this launch on them over all N rows
//    with no span.
//  - K1's two BFS passes run in one block a lane to repair (a device list
//    of the lockstep's lanes, each block with its own shared memory; one
//    read set is one block), walked by one warp. The degrees
//    live in shared memory as int8 when E <= 127 and N bytes fit, and in an
//    int32 instantiation in device memory otherwise
//    (`topo_kernel.launch_shape` picks; the tests run both). A decrement
//    saturates at int8's minimum: a degree is only ever compared with 0 and
//    only decreases, so once negative it stays nonzero whatever its value.
//  - Before the walk, a launch over the whole card writes each node's
//    record: its slots in the walk's direction and, for pass 1, each
//    target's aligned group, packed, together with the counts a visit would
//    otherwise gather with shuffles (how many slots up to k name the target
//    or a group member). One contiguous copy holds all a visit reads.
//  - The whole warp visits a node: lane k takes slot k (chunks of 32 past
//    E = 32), reads its target's degree and its group members' degrees at
//    once and compares them with the record's counts; enqueue positions
//    come from four bit-plane ballots (a scan past 15) in slot order.
//  - Prefetch ahead of the chain: at the start of a visit the warp copies,
//    with cp.async, the records of the node's first four neighbours (the
//    nodes it most likely visits next) into a cache of records in shared
//    memory, keyed by node; the copies land while it works on this node.
//    The queue rarely holds more than a node or two past the one visited
//    (the headline graph is nearly a chain; phase D of chip_smoke.py prints
//    the look-ahead), so a helper warp prefetching the queue's known
//    entries has little to run ahead on, and on the card its handoff cost
//    more than it hid. A visit reads its node from the queue and pass 3
//    its neighbour's remain in device memory: shared-memory copies of
//    either saved at most 1 % of K1's time at the headline's final graph.
//
// Traps (each has a test in tests/test_torch_edge_sort.py or, for S1's
// in-place launch, tests/test_torch_finish_fusion.py):
//  - S1 skips the rows past node_n, where the JAX step sorts every row: the
//    fused loop keeps their counts at 0, and a caller without a node_n
//    (`edge_sort`, K1's pass 2) gets all N rows sorted;
//  - a read whose fusion reports an error runs again from the state's graph,
//    so S1's in-place launch must not touch storage that graph holds
//    (`fused_loop._finish_fusion` raises on a shared storage);
//  - pass 1 walks the slots in the order given, not the sorted order (the
//    fused loop hands K1 sorted slots, a general caller may not);
//  - the group check of slot k reads the degrees as they are after slot k's
//    decrement: a group member that is a later out slot of the same node has
//    not been decremented yet, so a member's count covers the slots up to k
//    only;
//  - a node can be queued twice (on its own and as a group member), so the
//    queue can pass N: writes are capped at N, `head < node_n` ends the walk
//    and ok = (head == node_n). The reverse queue holds at most N + 1 entries
//    (the sink can come back once), so it never drops one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSrc = 0, kSink = 1;
constexpr int kBfsThreads = 1024;  // the BFS block: all initialise, 1 walks
constexpr int kPrefetch = 32;      // words of a neighbour's record prefetched
constexpr int kNeighbours = 4;     // neighbours prefetched a visit (8 lanes each)

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------- S1 ----

// the sort of one row (abpoa_graph.c:192-219), slot j's
// entry held in registers through its pass
__device__ void exchange_sort(int* ids, int* w, int cnt) {
  for (int j = 0; j + 1 < cnt; ++j) {
    int cw = w[j], ci = ids[j];
    for (int k = j + 1; k < cnt; ++k)
      if (cw < w[k]) {
        const int tw = w[k], ti = ids[k];
        w[k] = cw;
        ids[k] = ci;
        cw = tw;
        ci = ti;
      }
    w[j] = cw;
    ids[j] = ci;
  }
}

// Whether the exchange sort moves the row: some weight among its first cnt
// is larger than the one before it. VEC: 16-byte loads (E a multiple of 4,
// the row 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ bool row_moves(const int* w, int cnt) {
  int prev = 0x7fffffff;
  if constexpr (VEC) {
    for (int q = 0; q < cnt; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(w + q);
      const int a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q + i < cnt && a[i] > prev) return true;
        prev = a[i];
      }
    }
  } else {
    for (int k = 0; k < cnt; ++k) {
      if (w[k] > prev) return true;
      prev = w[k];
    }
  }
  return false;
}

// One thread a row (blockIdx.y: 0 = in, 1 = out), in place; node_n null:
// all N rows; n_span null: no span update. blockIdx.z picks the lane (of
// `lanes`, or lane blockIdx.z when null): its rows sit N rows a lane apart,
// its node_n is entry lane.
template <bool VEC>
__global__ void finish_fusion_kernel(
    int* __restrict__ in_ids, int* __restrict__ in_w, int* __restrict__ out_ids,
    int* __restrict__ out_w, const int* __restrict__ in_cnt,
    const int* __restrict__ out_cnt, const int* __restrict__ node_n,
    int* __restrict__ n_span, int N, int E, const int* __restrict__ lanes) {
  extern __shared__ int smem[];
  const int lane = lanes ? lanes[blockIdx.z] : (int)blockIdx.z;
  const size_t lr = (size_t)lane * N, le = lr * E;
  in_ids += le;
  in_w += le;
  out_ids += le;
  out_w += le;
  in_cnt += lr;
  out_cnt += lr;
  if (n_span) n_span += lr;
  const int n = node_n ? max(0, min(node_n[lane], N)) : N;
  const int r0 = blockIdx.x * blockDim.x;
  if (r0 >= n) return;  // every row of the block lies past node_n
  const bool out = blockIdx.y == 1;
  const int r = r0 + threadIdx.x;
  const bool live = r < n;
  if (!out && n_span && live) n_span[r] += 1;
  int* ids = out ? out_ids : in_ids;
  int* w = out ? out_w : in_w;
  const int cnt = live ? min((out ? out_cnt : in_cnt)[r], E) : 0;
  const bool moves = cnt >= 2 && row_moves<VEC>(w + (size_t)r * E, cnt);
  if (!moves) return;
  const int stride = E + 1;
  int* r_ids = smem + threadIdx.x * stride;
  int* r_w = smem + (blockDim.x + threadIdx.x) * stride;
  int* g_ids = ids + (size_t)r * E;
  int* g_w = w + (size_t)r * E;
  for (int k = 0; k < cnt; ++k) {
    r_ids[k] = g_ids[k];
    r_w[k] = g_w[k];
  }
  exchange_sort(r_ids, r_w, cnt);
  for (int k = 0; k < cnt; ++k) {
    g_ids[k] = r_ids[k];
    g_w[k] = r_w[k];
  }
}

// rows a block and its dynamic shared memory: up to 128 rows, fewer (down
// to 32) while 2 x rows x (E + 1) ints pass 48 KB
int s1_rows(int E) {
  int rows = 128;
  while (rows > 32 && 2 * rows * (E + 1) * 4 > 48 * 1024) rows /= 2;
  return rows;
}

template <bool VEC>
cudaError_t launch_ff(int* in_ids, int* in_w, int* out_ids, int* out_w,
                      const int* in_cnt, const int* out_cnt,
                      const int* node_n, int* n_span, int N, int E,
                      const int* lanes, int nl, cudaStream_t stream) {
  const int rows = s1_rows(E);
  const size_t smem = (size_t)2 * rows * (E + 1) * sizeof(int);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kern = finish_fusion_kernel<VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + rows - 1) / rows, 2, nl);
  kern<<<grid, rows, smem, stream>>>(in_ids, in_w, out_ids, out_w, in_cnt,
                                     out_cnt, node_n, n_span, N, E, lanes);
  return cudaGetLastError();
}

cudaError_t launch_finish_fusion(int* in_ids, int* in_w, int* out_ids,
                                 int* out_w, const int* in_cnt,
                                 const int* out_cnt, const int* node_n,
                                 int* n_span, int N, int E, const int* lanes,
                                 int nl, cudaStream_t stream) {
  if (nl < 1 || nl > 65535) return cudaErrorInvalidValue;
  const bool vec = E % 4 == 0 &&
                   (((uintptr_t)in_w | (uintptr_t)out_w) & 15) == 0;
  return vec ? launch_ff<true>(in_ids, in_w, out_ids, out_w, in_cnt, out_cnt,
                               node_n, n_span, N, E, lanes, nl, stream)
             : launch_ff<false>(in_ids, in_w, out_ids, out_w, in_cnt,
                                out_cnt, node_n, n_span, N, E, lanes, nl,
                                stream);
}

// ---------------------------------------------------------------- K1 ----

struct BfsArgs {
  const int* out_ids;      // pass 1: the slots as given
  const int* out_cnt;
  const int* in_cnt;
  const int* aligned;
  const int* aligned_cnt;
  const int* s_in_ids;     // pass 3: the sorted slots (S1's outputs)
  const int* s_out_ids;
  int* rec1;               // the nodes' records (records_kernel), rows
  int* rec3;               //   below node_n
  const int* node_n;
  int* i2n;                // also pass 1's queue
  int* n2i;
  int* remain;
  int* ok;
  int* rqueue;             // pass 3's queue, N + 1 entries
  int* deg_global;         // the int32 instantiation's degrees, N entries
  int N, E, A, C, S1, S3, walks;
};

// A node's record holds all a visit reads, packed from its start; records
// are S1 (pass 1) and S3 (pass 3) ints apart, multiples of 4. Word 0 is
// cnt | len << 16 (len = the words used). Counts are clamped to E and A.
//   pass 1: for each out slot k (as given), t_k and
//             na | upto << 7 | all << 13 | moff << 19,
//           then the members of each target's aligned group as
//             member | dec << 25;
//   pass 3: the sorted out slot 0, then for each sorted in slot k, t_k and
//             upto | all << 6.
// Within each chunk of 32 slots, upto = the slots up to k naming t_k (the
// decrements t_k has had at slot k), all = the chunk's slots naming it, and
// a member's dec = the slots up to k naming that member; na is the target's
// group size and moff the offset of its members after the slot table (up
// to 8191 words: from 4096 it sets the sign bit, so it is read unsigned).
// These are what a warp would otherwise count with shuffles at each visit.
__device__ void build_record(const BfsArgs& a, bool kahn, int v, int* dst) {
  const int E = a.E, A = a.A;
  const int cnt = min(max(kahn ? a.out_cnt[v] : a.in_cnt[v], 0), E);
  const int* ids = (kahn ? a.out_ids : a.s_in_ids) + (size_t)v * E;
  const int hdr = kahn ? 1 : 2, tab = hdr + 2 * cnt;
  int len = tab;
  if (!kahn) dst[1] = a.s_out_ids[(size_t)v * E];
  for (int k = 0; k < cnt; ++k) {
    const int t = ids[k], c0 = k & ~31, c1 = min(c0 + 32, cnt);
    int upto = 0, all = 0;
    for (int j = c0; j < c1; ++j) {
      all += ids[j] == t;
      upto += ids[j] == t && j <= k;
    }
    dst[hdr + 2 * k] = t;
    if (!kahn) {
      dst[hdr + 2 * k + 1] = upto | all << 6;
      continue;
    }
    const int na = min(max(a.aligned_cnt[t], 0), A);
    dst[hdr + 2 * k + 1] = na | upto << 7 | all << 13 | (len - tab) << 19;
    for (int m = 0; m < na; ++m) {
      const int mbr = a.aligned[(size_t)t * A + m];
      int dec = 0;
      for (int j = c0; j <= k; ++j) dec += ids[j] == mbr;
      dst[len++] = mbr | dec << 25;
    }
  }
  dst[0] = cnt | len << 16;
}

// The arguments of lane `lane` (rows N a lane apart in the inputs and in
// i2n, n2i, remain; node_n and ok entry lane), the j-th lane of the launch
// (its records and scratch at position j).
__device__ BfsArgs lane_args(const BfsArgs& g, const int* lanes, int j) {
  const int lane = lanes ? lanes[j] : j;
  const size_t r = (size_t)lane * g.N, e = r * g.E;
  BfsArgs a = g;
  a.out_ids += e;
  a.s_in_ids += e;
  a.s_out_ids += e;
  a.out_cnt += r;
  a.in_cnt += r;
  a.aligned += r * g.A;
  a.aligned_cnt += r;
  a.rec1 += (size_t)j * g.N * (g.S1 + g.S3);
  a.rec3 += (size_t)j * g.N * (g.S1 + g.S3);
  a.node_n += lane;
  a.i2n += r;
  a.n2i += r;
  a.remain += r;
  a.ok += lane;
  a.rqueue += (size_t)j * (2 * g.N + 1);
  a.deg_global += (size_t)j * (2 * g.N + 1);
  return a;
}

// writes the records of the nodes below node_n, for the walks asked; the
// launch's lane j is blockIdx.y
__global__ void records_kernel(BfsArgs g, const int* __restrict__ lanes) {
  const BfsArgs a = lane_args(g, lanes, blockIdx.y);
  const int n = min(a.node_n[0], a.N);
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += gridDim.x * blockDim.x) {
    if (a.walks & 1) build_record(a, true, v, a.rec1 + (size_t)v * a.S1);
    if (a.walks & 2) build_record(a, false, v, a.rec3 + (size_t)v * a.S3);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// the degree array: int8 in shared memory or int32 in device memory;
// set() saturates at the type's minimum
template <typename DegT>
struct Degrees {
  DegT* p;
  __device__ int get(int v) const { return (int)p[v]; }
  __device__ void set(int v, int x) const {
    p[v] = (DegT)max(x, sizeof(DegT) == 1 ? -128 : INT32_MIN);
  }
};

// The walking warp's shared memory: a cache of C node records (slot
// v & (C - 1)), tag = the node whose record the slot holds or is receiving.
// Only that warp reads or writes it, so it needs no synchronisation beyond
// __syncwarp and its own cp.async waits: every copy issued in a visit lands
// before the next visit starts, and within a visit only the visited node's
// slot (`keep`) is read and never written.
struct Walk {
  bool kahn;
  const int* recs;
  int* rec;
  int* tag;
  int n, C, S, Sv, keep;

  __device__ int slot(int v) const { return v & (C - 1); }

  // The start of visit h: every copy issued so far lands; the visited
  // node's record is copied now if it is missing (built here for a node at
  // or past node_n, which only an invalid graph reaches) or longer than the
  // prefetched kPrefetch words; then the first kPrefetch words of the
  // records of its first kNeighbours neighbours (the nodes the walk visits
  // next) are requested, one 16-byte cp.async a lane, while the warp works
  // on this one. Returns the node and its record.
  __device__ const int* begin(const BfsArgs& a, const int* queue, int h,
                              int* cur_out) {
    const int lane = threadIdx.x & 31;
    const int cur = queue[h];
    const int s = slot(cur);
    int* r = rec + (size_t)s * S;
    cp_async_commit_wait();
    __syncwarp();
    if (tag[s] != cur || (r[0] >> 16) > kPrefetch) {
      if (cur < n) {
        const int* src = recs + (size_t)cur * Sv;
        for (int c = lane * 4; c < Sv; c += 128) cp_async16(r + c, src + c);
        cp_async_commit_wait();
      } else if (lane == 0) {
        build_record(a, kahn, cur, r);
      }
      __syncwarp();
      if (lane == 0) tag[s] = cur;
      __syncwarp();
    }
    keep = s;
    const int cnt = r[0] & 0xffff, hdr = kahn ? 1 : 2;
    const int t = lane < min(cnt, kNeighbours) ? r[hdr + 2 * lane] : -1;
    const int ts = t >= 0 ? slot(t) : -1 - lane;
    // one copy a slot: a neighbour whose slot a lower one takes waits for
    // its own visit (or a later prefetch)
    bool need = t >= 0 && t < n && ts != keep;
#pragma unroll
    for (int j = 0; j < kNeighbours - 1; ++j) {
      const int tj = __shfl_sync(kFull, ts, j);
      need = need && !(j < lane && tj == ts);
    }
    const int c = lane >> 3, w = (lane & 7) * 4;
    const int tc = __shfl_sync(kFull, t, c);
    if (__shfl_sync(kFull, need, c) && w < Sv)
      cp_async16(rec + (size_t)slot(tc) * S + w, recs + (size_t)tc * Sv + w);
    if (need) tag[ts] = t;
    __syncwarp();
    *cur_out = cur;
    return r;
  }
};

// exclusive prefix (in lane order) and total of sz over the warp
__device__ __forceinline__ void warp_offsets(int sz, int* excl, int* total) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (kFull >> (31 - lane)) >> 1;
  if (__any_sync(kFull, sz > 15)) {
    int incl = sz;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    *excl = incl - sz;
    *total = __shfl_sync(kFull, incl, 31);
    return;
  }
  int e = 0, t = 0;
  for (int b = 0; b < 4; ++b) {
    const unsigned m = __ballot_sync(kFull, (sz >> b) & 1);
    e += __popc(m & lt) << b;
    t += __popc(m) << b;
  }
  *excl = e;
  *total = t;
}

// pass 1: the Kahn BFS with aligned-group atomicity, one warp a visit
template <typename DegT>
__device__ void walk_kahn(const BfsArgs& a, Walk& wk, Degrees<DegT> deg,
                          int n, int* head_out, int* tail_out) {
  const int lane = threadIdx.x & 31, N = a.N;
  int head = 0, tail = 1;
  while (head < tail && head < n) {
    const int h = head;
    int cur;
    const int* ent = wk.begin(a, a.i2n, h, &cur);
    if (lane == 0) a.n2i[cur] = h;
    head = h + 1;
    if (cur == kSink) continue;
    const int nout = ent[0] & 0xffff, tab = 1 + 2 * nout;
    for (int c0 = 0; c0 < nout; c0 += 32) {
      const int k = c0 + lane;
      const bool act = k < nout;
      const int t = act ? ent[1 + 2 * k] : 0;
      const int meta = act ? ent[2 + 2 * k] : 0;
      const int na = meta & 0x7f, upto = (meta >> 7) & 0x3f,
                all = (meta >> 13) & 0x3f;
      const int* grp = ent + tab + ((unsigned)meta >> 19);
      const int d0 = act ? deg.get(t) : 1;
      bool ready = act && d0 == upto;
      // the group check with the degrees as they are after slot k: each
      // member's degree less the slots up to k that name it
#pragma unroll 4
      for (int m = 0; m < (ready ? na : 0); ++m) {
        const int w = grp[m];
        ready = ready && deg.get(w & 0x1ffffff) == (w >> 25);
      }
      __syncwarp();
      if (act && upto == all) deg.set(t, d0 - all);
      // enqueue in slot order: the target, then its group
      int excl, total;
      warp_offsets(ready ? 1 + na : 0, &excl, &total);
      if (ready) {
        const int p = tail + excl;
        if (p < N) a.i2n[p] = t;
        for (int m = 0; m < na; ++m)
          if (p + 1 + m < N) a.i2n[p + 1 + m] = grp[m] & 0x1ffffff;
      }
      tail += total;
      __syncwarp();
    }
  }
  *head_out = head;
  *tail_out = tail;
}

// pass 3: the reverse BFS from the sink for max_remain
template <typename DegT>
__device__ void walk_remain(const BfsArgs& a, Walk& wk, Degrees<DegT> deg) {
  const int lane = threadIdx.x & 31, cap = a.N + 1;
  const unsigned lt = (kFull >> (31 - lane)) >> 1;
  int head = 0, tail = 1;
  // the queue holds at most N + 1 entries (each node once, the sink twice)
  while (head < tail && head < cap) {
    const int h = head;
    int cur;
    const int* ent = wk.begin(a, a.rqueue, h, &cur);
    head = h + 1;
    if (cur != kSink) {
      const int r = a.remain[ent[1]] + 1;
      __syncwarp();
      if (lane == 0) a.remain[cur] = r;
    }
    if (cur == kSrc) continue;
    const int nin = ent[0] & 0xffff;
    for (int c0 = 0; c0 < nin; c0 += 32) {
      const int k = c0 + lane;
      const bool act = k < nin;
      const int t = act ? ent[2 + 2 * k] : 0;
      const int meta = act ? ent[3 + 2 * k] : 0;
      const int upto = meta & 0x3f, all = meta >> 6;
      const int d0 = act ? deg.get(t) : 1;
      const bool ready = act && d0 == upto;
      __syncwarp();
      if (act && upto == all) deg.set(t, d0 - all);
      const unsigned rb = __ballot_sync(kFull, ready);
      const int p = tail + __popc(rb & lt);
      if (ready && p < cap) a.rqueue[p] = t;
      tail += __popc(rb);
      __syncwarp();
    }
  }
}

// one block of kBfsThreads: all threads initialise, warp 0 walks. Dynamic
// shared memory: the record cache and its tags and (the shared
// instantiation) the degrees.
template <typename DegT, bool kSharedDeg>
__global__ void __launch_bounds__(kBfsThreads)
    topo_bfs_kernel(BfsArgs g, const int* __restrict__ lanes) {
  extern __shared__ int4 smem4[];
  const BfsArgs a = lane_args(g, lanes, blockIdx.x);
  __shared__ int walk_end[2];
  int* smem = (int*)smem4;
  const int tid = threadIdx.x, N = a.N;
  Walk wk;
  wk.n = min(a.node_n[0], N);
  wk.C = a.C;
  wk.S = a.S1;
  wk.rec = smem;
  wk.tag = wk.rec + (size_t)a.C * a.S1;
  Degrees<DegT> deg{kSharedDeg ? (DegT*)(wk.tag + a.C) : (DegT*)a.deg_global};
  const int n = min(a.node_n[0], N);

  // ---- pass 1 set-up: zeroed outputs, in-degrees, an empty cache
  for (int k = tid; k < N; k += kBfsThreads) {
    a.i2n[k] = 0;
    a.n2i[k] = 0;
    a.remain[k] = 0;
    deg.set(k, a.in_cnt[k]);
  }
  for (int k = tid; k < a.C; k += kBfsThreads) wk.tag[k] = -1;
  if (tid == 0) {
    walk_end[0] = 0;
    walk_end[1] = 1;
  }
  __syncthreads();
  if (tid == 0) a.i2n[0] = kSrc;
  __syncthreads();
  if ((a.walks & 1) && tid < 32) {
    wk.kahn = true;
    wk.recs = a.rec1;
    wk.Sv = a.S1;
    int head, tail;
    walk_kahn<DegT>(a, wk, deg, n, &head, &tail);
    if (tid == 0) {
      a.ok[0] = head == n ? 1 : 0;
      walk_end[0] = head;
      walk_end[1] = tail;
    }
  }
  __syncthreads();

  // ---- pass 3 set-up: queue entries past the walk zeroed (i2n holds only
  // visited nodes), out-degrees, an empty cache
  const int h_end = walk_end[0], t_end = min(walk_end[1], N);
  for (int k = h_end + tid; k < t_end; k += kBfsThreads) a.i2n[k] = 0;
  for (int k = tid; k < N; k += kBfsThreads) deg.set(k, a.out_cnt[k]);
  for (int k = tid; k < a.C; k += kBfsThreads) wk.tag[k] = -1;
  __syncthreads();
  if (tid == 0) {
    a.rqueue[0] = kSink;
    a.remain[kSink] = -1;
  }
  __syncthreads();
  if ((a.walks & 2) && tid < 32) {
    wk.kahn = false;
    wk.recs = a.rec3;
    wk.Sv = a.S3;
    walk_remain<DegT>(a, wk, deg);
  }
}

// the records' ints (multiples of 4, so records and cache slots stay
// 16-byte aligned); a cache slot holds pass 1's, the larger
int record1_ints(int E, int A) { return (1 + 2 * E + E * A + 3) / 4 * 4; }
int record3_ints(int E) { return (2 + 2 * E + 3) / 4 * 4; }

size_t bfs_smem(int N, int E, int A, int C, int deg_bytes) {
  const size_t ints = (size_t)C * (record1_ints(E, A) + 1);
  return (ints * sizeof(int) + 15) / 16 * 16 +
         ((size_t)N * deg_bytes + 15) / 16 * 16;
}

template <typename DegT, bool kSharedDeg>
cudaError_t launch_bfs(const BfsArgs& a, const int* lanes, int nl,
                       size_t smem, cudaStream_t stream) {
  auto kern = topo_bfs_kernel<DegT, kSharedDeg>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<nl, kBfsThreads, smem, stream>>>(a, lanes);
  return cudaGetLastError();
}

}  // namespace

// Launches S1 on `stream` over `nl` lanes, in place on the four slot
// arrays (lanes x N x E): the exchange sort of each lane's rows below its
// node_n entry (all N rows when node_n is null) and, when n_span is not
// null, n_span + 1 below node_n. `lanes` lists the lanes (null: lanes 0 ..
// nl - 1); one read set is lane 0. Returns a cudaError_t as an int (0 =
// launched).
extern "C" int abpoa_finish_fusion(void* in_ids, void* in_w, void* out_ids,
                                   void* out_w, const void* in_cnt,
                                   const void* out_cnt, const void* node_n,
                                   void* n_span, const void* lanes, int N,
                                   int E, int nl, void* stream) {
  if (N < 1 || E < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_finish_fusion(
      (int*)in_ids, (int*)in_w, (int*)out_ids, (int*)out_w,
      (const int*)in_cnt, (const int*)out_cnt, (const int*)node_n,
      (int*)n_span, N, E, (const int*)lanes, nl, (cudaStream_t)stream);
}

// Launches K1 on `stream` over `nl` lanes: S1 on copies of the slots in the
// sorted outputs (pass 2), the nodes' records into `rec` (N x
// (record1_ints(E, A) + record3_ints(E)) ints a lane of the launch: pass
// 1's, then pass 3's), then one BFS block a lane (passes 1 and 3). The
// inputs, the sorted slots and i2n, n2i, remain hold `L` lanes of N rows
// (node_n and ok one entry a lane); `lanes` lists the nl lanes to repair
// (null: lanes 0 .. nl - 1), and the launch's j-th lane takes entry j of
// rec and scratch (2N + 1 ints each). One read set is lane 0 of one.
// variant: 0 = int8 degrees in shared memory, 1 = int32 in device memory;
// C record cache slots (a power of two). walks: a mask of the BFS passes to
// run (1 = pass 1, 2 = pass 3); 3 is the function, the others exist only to
// time a walk alone. Returns a cudaError_t as an int.
extern "C" int abpoa_topo_sort(const void* in_ids, const void* in_w,
                               const void* out_ids, const void* out_w,
                               const void* in_cnt, const void* out_cnt,
                               const void* aligned, const void* aligned_cnt,
                               const void* node_n, void* s_in_ids,
                               void* s_in_w, void* s_out_ids, void* s_out_w,
                               void* i2n, void* n2i, void* remain, void* ok,
                               void* scratch, void* rec, const void* lanes,
                               int N, int E, int A, int variant, int C,
                               int walks, int L, int nl, void* stream) {
  // the records pack a node id in 25 bits, a group size in 7, a member
  // offset in 13 and their length in 16
  if (N < 2 || N > (1 << 25) || E < 1 || A < 1 || A > 127 || E * A > 8191 ||
      record1_ints(E, A) > 65535 || C < 2 || (C & (C - 1)) || variant < 0 ||
      variant > 1 || L < 1 || nl < 1 || nl > L || nl > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int S1 = record1_ints(E, A), S3 = record3_ints(E);
  // pass 2: the inputs copied into the sorted outputs, then S1 in place on
  // them over all N rows, no span
  const size_t slot_bytes = (size_t)L * N * E * sizeof(int);
  const void* src[4] = {in_ids, in_w, out_ids, out_w};
  void* dst[4] = {s_in_ids, s_in_w, s_out_ids, s_out_w};
  cudaError_t err;
  for (int i = 0; i < 4; ++i) {
    err = cudaMemcpyAsync(dst[i], src[i], slot_bytes,
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_finish_fusion((int*)s_in_ids, (int*)s_in_w, (int*)s_out_ids,
                             (int*)s_out_w, (const int*)in_cnt,
                             (const int*)out_cnt, nullptr, nullptr, N, E,
                             (const int*)lanes, nl, st);
  if (err != cudaSuccess) return (int)err;
  BfsArgs a;
  a.out_ids = (const int*)out_ids;
  a.out_cnt = (const int*)out_cnt;
  a.in_cnt = (const int*)in_cnt;
  a.aligned = (const int*)aligned;
  a.aligned_cnt = (const int*)aligned_cnt;
  a.s_in_ids = (const int*)s_in_ids;
  a.s_out_ids = (const int*)s_out_ids;
  a.rec1 = (int*)rec;
  a.rec3 = (int*)rec + (size_t)N * S1;
  a.node_n = (const int*)node_n;
  a.i2n = (int*)i2n;
  a.n2i = (int*)n2i;
  a.remain = (int*)remain;
  a.ok = (int*)ok;
  a.rqueue = (int*)scratch;
  a.deg_global = (int*)scratch + N + 1;
  a.N = N;
  a.E = E;
  a.A = A;
  a.C = C;
  a.S1 = S1;
  a.S3 = S3;
  a.walks = walks;
  if (walks & 3) {
    records_kernel<<<dim3((N + 127) / 128, nl), 128, 0, st>>>(
        a, (const int*)lanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = bfs_smem(N, E, A, C, variant == 0 ? 1 : 0);
  if (smem > 232448 - 16) return (int)cudaErrorInvalidValue;
  if (variant == 0)
    err = launch_bfs<int8_t, true>(a, (const int*)lanes, nl, smem, st);
  else
    err = launch_bfs<int, false>(a, (const int*)lanes, nl, smem, st);
  return (int)err;
}
