// The fused loop's Kahn repair of the topological order (K1), written for
// Hopper (sm_90a).
//
// Replaces: the XLA function abpoa_tpu/align/device_graph.py `topo_sort`
// (reference src/abpoa_graph.c:192-357), run when the spliced order of the
// fused loop is not a valid topological order. Three passes:
//   1. Kahn BFS from the source over the edge slots as given; a node is
//      queued only when its whole aligned group has in-degree 0, and its
//      group follows it (aligned-group atomicity);
//   2. abPOA's weight-descending exchange sort of every node's in and out
//      slots, with its unstable tie order;
//   3. reverse BFS from the sink: remain[v] = remain[heaviest out-edge
//      target] + 1 (slot 0 after the sort), -1 at the sink.
// The plain PyTorch version is `topo_sort_torch` in align/topo_kernel.py and
// must agree with this kernel exactly, so the port's state compares with the
// JAX state node for node.
//
// What bounds it: the two BFS passes visit up to ~60k nodes one after
// another, each visit a few dependent loads (degree, edge slots, group
// members), so they are latency bound on one thread; the sort is a few
// dozen operations per node. Bytes and operations are far below the card's
// bounds.
//
// What the design does about it: one block. Thread 0 runs the two BFS passes
// with the queue and degree counts in device memory (they do not fit in
// shared memory at 60k nodes); all threads copy, sort (one node each) and
// initialise between them, separated by __syncthreads().
#include <cuda_runtime.h>

namespace {

constexpr int kSrc = 0, kSink = 1;

__device__ void exchange_sort(int* ids, int* w, int cnt) {
  for (int j = 0; j < cnt; ++j)
    for (int k = j + 1; k < cnt; ++k)
      if (w[j] < w[k]) {
        const int tw = w[j], ti = ids[j];
        w[j] = w[k];
        ids[j] = ids[k];
        w[k] = tw;
        ids[k] = ti;
      }
}

__global__ void topo_sort_kernel(
    const int* __restrict__ in_ids, const int* __restrict__ in_w,
    const int* __restrict__ out_ids, const int* __restrict__ out_w,
    const int* __restrict__ in_cnt, const int* __restrict__ out_cnt,
    const int* __restrict__ aligned, const int* __restrict__ aligned_cnt,
    const int* __restrict__ node_n, int* s_in_ids, int* s_in_w,
    int* s_out_ids, int* s_out_w, int* i2n, int* n2i, int* remain, int* ok,
    int* degree, int* queue, int N, int E, int A) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n = node_n[0];

  // ---- copies, zeroed outputs, in-degrees
  for (int k = tid; k < N; k += nthreads) {
    degree[k] = in_cnt[k];
    i2n[k] = 0;
    n2i[k] = 0;
    remain[k] = 0;
  }
  for (size_t k = tid; k < (size_t)N * E; k += nthreads) {
    s_in_ids[k] = in_ids[k];
    s_in_w[k] = in_w[k];
    s_out_ids[k] = out_ids[k];
    s_out_w[k] = out_w[k];
  }
  __syncthreads();

  // ---- 1. Kahn BFS with aligned-group atomicity (device_graph.py:223-277)
  if (tid == 0) {
    int head = 0, tail = 1;
    queue[0] = kSrc;
    while (head < tail && head < n) {
      const int cur = queue[head];
      i2n[head] = cur;
      n2i[cur] = head;
      ++head;
      if (cur == kSink) continue;
      const int nout = out_cnt[cur];
      for (int k = 0; k < nout; ++k) {
        const int out_id = out_ids[(size_t)cur * E + k];
        const int deg = --degree[out_id];
        if (deg != 0) continue;
        const int* grp = aligned + (size_t)out_id * A;
        const int na = aligned_cnt[out_id];
        bool grp_ok = true;
        for (int a = 0; a < na && grp_ok; ++a) grp_ok = degree[grp[a]] == 0;
        if (!grp_ok) continue;
        if (tail < N) queue[tail] = out_id;
        ++tail;
        for (int a = 0; a < na; ++a) {
          if (tail < N) queue[tail] = grp[a];
          ++tail;
        }
      }
    }
    ok[0] = head == n ? 1 : 0;
  }
  __syncthreads();

  // ---- 2. exchange sort of every node's slots; out-degrees for pass 3
  for (int r = tid; r < N; r += nthreads) {
    exchange_sort(s_in_ids + (size_t)r * E, s_in_w + (size_t)r * E,
                  in_cnt[r]);
    exchange_sort(s_out_ids + (size_t)r * E, s_out_w + (size_t)r * E,
                  out_cnt[r]);
    degree[r] = out_cnt[r];
  }
  __syncthreads();

  // ---- 3. reverse BFS max_remain (device_graph.py:300-345)
  if (tid == 0) {
    remain[kSink] = -1;
    int head = 0, tail = 1;
    queue[0] = kSink;
    while (head < tail) {
      const int cur = queue[head++];
      if (cur != kSink)
        remain[cur] = remain[s_out_ids[(size_t)cur * E]] + 1;
      if (cur == kSrc) continue;
      const int nin = in_cnt[cur];
      for (int k = 0; k < nin; ++k) {
        const int in_id = s_in_ids[(size_t)cur * E + k];
        if (--degree[in_id] == 0) {
          if (tail < N) queue[tail] = in_id;
          ++tail;
        }
      }
      if (head >= N) break;
    }
  }
}

}  // namespace

// Launches the repair on `stream` and returns a cudaError_t as an int
// (0 = launched). scratch holds 2*N ints.
extern "C" int abpoa_topo_sort(const void* in_ids, const void* in_w,
                               const void* out_ids, const void* out_w,
                               const void* in_cnt, const void* out_cnt,
                               const void* aligned, const void* aligned_cnt,
                               const void* node_n, void* s_in_ids,
                               void* s_in_w, void* s_out_ids, void* s_out_w,
                               void* i2n, void* n2i, void* remain, void* ok,
                               void* scratch, int N, int E, int A,
                               void* stream) {
  if (N < 2 || E < 1 || A < 1) return (int)cudaErrorInvalidValue;
  int* s = (int*)scratch;
  topo_sort_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)in_ids, (const int*)in_w, (const int*)out_ids,
      (const int*)out_w, (const int*)in_cnt, (const int*)out_cnt,
      (const int*)aligned, (const int*)aligned_cnt, (const int*)node_n,
      (int*)s_in_ids, (int*)s_in_w, (int*)s_out_ids, (int*)s_out_w,
      (int*)i2n, (int*)n2i, (int*)remain, (int*)ok, s, s + N, N, E, A);
  return (int)cudaGetLastError();
}
