// The fused loop's sequential fusion of one read (F1), written for Hopper
// (sm_90a).
//
// Replaces: the XLA function abpoa_tpu/align/device_graph.py
// `fuse_alignment` (reference src/abpoa_graph.c:689-774,
// `abpoa_add_subgraph_alignment`), which the fused loop takes when two
// mismatch columns of a read touch one aligned-node group (a "collision"):
// the read's forward op stream is fused one op at a time, op 0 matching the
// node in its argument (reusing an aligned node of the query's base, or
// adding one to the group), op 2 inserting a new node, op 1 deleting. Edges
// are appended or reweighted in their slots (abpoa_graph.c:480-556), aligned
// groups register a new member mutually (:455-463). The plain version is
// `fuse_alignment_torch` in align/fuse_kernel.py, the walk of
// align/device_graph.py `fuse_alignment` lane by lane; the kernel must agree
// with it on every graph array, ok, node_n and the path.
//
// What bounds it: the op stream is one dependent chain (each op's edge
// starts at the node the op before it ended on, and a new node's id is the
// count the ops before it left), so its ~qlen ops run one after another. An
// op reads and writes a few slots of two rows: a few dozen bytes and
// integer operations, bound by the latency of its dependent loads, far from
// the card's bytes or operations bounds (PERF.md gives both).
//
// What the design does about it: one thread of one block a lane walks the
// stream in place on a fresh copy of the lane's graph (the wrapper makes the
// copy: a read that reports an error runs again from the state's graph), so
// nothing crosses to the host: n_fwd, the op stream and the query are read
// on the card, node_n, ok and the read's node path are written there. The
// lanes of a launch (K read sets of the device lockstep, or one) are
// independent, one block each, at a fixed stride in the stacked arrays.
#include <cuda_runtime.h>

namespace {

constexpr int kSrc = 0, kSink = 1;

struct FuseArgs {
  // the stacked graph (lanes x N rows), fused in place
  int *base, *in_ids, *in_w, *in_cnt, *out_ids, *out_w, *out_cnt, *aligned,
      *aligned_cnt, *n_read, *n_span, *node_n;
  unsigned char* ok;
  // a lane's op stream (T entries), its length, its query and weights (Q
  // entries) and read length
  const int *fwd_op, *fwd_arg, *n_fwd, *query, *weight, *qlen;
  int *path, *path_len;  // the read's node path (Pcap entries), its length
  const int* lanes;      // the lanes to fuse (null: lane = block)
  int N, E, A, T, Q, Pcap;
};

// One lane's graph, its rows at the lane's offset. A row past the capacity
// N (a node id the walk made after it passed N) is read as row N - 1 and
// written nowhere, as JAX clamps a gather and drops a scatter out of range;
// the run is already marked failed (ok false) and its graph is discarded.
struct Lane {
  int *base, *in_ids, *in_w, *in_cnt, *out_ids, *out_w, *out_cnt, *aligned,
      *aligned_cnt, *n_read, *n_span;
  int N, E, A, node_n;
  bool ok;

  __device__ int r(int row) const { return min(row, N - 1); }

  // append-or-reweight fr -> to (abpoa_graph.c:480-556); an out-of-range
  // slot writes nowhere, but the count still moves, as the plain walk
  __device__ void add_edge(int fr, int to, bool check, int w) {
    const int fr_r = r(fr), to_r = r(to);
    const int* o_ids = out_ids + (size_t)fr_r * E;
    const int* i_ids = in_ids + (size_t)to_r * E;
    int o_slot = out_cnt[fr_r];
    bool o_exists = false;
    if (check)
      for (int k = 0, c = min(out_cnt[fr_r], E); k < c; ++k)
        if (o_ids[k] == to) {
          o_slot = k;
          o_exists = true;
          break;
        }
    int i_slot = in_cnt[to_r];
    bool i_exists = false;
    if (check)
      for (int k = 0, c = min(in_cnt[to_r], E); k < c; ++k)
        if (i_ids[k] == fr) {
          i_slot = k;
          i_exists = true;
          break;
        }
    ok = ok && o_slot < E && i_slot < E;
    if (fr < N) {
      if (o_slot < E) {
        out_ids[(size_t)fr * E + o_slot] = to;
        int* ow = out_w + (size_t)fr * E + o_slot;
        *ow = o_exists ? *ow + w : w;
      }
      if (!o_exists) out_cnt[fr] += 1;
      n_read[fr] += 1;
    }
    if (to < N) {
      if (i_slot < E) {
        in_ids[(size_t)to * E + i_slot] = fr;
        int* iw = in_w + (size_t)to * E + i_slot;
        *iw = i_exists ? *iw + w : w;
      }
      if (!i_exists) in_cnt[to] += 1;
    }
  }

  __device__ int get_aligned_id(int v, int b) const {
    const int* ids = aligned + (size_t)r(v) * A;
    for (int k = 0, c = min(aligned_cnt[r(v)], A); k < c; ++k)
      if (base[r(ids[k])] == b) return ids[k];
    return -1;
  }

  __device__ void append_aligned(int row, int v) {
    if (row >= N) return;
    if (aligned_cnt[row] < A) aligned[(size_t)row * A + aligned_cnt[row]] = v;
    aligned_cnt[row] += 1;
  }

  // mutual registration across the mismatch group (abpoa_graph.c:455-463)
  __device__ void add_aligned(int v, int nid) {
    const int n0 = aligned_cnt[r(v)];
    for (int k = 0; k < n0; ++k) {
      const int ex = aligned[(size_t)r(v) * A + min(k, A - 1)];
      ok = ok && aligned_cnt[r(ex)] < A && aligned_cnt[r(nid)] < A;
      append_aligned(ex, nid);
      append_aligned(nid, ex);
    }
    ok = ok && aligned_cnt[r(v)] < A && aligned_cnt[r(nid)] < A;
    append_aligned(v, nid);
    append_aligned(nid, v);
  }

  // a new node of base b: its row zeroed (the plain walk appends a zero
  // row); past N only the count moves
  __device__ int new_node(int b) {
    const int nid = node_n;
    if (nid < N) {
      base[nid] = b;
      for (int k = 0; k < E; ++k) {
        in_ids[(size_t)nid * E + k] = 0;
        in_w[(size_t)nid * E + k] = 0;
        out_ids[(size_t)nid * E + k] = 0;
        out_w[(size_t)nid * E + k] = 0;
      }
      for (int k = 0; k < A; ++k) aligned[(size_t)nid * A + k] = 0;
      in_cnt[nid] = out_cnt[nid] = aligned_cnt[nid] = 0;
      n_read[nid] = n_span[nid] = 0;
    }
    ok = ok && nid < N;
    node_n += 1;
    return nid;
  }
};

__global__ void __launch_bounds__(32) fuse_alignment_kernel(FuseArgs a) {
  if (threadIdx.x != 0) return;
  const int l = a.lanes ? a.lanes[blockIdx.x] : blockIdx.x;
  const size_t rN = (size_t)l * a.N;
  Lane g;
  g.N = a.N;
  g.E = a.E;
  g.A = a.A;
  g.base = a.base + rN;
  g.in_ids = a.in_ids + rN * a.E;
  g.in_w = a.in_w + rN * a.E;
  g.out_ids = a.out_ids + rN * a.E;
  g.out_w = a.out_w + rN * a.E;
  g.aligned = a.aligned + rN * a.A;
  g.in_cnt = a.in_cnt + rN;
  g.out_cnt = a.out_cnt + rN;
  g.aligned_cnt = a.aligned_cnt + rN;
  g.n_read = a.n_read + rN;
  g.n_span = a.n_span + rN;
  g.node_n = a.node_n[l];
  g.ok = a.ok[l] != 0;
  const int* fop = a.fwd_op + (size_t)l * a.T;
  const int* farg = a.fwd_arg + (size_t)l * a.T;
  const int* q = a.query + (size_t)l * a.Q;
  const int* wt = a.weight + (size_t)l * a.Q;
  int* path = a.path + (size_t)l * a.Pcap;
  const int n = min(max(a.n_fwd[l], 0), a.T);
  int last = kSrc, last_new = 0, qpos = 0, plen = 0;
  for (int t = 0; t < n; ++t) {
    const int op = fop[t];
    if (op != 0 && op != 2) continue;  // a deletion consumes nothing
    const int qp = min(qpos, a.Q - 1);
    const int b = q[qp], w = wt[qp];
    const int arg = min(max(farg[t], 0), a.N - 1);
    if (op == 0 && g.base[arg] == b) {
      g.add_edge(last, arg, last_new == 0, w);
      last = arg;
      last_new = 0;
    } else {
      const int aln = op == 0 ? g.get_aligned_id(arg, b) : -1;
      if (aln >= 0) {
        g.add_edge(last, aln, last_new == 0, w);
        last = aln;
        last_new = 0;
      } else {
        const int nid = g.new_node(b);
        g.add_edge(last, nid, false, w);
        if (nid < a.N) g.n_span[nid] = g.n_span[g.r(last)];
        if (op == 0) g.add_aligned(arg, nid);
        last = nid;
        last_new = 1;
      }
    }
    ++qpos;
    if (plen < a.Pcap) path[plen] = last;
    ++plen;
  }
  g.add_edge(last, kSink, last_new == 0,
             wt[min(max(a.qlen[l] - 1, 0), a.Q - 1)]);
  a.node_n[l] = g.node_n;
  a.ok[l] = g.ok ? 1 : 0;
  a.path_len[l] = min(plen, a.Pcap);
}

}  // namespace

// Launches F1 on `stream` over `nl` lanes (`lanes`, a device list of lane
// indices, or null for lanes 0..nl-1), in place on the stacked graph:
// base, in_cnt, out_cnt, aligned_cnt, n_read, n_span (lanes x N), in_ids,
// in_w, out_ids, out_w (lanes x N x E), aligned (lanes x N x A), node_n
// (lanes) int32 and ok (lanes) bool. A lane's op stream fwd_op/fwd_arg
// (lanes x T), n_fwd (lanes), query/weight (lanes x Q) and qlen (lanes);
// path (lanes x Pcap, zeroed by the caller) and path_len (lanes) are
// written. Returns a cudaError_t as an int (0 = launched).
extern "C" int abpoa_fuse_alignment(
    void* base, void* in_ids, void* in_w, void* in_cnt, void* out_ids,
    void* out_w, void* out_cnt, void* aligned, void* aligned_cnt,
    void* n_read, void* n_span, void* node_n, void* ok, const void* fwd_op,
    const void* fwd_arg, const void* n_fwd, const void* query,
    const void* weight, const void* qlen, void* path, void* path_len,
    const void* lanes, int nl, int N, int E, int A, int T, int Q, int Pcap,
    void* stream) {
  if (nl < 1 || N < 2 || E < 1 || A < 1 || T < 1 || Q < 1 || Pcap < 1)
    return (int)cudaErrorInvalidValue;
  FuseArgs a{(int*)base,         (int*)in_ids,       (int*)in_w,
             (int*)in_cnt,       (int*)out_ids,      (int*)out_w,
             (int*)out_cnt,      (int*)aligned,      (int*)aligned_cnt,
             (int*)n_read,       (int*)n_span,       (int*)node_n,
             (unsigned char*)ok, (const int*)fwd_op, (const int*)fwd_arg,
             (const int*)n_fwd,  (const int*)query,  (const int*)weight,
             (const int*)qlen,   (int*)path,         (int*)path_len,
             (const int*)lanes,  N,                  E,
             A,                  T,                  Q,
             Pcap};
  fuse_alignment_kernel<<<nl, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
