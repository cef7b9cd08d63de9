// Native host core of the per-read and seeded routes: the mutable POA graph
// between two alignments, and the host DP engine (`--device native`, the rung
// the breaker demotes `--device cpu` to).
//
// Counterpart of abpoa_tpu/native/host_core.cpp (its graph core, its scalar
// banded DP and the heaviest-bundling consensus; the MSA ranks stay there, as
// the port runs its MSA in Python). What lives here: cigar fusion (abPOA
// src/abpoa_graph.c:689-774), BFS topological sort with aligned-group
// atomicity (:221-266), weight-descending edge sort (:192-219), reverse-BFS
// max_remain (:268-309), the padded predecessor/out-edge tables the banded DP
// kernel B2 reads (apg_build_tables), the band write-back, the subgraph
// closure, the single-cluster heaviest-bundling consensus (apg_cons_hb), the
// whole graph's export and import (apg_export, apg_get_band, apg_import), and
// the adaptive-banded sequence-to-graph DP with its backtrack (apg_align,
// apg_align_core: int16 plane storage while the score bound allows it, int32
// after or with ABPOA_TPU_NATIVE_I32).
//
// Exposed as a plain C ABI bound with ctypes (abpoa_tpu_torch/native).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

struct Node {
    uint8_t base = 0;
    std::vector<int32_t> in_ids, in_w;
    std::vector<int32_t> out_ids, out_w;
    std::vector<std::vector<uint64_t>> read_ids;  // bitset words per out edge
    std::vector<int32_t> aligned_ids;
    int32_t n_read = 0;
    int32_t n_span_read = 0;
    std::vector<int32_t> read_weight_ids, read_weight_vals;  // sparse qv weights
};

struct Graph {
    std::vector<Node> nodes;
    std::vector<int32_t> index_to_node_id, node_id_to_index;
    std::vector<int32_t> max_remain, mpl, mpr;
    bool sorted = false;
    // edge-sort dirty tracking: the per-read exchange sort is idempotent on
    // nodes whose edge arrays did not change, so re-sorting only the nodes a
    // fusion touched produces byte-identical arrays at a fraction of the
    // O(V * d^2) full pass (it dominated topo time on 100k-node graphs).
    // all_edges_dirty covers resets/restores and any node added before
    // tracking: new nodes mark themselves dirty in add_edge.
    std::vector<uint8_t> edge_dirty;
    bool all_edges_dirty = true;
    // persistent DP workspaces (reused across alignments, like the
    // reference's abpoa_simd_matrix_t); int16 twins back the 16-bit
    // plane-STORAGE mode (math stays int32; stores saturate low), selected
    // per alignment by the reference's score-width bound
    // (abpoa_align_simd.c:1284-1302)
    std::vector<int32_t> wsH, wsE1, wsE2, wsF1, wsF2;
    std::vector<int16_t> wsH16, wsE116, wsE216, wsF116, wsF216;
    std::vector<int32_t> ws_qprof;  // per-alignment query profile (m x qlen+1)
    std::vector<int32_t> ws_pre, ws_pre_off;  // flattened per-row pred lists
    std::vector<int32_t> ws_pre_ps;  // -G path score per pred slot (CSR twin)
    std::vector<uint8_t> ws_index_map;
    std::vector<int32_t> ws_queue, ws_degree;  // BFS scratch (topo sort)
    std::vector<int64_t> ws_row_ptr;
    std::vector<int32_t> ws_beg, ws_end;

    Graph() { reset(); }
    void reset() {
        nodes.clear();
        nodes.resize(2);
        sorted = false;
        edge_dirty.clear();
        all_edges_dirty = true;
    }
    int n() const { return (int)nodes.size(); }
    void mark_edge_dirty(int id) {
        if (all_edges_dirty) return;
        if ((int)edge_dirty.size() <= id) edge_dirty.resize(id + 1, 1);
        else edge_dirty[id] = 1;
    }
};

const int SRC = 0, SINK = 1;
const uint64_t OP_MASK = 0xF;
enum { CMATCH = 0, CINS = 1, CDEL = 2, CDIFF = 3, CSOFT = 4, CHARD = 5 };

int add_node(Graph& g, uint8_t base) {
    g.nodes.emplace_back();
    g.nodes.back().base = base;
    return g.n() - 1;
}

void set_read_weight(Node& node, int read_id, int w) {
    for (size_t i = 0; i < node.read_weight_ids.size(); ++i)
        if (node.read_weight_ids[i] == read_id) { node.read_weight_vals[i] = w; return; }
    node.read_weight_ids.push_back(read_id);
    node.read_weight_vals.push_back(w);
}

void add_edge(Graph& g, int from_id, int to_id, bool check_edge, int w,
              bool add_read_id, bool add_read_weight, int read_id,
              int read_ids_n) {
    g.mark_edge_dirty(from_id);
    g.mark_edge_dirty(to_id);
    Node& fr = g.nodes[from_id];
    Node& to = g.nodes[to_id];
    int out_edge_i = -1;
    if (check_edge) {
        for (size_t i = 0; i < to.in_ids.size(); ++i)
            if (to.in_ids[i] == from_id) { to.in_w[i] += w; break; }
        for (size_t i = 0; i < fr.out_ids.size(); ++i)
            if (fr.out_ids[i] == to_id) { fr.out_w[i] += w; out_edge_i = (int)i; break; }
    }
    if (out_edge_i < 0) {
        to.in_ids.push_back(from_id);
        to.in_w.push_back(w);
        fr.out_ids.push_back(to_id);
        fr.out_w.push_back(w);
        fr.read_ids.emplace_back();
        out_edge_i = (int)fr.out_ids.size() - 1;
    }
    if (add_read_id) {
        auto& bits = fr.read_ids[out_edge_i];
        if ((int)bits.size() < read_ids_n) bits.resize(read_ids_n, 0);
        bits[read_id >> 6] |= 1ULL << (read_id & 63);
    }
    fr.n_read += 1;
    if (add_read_weight) set_read_weight(fr, read_id, w);
}

int get_aligned_id(Graph& g, int node_id, uint8_t base) {
    for (int aid : g.nodes[node_id].aligned_ids)
        if (g.nodes[aid].base == base) return aid;
    return -1;
}

void add_aligned_node(Graph& g, int node_id, int aligned_id) {
    Node& node = g.nodes[node_id];
    for (int ex : node.aligned_ids) {
        g.nodes[ex].aligned_ids.push_back(aligned_id);
        g.nodes[aligned_id].aligned_ids.push_back(ex);
    }
    node.aligned_ids.push_back(aligned_id);
    g.nodes[aligned_id].aligned_ids.push_back(node_id);
}

// exact replication of the reference's exchange sort (ties depend on it)
void sort_node_edges(Node& node) {
    int n = (int)node.in_ids.size();
    for (int j = 0; j < n - 1; ++j)
        for (int k = j + 1; k < n; ++k)
            if (node.in_w[j] < node.in_w[k]) {
                std::swap(node.in_ids[j], node.in_ids[k]);
                std::swap(node.in_w[j], node.in_w[k]);
            }
    n = (int)node.out_ids.size();
    for (int j = 0; j < n - 1; ++j)
        for (int k = j + 1; k < n; ++k)
            if (node.out_w[j] < node.out_w[k]) {
                std::swap(node.out_ids[j], node.out_ids[k]);
                std::swap(node.out_w[j], node.out_w[k]);
                std::swap(node.read_ids[j], node.read_ids[k]);
            }
}

void sort_in_out_ids(Graph& g) {
    if (!g.all_edges_dirty) {
        const int lim = std::min((int)g.edge_dirty.size(), g.n());
        for (int i = 0; i < lim; ++i)
            if (g.edge_dirty[i]) {
                sort_node_edges(g.nodes[i]);
                g.edge_dirty[i] = 0;
            }
        // nodes beyond edge_dirty.size() were never touched since tracking
        // began (mark_edge_dirty extends the vector on first touch)
        return;
    }
    for (auto& node : g.nodes) sort_node_edges(node);
    g.edge_dirty.assign(g.n(), 0);
    g.all_edges_dirty = false;
}

bool bfs_set_node_index(Graph& g) {
    // flat FIFO over a persistent workspace (identical order to the former
    // std::deque; every node is enqueued at most once so n slots suffice)
    int n = g.n();
    g.index_to_node_id.assign(n, 0);
    g.node_id_to_index.assign(n, 0);
    std::vector<int32_t>& in_degree = g.ws_degree;
    in_degree.resize(n);
    for (int i = 0; i < n; ++i) in_degree[i] = (int)g.nodes[i].in_ids.size();
    std::vector<int32_t>& q = g.ws_queue;
    if ((int)q.size() < n) q.resize(n);
    int head = 0, tail = 0;
    q[tail++] = SRC;
    int index = 0;
    while (head < tail) {
        int cur = q[head++];
        g.index_to_node_id[index] = cur;
        g.node_id_to_index[cur] = index++;
        if (cur == SINK) return true;
        for (int out_id : g.nodes[cur].out_ids) {
            if (--in_degree[out_id] == 0) {
                bool ok = true;
                for (int a : g.nodes[out_id].aligned_ids)
                    if (in_degree[a] != 0) { ok = false; break; }
                if (!ok) continue;
                q[tail++] = out_id;
                for (int a : g.nodes[out_id].aligned_ids) q[tail++] = a;
            }
        }
    }
    return false;
}

bool bfs_set_node_remain(Graph& g) {
    int n = g.n();
    g.max_remain.assign(n, 0);
    std::vector<int32_t>& out_degree = g.ws_degree;
    out_degree.resize(n);
    for (int i = 0; i < n; ++i) out_degree[i] = (int)g.nodes[i].out_ids.size();
    std::vector<int32_t>& q = g.ws_queue;
    if ((int)q.size() < n) q.resize(n);
    int head = 0, tail = 0;
    q[tail++] = SINK;
    g.max_remain[SINK] = -1;
    while (head < tail) {
        int cur = q[head++];
        Node& node = g.nodes[cur];
        if (cur != SINK) {
            int max_w = -1, max_id = -1;
            for (size_t i = 0; i < node.out_ids.size(); ++i)
                if (node.out_w[i] > max_w) { max_w = node.out_w[i]; max_id = node.out_ids[i]; }
            g.max_remain[cur] = g.max_remain[max_id] + 1;
        }
        if (cur == SRC) return true;
        for (int in_id : node.in_ids)
            if (--out_degree[in_id] == 0) q[tail++] = in_id;
    }
    return false;
}

void topological_sort(Graph& g, bool banded, bool zdrop) {
    bfs_set_node_index(g);
    sort_in_out_ids(g);
    if (banded) {
        int n = g.n();
        g.mpr.assign(n, 0);
        g.mpl.assign(n, n);
        bfs_set_node_remain(g);
    } else if (zdrop) {
        bfs_set_node_remain(g);
    }
    g.sorted = true;
}

void update_n_span(Graph& g, int beg_id, int end_id, bool inc_both_ends) {
    int src_index = g.node_id_to_index[beg_id];
    int sink_index = g.node_id_to_index[end_id];
    for (int i = src_index + 1; i < sink_index; ++i)
        g.nodes[g.index_to_node_id[i]].n_span_read += 1;
    if (inc_both_ends) {
        g.nodes[beg_id].n_span_read += 1;
        g.nodes[end_id].n_span_read += 1;
    }
}

}  // namespace

extern "C" {

void* apg_create() { return new Graph(); }
void apg_destroy(void* h) { delete (Graph*)h; }
void apg_reset(void* h) { ((Graph*)h)->reset(); }
int apg_node_n(void* h) { return ((Graph*)h)->n(); }
int apg_is_sorted(void* h) { return ((Graph*)h)->sorted ? 1 : 0; }

void apg_topological_sort(void* h, int banded, int zdrop) {
    topological_sort(*(Graph*)h, banded != 0, zdrop != 0);
}

// Fuse one alignment (or seed an empty graph). Returns 0 on success.
int apg_add_alignment(void* h, int beg_node_id, int end_node_id,
                      const uint8_t* seq, const int64_t* weight, int seq_l,
                      const uint64_t* cigar, int n_cigar,
                      int read_id, int tot_read_n,
                      int use_read_ids, int add_read_weight, int inc_both_ends,
                      int banded, int zdrop,
                      int64_t* qpos_to_node_id) {
    Graph& g = *(Graph*)h;
    int read_ids_n = 1 + ((tot_read_n - 1) >> 6);
    bool arid = use_read_ids != 0, arw = add_read_weight != 0;
    if (g.n() == 2) {  // empty graph: seed a chain (abpoa_graph.c:573-593)
        if (seq_l <= 0) return 0;
        int last_id = SRC;
        for (int i = 0; i < seq_l; ++i) {
            int cur = add_node(g, seq[i]);
            if (qpos_to_node_id) qpos_to_node_id[i] = cur;
            add_edge(g, last_id, cur, false, (int)weight[i], arid, arw, read_id, read_ids_n);
            g.nodes[cur].n_span_read = g.nodes[last_id].n_span_read;
            last_id = cur;
        }
        add_edge(g, last_id, SINK, false, (int)weight[seq_l - 1], arid, arw, read_id, read_ids_n);
        topological_sort(g, banded != 0, zdrop != 0);
        update_n_span(g, SRC, SINK, true);
        return 0;
    }
    if (n_cigar == 0) return 0;
    int query_id = -1;
    bool last_new = false;
    int last_id = beg_node_id;
    for (int c = 0; c < n_cigar; ++c) {
        uint64_t p = cigar[c];
        int op = (int)(p & OP_MASK);
        if (op == CMATCH) {
            int node_id = (int)((p >> 34) & 0x3FFFFFFF);
            query_id++;
            uint8_t b = seq[query_id];
            bool add = (last_id != beg_node_id) || inc_both_ends;
            if (g.nodes[node_id].base != b) {  // mismatch
                int aligned_id = get_aligned_id(g, node_id, b);
                if (aligned_id != -1) {
                    add_edge(g, last_id, aligned_id, !last_new, (int)weight[query_id],
                             arid && add, arw, read_id, read_ids_n);
                    if (!add) g.nodes[last_id].n_read--;
                    last_id = aligned_id;
                    last_new = false;
                } else {
                    int new_id = add_node(g, b);
                    add_edge(g, last_id, new_id, false, (int)weight[query_id],
                             arid && add, arw, read_id, read_ids_n);
                    g.nodes[new_id].n_span_read = g.nodes[last_id].n_span_read;
                    if (!add) g.nodes[last_id].n_read--;
                    last_id = new_id;
                    last_new = true;
                    add_aligned_node(g, node_id, new_id);
                }
            } else {  // match
                add_edge(g, last_id, node_id, !last_new, (int)weight[query_id],
                         arid && add, arw, read_id, read_ids_n);
                if (!add) g.nodes[last_id].n_read--;
                last_id = node_id;
                last_new = false;
            }
            if (qpos_to_node_id) qpos_to_node_id[query_id] = last_id;
        } else if (op == CINS || op == CSOFT || op == CHARD) {
            int len = (int)((p >> 4) & 0x3FFFFFFF);
            query_id += len;
            for (int j = len - 1; j >= 0; --j) {
                int new_id = add_node(g, seq[query_id - j]);
                bool add = (last_id != beg_node_id) || inc_both_ends;
                add_edge(g, last_id, new_id, false, (int)weight[query_id - j],
                         arid && add, arw, read_id, read_ids_n);
                g.nodes[new_id].n_span_read = g.nodes[last_id].n_span_read;
                if (!add) g.nodes[last_id].n_read--;
                last_id = new_id;
                last_new = true;
                if (qpos_to_node_id) qpos_to_node_id[query_id - j] = last_id;
            }
        }  // CDEL: skip
    }
    add_edge(g, last_id, end_node_id, !last_new, (int)weight[seq_l - 1],
             arid, arw, read_id, read_ids_n);
    topological_sort(g, banded != 0, zdrop != 0);
    update_n_span(g, beg_node_id, end_node_id, inc_both_ends != 0);
    return 0;
}

// ----- kernel snapshot ------------------------------------------------------
// Build the BFS-reachable subgraph mask + padded pre/out tables for the dp
// window [beg_index, end_index]. Two-phase: pass P=O=0 to query max degrees.
int apg_build_tables(void* h, int beg_node_id, int end_node_id,
                     int R, int P, int O, int banded,
                     int32_t* base, uint8_t* row_active,
                     int32_t* pre_idx, uint8_t* pre_msk,
                     int32_t* out_idx, uint8_t* out_msk,
                     int32_t* remain_rows, int32_t* mpl0, int32_t* mpr0,
                     int32_t* maxPO /*out: [maxP, maxO, gn, beg_index, remain_end]*/) {
    Graph& g = *(Graph*)h;
    int beg_index = g.node_id_to_index[beg_node_id];
    int end_index = g.node_id_to_index[end_node_id];
    int gn = end_index - beg_index + 1;
    std::vector<uint8_t> index_map(g.n(), 0);
    index_map[beg_index] = index_map[end_index] = 1;
    for (int i = beg_index; i < end_index - 1; ++i) {
        if (!index_map[i]) continue;
        int nid = g.index_to_node_id[i];
        for (int out_id : g.nodes[nid].out_ids)
            index_map[g.node_id_to_index[out_id]] = 1;
    }
    int maxP = 1, maxO = 1;
    if (banded) {
        // first-row band seeding (abpoa_align_simd.c:617-626)
        g.mpl[beg_node_id] = g.mpr[beg_node_id] = 0;
        for (int out_id : g.nodes[beg_node_id].out_ids)
            if (index_map[g.node_id_to_index[out_id]])
                g.mpl[out_id] = g.mpr[out_id] = 1;
    }
    for (int i = 0; i < gn; ++i) {
        int nid = g.index_to_node_id[beg_index + i];
        bool active = index_map[beg_index + i] != 0;
        if (P > 0) {
            base[i] = g.nodes[nid].base;
            row_active[i] = active && i > 0 ? 1 : 0;
            if (banded) {
                remain_rows[i] = g.max_remain[nid];
                mpl0[i] = g.mpl[nid];
                mpr0[i] = g.mpr[nid];
            }
        }
        if (i == 0 || !active) continue;
        int np = 0;
        for (int in_id : g.nodes[nid].in_ids) {
            int p_idx = g.node_id_to_index[in_id];
            if (index_map[p_idx]) {
                if (P > 0) {
                    pre_idx[(int64_t)i * P + np] = p_idx - beg_index;
                    pre_msk[(int64_t)i * P + np] = 1;
                }
                np++;
            }
        }
        maxP = std::max(maxP, np);
        if (banded && i < gn - 1) {
            int no = 0;
            for (int out_id : g.nodes[nid].out_ids) {
                if (P > 0) {
                    out_idx[(int64_t)i * O + no] = g.node_id_to_index[out_id] - beg_index;
                    out_msk[(int64_t)i * O + no] = 1;
                }
                no++;
            }
            maxO = std::max(maxO, no);
        }
    }
    maxPO[0] = maxP;
    maxPO[1] = maxO;
    maxPO[2] = gn;
    maxPO[3] = beg_index;
    maxPO[4] = banded ? g.max_remain[end_node_id] : 0;
    return 0;
}

void apg_write_band(void* h, int beg_index, int gn, const int32_t* mpl, const int32_t* mpr) {
    Graph& g = *(Graph*)h;
    for (int i = 0; i < gn; ++i) {
        int nid = g.index_to_node_id[beg_index + i];
        g.mpl[nid] = mpl[i];
        g.mpr[nid] = mpr[i];
    }
}

int apg_get_index(void* h, int32_t* index_to_node_id, int32_t* node_id_to_index) {
    Graph& g = *(Graph*)h;
    std::memcpy(index_to_node_id, g.index_to_node_id.data(), g.n() * 4);
    std::memcpy(node_id_to_index, g.node_id_to_index.data(), g.n() * 4);
    return g.n();
}

// ----- full export (for consensus / MSA / GFA writers on the Python side) ---
// sizes query: fills counts[0..3] = [node_n, tot_in_edges, tot_out_edges,
// tot_aligned, tot_read_weight, read_ids_words_per_edge_total]
int apg_export_sizes(void* h, int64_t* counts) {
    Graph& g = *(Graph*)h;
    int64_t tin = 0, tout = 0, tal = 0, trw = 0, tbits = 0;
    for (auto& node : g.nodes) {
        tin += node.in_ids.size();
        tout += node.out_ids.size();
        tal += node.aligned_ids.size();
        trw += node.read_weight_ids.size();
        for (auto& b : node.read_ids) tbits += b.size();
    }
    counts[0] = g.n(); counts[1] = tin; counts[2] = tout; counts[3] = tal;
    counts[4] = trw; counts[5] = tbits;
    return 0;
}

int apg_export(void* h,
               uint8_t* base, int32_t* n_read, int32_t* n_span,
               int64_t* in_off, int32_t* in_ids, int32_t* in_w,
               int64_t* out_off, int32_t* out_ids, int32_t* out_w,
               int64_t* al_off, int32_t* al_ids,
               int64_t* rw_off, int32_t* rw_ids, int32_t* rw_vals,
               int64_t* bits_off, uint64_t* bits /* per out edge, CSR by words */,
               int64_t* bits_words /* per out edge word count */) {
    Graph& g = *(Graph*)h;
    int64_t iin = 0, iout = 0, ial = 0, irw = 0, ibits = 0, iedge = 0;
    for (int i = 0; i < g.n(); ++i) {
        Node& node = g.nodes[i];
        base[i] = node.base;
        n_read[i] = node.n_read;
        n_span[i] = node.n_span_read;
        in_off[i] = iin;
        for (size_t j = 0; j < node.in_ids.size(); ++j) {
            in_ids[iin] = node.in_ids[j];
            in_w[iin++] = node.in_w[j];
        }
        out_off[i] = iout;
        for (size_t j = 0; j < node.out_ids.size(); ++j) {
            out_ids[iout] = node.out_ids[j];
            out_w[iout++] = node.out_w[j];
            bits_words[iedge] = (int64_t)node.read_ids[j].size();
            bits_off[iedge++] = ibits;
            for (uint64_t wd : node.read_ids[j]) bits[ibits++] = wd;
        }
        al_off[i] = ial;
        for (int a : node.aligned_ids) al_ids[ial++] = a;
        rw_off[i] = irw;
        for (size_t j = 0; j < node.read_weight_ids.size(); ++j) {
            rw_ids[irw] = node.read_weight_ids[j];
            rw_vals[irw++] = node.read_weight_vals[j];
        }
    }
    in_off[g.n()] = iin; out_off[g.n()] = iout; al_off[g.n()] = ial; rw_off[g.n()] = irw;
    return 0;
}

int apg_get_remain(void* h, int32_t* remain) {
    Graph& g = *(Graph*)h;
    if (g.max_remain.empty()) return -1;
    std::memcpy(remain, g.max_remain.data(), g.n() * 4);
    return 0;
}

// the band metadata (mpl/mpr of every node); -1 before the first banded sort
int apg_get_band(void* h, int32_t* mpl, int32_t* mpr) {
    Graph& g = *(Graph*)h;
    if ((int)g.mpl.size() < g.n()) return -1;
    std::memcpy(mpl, g.mpl.data(), g.n() * 4);
    std::memcpy(mpr, g.mpr.data(), g.n() * 4);
    return 0;
}

// Replace the graph by one given as arrays (the CSR form of apg_export, the
// read-id bitsets `words` uint64 a out edge, and the sort's arrays, which
// are taken as given when `sorted`).
int apg_import(void* h, int n, const int32_t* base, const int32_t* n_read,
               const int32_t* n_span, const int64_t* in_off,
               const int32_t* in_ids, const int32_t* in_w,
               const int64_t* out_off, const int32_t* out_ids,
               const int32_t* out_w, const uint64_t* bits, int words,
               const int64_t* al_off, const int32_t* al_ids,
               const int64_t* rw_off, const int32_t* rw_ids,
               const int32_t* rw_vals, const int32_t* index_to_node_id,
               const int32_t* node_id_to_index, const int32_t* remain,
               const int32_t* mpl, const int32_t* mpr, int sorted) {
    Graph& g = *(Graph*)h;
    if (n < 2) return -1;
    g.reset();
    g.nodes.resize(n);
    for (int i = 0; i < n; ++i) {
        Node& node = g.nodes[i];
        node.base = (uint8_t)base[i];
        node.n_read = n_read[i];
        node.n_span_read = n_span[i];
        node.in_ids.assign(in_ids + in_off[i], in_ids + in_off[i + 1]);
        node.in_w.assign(in_w + in_off[i], in_w + in_off[i + 1]);
        node.out_ids.assign(out_ids + out_off[i], out_ids + out_off[i + 1]);
        node.out_w.assign(out_w + out_off[i], out_w + out_off[i + 1]);
        node.read_ids.clear();
        for (int64_t e = out_off[i]; e < out_off[i + 1]; ++e)
            node.read_ids.emplace_back(bits + e * words, bits + (e + 1) * words);
        node.aligned_ids.assign(al_ids + al_off[i], al_ids + al_off[i + 1]);
        node.read_weight_ids.assign(rw_ids + rw_off[i], rw_ids + rw_off[i + 1]);
        node.read_weight_vals.assign(rw_vals + rw_off[i], rw_vals + rw_off[i + 1]);
    }
    g.index_to_node_id.assign(index_to_node_id, index_to_node_id + n);
    g.node_id_to_index.assign(node_id_to_index, node_id_to_index + n);
    g.max_remain.assign(remain, remain + n);
    g.mpl.assign(mpl, mpl + n);
    g.mpr.assign(mpr, mpr + n);
    g.sorted = sorted != 0;
    return 0;
}

// -G log-scaled path score for in-edge `in_pos` of `nid`
// (reference abpoa_graph.c:429-437; C round() = half away from zero)
static int32_t incre_path_score(Graph& g, int nid, int in_pos) {
    int pre_id = g.nodes[nid].in_ids[in_pos];
    const Node& pre = g.nodes[pre_id];
    int64_t node_w = 0;
    for (int32_t w : pre.out_w) node_w += w;
    int64_t edge_w = g.nodes[nid].in_w[in_pos];
    if (node_w == 0 || edge_w == 0) return 0;
    double v = std::log((double)edge_w / (double)node_w);
    int32_t s = (int32_t)(v >= 0 ? std::floor(v + 0.5) : std::ceil(v - 0.5));
    return std::max(s, (int32_t)-20);
}

// subgraph closure expansion (abpoa_graph.c:595-678)
static bool is_full_upstream(Graph& g, int up, int down, int beg, int end) {
    int mn = std::min(up, beg), mx = std::max(down, end);
    for (int i = up + 1; i <= down; ++i) {
        int nid = g.index_to_node_id[i];
        for (int in_id : g.nodes[nid].in_ids) {
            int idx = g.node_id_to_index[in_id];
            if (idx < mn || idx > mx) return false;
        }
    }
    return true;
}

int apg_subgraph_nodes(void* h, int inc_beg, int inc_end, int32_t* out2) {
    Graph& g = *(Graph*)h;
    int beg_index = g.node_id_to_index[inc_beg];
    int end_index = g.node_id_to_index[inc_end];
    int b = beg_index, e = end_index;
    while (true) {
        int mn = b;
        for (int i = b; i <= e; ++i) {
            int nid = g.index_to_node_id[i];
            for (int in_id : g.nodes[nid].in_ids)
                mn = std::min(mn, (int)g.node_id_to_index[in_id]);
        }
        if (is_full_upstream(g, mn, b, b, e)) { b = mn; break; }
        e = b; b = mn;
    }
    int b2 = beg_index, e2 = end_index;
    while (true) {
        int mx = e2;
        for (int i = b2; i <= e2; ++i) {
            int nid = g.index_to_node_id[i];
            for (int out_id : g.nodes[nid].out_ids)
                mx = std::max(mx, (int)g.node_id_to_index[out_id]);
        }
        if (is_full_upstream(g, e2, mx, b2, e2)) { e2 = mx; break; }
        b2 = e2; e2 = mx;
    }
    out2[0] = g.index_to_node_id[b];
    out2[1] = g.index_to_node_id[e2];
    return 0;
}

}  // extern "C"

extern "C" {

int apg_cons_hb(void* h, int32_t* ids_out, int32_t* base_out,
                int32_t* cov_out, int cap) {
    // Heaviest-bundling consensus, single cluster / read-count weights (the
    // default -r0 config): reverse BFS from sink, per-node argmax out-edge
    // weight with path-score tiebreak, then walk max_out from source
    // (reference abpoa_heaviest_bundling src/abpoa_output.c:478-548, walk
    // :376-392). Multi-cluster / qv-weighted calls stay on the Python side
    // (they need per-edge read-id bitsets).
    Graph& g = *(Graph*)h;
    const int n = g.n();
    if (n <= 2) return 0;
    const int src = 0, sink = 1;
    // int64 scores: the Python path accumulates in unbounded ints, and a
    // qv-weighted long-path sum can exceed int32
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> max_out(n, -1), out_deg(n);
    for (int i = 0; i < n; ++i) out_deg[i] = (int)g.nodes[i].out_ids.size();
    std::vector<int32_t>& q = g.ws_queue;
    if ((int)q.size() < n) q.resize(n);
    int head = 0, tail = 0;
    q[tail++] = sink;
    while (head < tail) {
        const int cur = q[head++];
        const Node& node = g.nodes[cur];
        if (cur == sink) {
            score[cur] = 0;
        } else if (cur == src) {
            int64_t path_score = -1;
            int32_t path_max_w = -1;
            int max_id = -1;
            for (size_t i = 0; i < node.out_ids.size(); ++i) {
                const int out_id = node.out_ids[i];
                const int32_t out_w = node.out_w[i];
                if (out_w > path_max_w
                        || (out_w == path_max_w && score[out_id] > path_score)) {
                    max_id = out_id;
                    path_score = score[out_id];
                    path_max_w = out_w;
                }
            }
            max_out[cur] = max_id;
            break;
        } else {
            // seed from the first edge, not an INT32_MIN sentinel: the
            // sentinel path could tie (max_w == out_w) while max_id is
            // still -1 and read score[-1] (UB)
            int max_id = node.out_ids[0];
            int32_t max_w = node.out_w[0];
            for (size_t i = 1; i < node.out_ids.size(); ++i) {
                const int out_id = node.out_ids[i];
                const int32_t out_w = node.out_w[i];
                if (max_w < out_w) {
                    max_w = out_w;
                    max_id = out_id;
                } else if (max_w == out_w && score[max_id] <= score[out_id]) {
                    max_id = out_id;
                }
            }
            score[cur] = max_w + score[max_id];
            max_out[cur] = max_id;
        }
        for (int in_id : node.in_ids)
            if (--out_deg[in_id] == 0) q[tail++] = in_id;
    }
    // a graph whose source never reached the BFS (dead-end component) or
    // whose source has no out edges has no src->sink chain: walking from
    // max_out[src] == -1 would index max_out[-1] (UB)
    if (max_out[src] < 0) return 0;
    int len = 0;
    for (int cur = max_out[src]; cur != sink && cur >= 0; cur = max_out[cur]) {
        if (len >= cap) return -1;  // caller resizes and retries
        ids_out[len] = cur;
        base_out[len] = g.nodes[cur].base;
        cov_out[len] = g.nodes[cur].n_read;
        ++len;
    }
    return len;
}

}  // extern "C"

// ===========================================================================
// Native scalar DP kernel: adaptive-banded sequence-to-(sub)graph alignment.
//
// Same semantics as the Python/NumPy oracle (abpoa_tpu/align/oracle.py, the
// golden-verified readable spec of the reference's SIMD kernel): banded
// storage (one contiguous buffer, per-row offsets), int32 scores, sequential
// F gap chains, reference backtrack op priority and tie-breaks. Serves as the
// fast host fallback when no accelerator is reachable, and as the CPU side of
// the anchored-window pipeline.
// ===========================================================================

namespace {

const int32_t KINT32_MIN = INT32_MIN;
const int32_t KINT16_MIN = INT16_MIN;

// int16 plane storage: all DP arithmetic stays int32 (values are bounded by
// the width-selection check below); only the PLANE arrays narrow, halving
// the bandwidth that dominates the row loop. Stores saturate at INT16_MIN —
// decayed -inf chains clamp instead of wrapping (the reference's saturating
// SIMD subs give the same guarantee, simd_instruction.h) — and saturated
// cells stay far below every reachable real score, so backtrack equalities
// on the optimal path are unaffected.
template <typename T> inline T clamp_store(int32_t v) { return (T)v; }
template <> inline int16_t clamp_store<int16_t>(int32_t v) {
    return (int16_t)std::max(v, (int32_t)INT16_MIN);
}

template <typename T> struct PlaneWS;
template <> struct PlaneWS<int32_t> {
    static std::vector<int32_t>& H(Graph& g) { return g.wsH; }
    static std::vector<int32_t>& E1(Graph& g) { return g.wsE1; }
    static std::vector<int32_t>& E2(Graph& g) { return g.wsE2; }
    static std::vector<int32_t>& F1(Graph& g) { return g.wsF1; }
    static std::vector<int32_t>& F2(Graph& g) { return g.wsF2; }
};
template <> struct PlaneWS<int16_t> {
    static std::vector<int16_t>& H(Graph& g) { return g.wsH16; }
    static std::vector<int16_t>& E1(Graph& g) { return g.wsE116; }
    static std::vector<int16_t>& E2(Graph& g) { return g.wsE216; }
    static std::vector<int16_t>& F1(Graph& g) { return g.wsF116; }
    static std::vector<int16_t>& F2(Graph& g) { return g.wsF216; }
};

template <typename T>
struct DpPlanes {
    // banded rows: row i occupies [row_ptr[i], row_ptr[i] + width_i)
    // views over the graph's persistent workspaces (no per-call allocation)
    std::vector<int64_t>& row_ptr;
    std::vector<int32_t>& beg;
    std::vector<int32_t>& end;
    std::vector<T>& H;
    std::vector<T>& E1;
    std::vector<T>& E2;
    std::vector<T>& F1;
    std::vector<T>& F2;
    int64_t used = 0;
    int32_t inf = 0;
    int n_planes = 5;

    explicit DpPlanes(Graph& g)
        : row_ptr(g.ws_row_ptr), beg(g.ws_beg), end(g.ws_end),
          H(PlaneWS<T>::H(g)), E1(PlaneWS<T>::E1(g)), E2(PlaneWS<T>::E2(g)),
          F1(PlaneWS<T>::F1(g)), F2(PlaneWS<T>::F2(g)) {}

    void start(int gn, int np) {
        n_planes = np;
        used = 0;
        if ((int)row_ptr.size() < gn + 1) {
            row_ptr.resize(gn + 1);
            beg.resize(gn);
            end.resize(gn);
        }
        std::fill(beg.begin(), beg.begin() + gn, 0);
        std::fill(end.begin(), end.begin() + gn, -1);
    }
    void append_row(int i, int b, int e) {
        beg[i] = b;
        end[i] = e;
        row_ptr[i] = used;
        used += e - b + 1;
        if ((int64_t)H.size() < used) {
            int64_t cap = std::max<int64_t>(used, (int64_t)H.size() * 2);
            H.resize(cap);
            if (n_planes >= 3) { E1.resize(cap); F1.resize(cap); }
            if (n_planes >= 5) { E2.resize(cap); F2.resize(cap); }
        }
    }

    inline int32_t get(const std::vector<T>& P, int i, int j) const {
        if (j < beg[i] || j > end[i]) return inf;
        return (int32_t)P[row_ptr[i] + (j - beg[i])];
    }
    inline int32_t h(int i, int j) const { return get(H, i, j); }
    inline int32_t e1(int i, int j) const { return get(E1, i, j); }
    inline int32_t e2(int i, int j) const { return get(E2, i, j); }
    inline int32_t f1(int i, int j) const { return get(F1, i, j); }
    inline int32_t f2(int i, int j) const { return get(F2, i, j); }
};

struct CigBuf {
    uint64_t* out;
    int cap, n = 0;
    bool overflow = false;
    void push(int op, int len, int64_t node_id, int64_t query_id) {
        // packed-cigar push with INS-run merging (abpoa_align.h:54-73)
        if (n > 0 && (op == 1 || op == 4 || op == 5) && (int)(out[n - 1] & 0xF) == op) {
            out[n - 1] += (uint64_t)len << 4;
            return;
        }
        if (n >= cap) { overflow = true; return; }
        uint64_t v;
        if (op == 0 || op == 3) v = (uint64_t)(node_id & 0x3FFFFFFF) << 34 |
                                     (uint64_t)(query_id & 0x3FFFFFFF) << 4 | op;
        else if (op == 2) v = (uint64_t)(node_id & 0x3FFFFFFF) << 34 |
                              (uint64_t)(len & 0x3FFFFFFF) << 4 | op;
        else v = (uint64_t)(query_id & 0x3FFFFFFF) << 34 |
                 (uint64_t)(len & 0x3FFFFFFF) << 4 | op;
        out[n++] = v;
    }
};

}  // namespace

template <typename T>
int apg_align_core(void* h, int beg_node_id, int end_node_id,
                   const uint8_t* query, int qlen, const int32_t* mat,
                   const int32_t* params, uint64_t* cigar_out, int cigar_cap,
                   int64_t* meta);

extern "C" {

// params layout (int32): [align_mode, gap_mode, wb, wf_x1e6, zdrop, m,
//                         o1, e1, o2, e2, min_mis, put_gap_on_right,
//                         put_gap_at_end, ret_cigar, inc_path_score,
//                         max_mat, force_int32_planes]
// meta out (int64): [best_score, node_s, node_e, query_s, query_e,
//                    n_aln_bases, n_matched_bases, n_cigar]
int apg_align(void* h, int beg_node_id, int end_node_id,
              const uint8_t* query, int qlen, const int32_t* mat,
              const int32_t* params, uint64_t* cigar_out, int cigar_cap,
              int64_t* meta) {
    // score-width selection (reference simd_abpoa_align_sequence_to_subgraph,
    // abpoa_align_simd.c:1284-1302): int16 plane STORAGE while the worst-case
    // score bound fits, int32 after. Both widths produce identical output —
    // the bound guarantees every reachable value fits int16, and saturated
    // -inf cells stay below every real score.
    Graph& g = *(Graph*)h;
    const int32_t o1 = params[6], e1 = params[7];
    const int32_t e2 = params[9];
    const int32_t oe1 = o1 + e1, oe2 = params[8] + e2;
    const int32_t min_mis = params[10];
    const int32_t max_mat = params[15];
    const bool force32 = params[16] != 0;
    const int beg_index = g.node_id_to_index[beg_node_id];
    const int end_index = g.node_id_to_index[end_node_id];
    const int32_t gn = end_index - beg_index + 1;
    const int32_t ln = std::max((int32_t)qlen, gn);
    const int64_t bound = std::max((int64_t)qlen * max_mat,
                                   (int64_t)ln * e1 + o1);
    // the int16 inf sentinel is INT16_MIN + max(min_mis, oe1, oe2) +
    // 512*max(e1,e2) (underflow headroom, apg_align_core); the limit must
    // leave that same headroom below the most negative reachable score or
    // inf could rise into — or above — the valid range (large extension
    // penalties then simply select int32)
    const int64_t limit = 32767 - min_mis - oe1 - oe2
        - 512 * (int64_t)std::max(e1, e2);
    // -G accumulates per-transition path scores (incre_path_score, up to
    // -20 each) on top of the alignment score; the static bound above only
    // models match/gap growth, so long -G alignments can sink past the
    // int16 inf sentinel and wrap. Always take the int32 core under -G.
    const bool inc_ps = params[14] != 0;
    if (!force32 && !inc_ps && bound <= limit)
        return apg_align_core<int16_t>(h, beg_node_id, end_node_id, query,
                                       qlen, mat, params, cigar_out,
                                       cigar_cap, meta);
    return apg_align_core<int32_t>(h, beg_node_id, end_node_id, query, qlen,
                                   mat, params, cigar_out, cigar_cap, meta);
}


}  // extern "C"

// templates cannot carry C linkage; apg_align above is the C-ABI dispatcher
template <typename T>
int apg_align_core(void* h, int beg_node_id, int end_node_id,
                   const uint8_t* query, int qlen, const int32_t* mat,
                   const int32_t* params, uint64_t* cigar_out, int cigar_cap,
                   int64_t* meta) {
    Graph& g = *(Graph*)h;
    const int align_mode = params[0], gap_mode = params[1], wb = params[2];
    const double wf = params[3] / 1e6;
    const int m = params[5];
    const int32_t o1 = params[6], e1 = params[7], o2 = params[8], e2 = params[9];
    const int32_t oe1 = o1 + e1, oe2 = o2 + e2, min_mis = params[10];
    const bool gap_on_right = params[11] != 0;
    const bool put_gap_at_end_flag = params[12] != 0;
    const bool ret_cigar = params[13] != 0;
    const bool inc_ps = params[14] != 0;  // -G path scores
    const bool local = align_mode == 1, extend = align_mode == 2;
    const bool banded = wb >= 0;
    const bool linear = gap_mode == 0, convex = gap_mode == 2;
    const int n_planes = linear ? 1 : (gap_mode == 1 ? 3 : 5);

    const int beg_index = g.node_id_to_index[beg_node_id];
    const int end_index = g.node_id_to_index[end_node_id];
    const int gn = end_index - beg_index + 1;
    const int w = banded ? wb + (int)(wf * qlen) : qlen;
    const int32_t TMIN = sizeof(T) == 2 ? KINT16_MIN : KINT32_MIN;
    const int32_t inf = std::max(std::max(TMIN + min_mis, TMIN + oe1),
                                 TMIN + oe2) + 512 * std::max(e1, e2);

    // subgraph reachability mask (abpoa_align_simd.c:1259-1269); persistent
    // workspace — per-alignment vector-of-vectors allocation dominated the
    // per-row overhead at 40k+ rows
    std::vector<uint8_t>& index_map = g.ws_index_map;
    index_map.assign(g.n(), 0);
    index_map[beg_index] = index_map[end_index] = 1;
    for (int i = beg_index; i < end_index - 1; ++i) {
        if (!index_map[i]) continue;
        for (int out_id : g.nodes[g.index_to_node_id[i]].out_ids)
            index_map[g.node_id_to_index[out_id]] = 1;
    }

    // filtered predecessor lists per dp row, flattened CSR (+ -G path score
    // per kept slot: ps keys by the ORIGINAL in-edge position, so it must be
    // computed here where that position is still known)
    std::vector<int32_t>& pre_flat = g.ws_pre;
    std::vector<int32_t>& pre_off = g.ws_pre_off;
    std::vector<int32_t>& pre_ps = g.ws_pre_ps;
    if ((int)pre_off.size() < gn + 1) pre_off.resize(gn + 1);
    pre_flat.clear();
    if (inc_ps) pre_ps.clear();
    pre_off[0] = pre_off[1] = 0;
    for (int i = 1; i < gn; ++i) {
        if (index_map[beg_index + i]) {
            int nid = g.index_to_node_id[beg_index + i];
            const auto& in_ids = g.nodes[nid].in_ids;
            for (size_t k = 0; k < in_ids.size(); ++k) {
                int p = g.node_id_to_index[in_ids[k]];
                if (index_map[p]) {
                    pre_flat.push_back(p - beg_index);
                    if (inc_ps)
                        pre_ps.push_back(incre_path_score(g, nid, (int)k));
                }
            }
        }
        pre_off[i + 1] = (int32_t)pre_flat.size();
    }
    struct PreView {
        const int32_t* flat; const int32_t* off;
        struct Range { const int32_t* b; const int32_t* e;
                       const int32_t* begin() const { return b; }
                       const int32_t* end() const { return e; } };
        Range operator[](int i) const {
            return {flat + off[i], flat + off[i + 1]};
        }
    };
    const PreView pre{pre_flat.data(), pre_off.data()};

    const int32_t remain_end = banded || params[4] > 0 ? g.max_remain[end_node_id] : 0;
    auto ad_beg = [&](int nid) {
        int r = qlen - (g.max_remain[nid] - remain_end - 1);
        return std::max(0, std::min(g.mpl[nid], r) - w);
    };
    auto ad_end = [&](int nid) {
        int r = qlen - (g.max_remain[nid] - remain_end - 1);
        return std::min(qlen, std::max(g.mpr[nid], r) + w);
    };

    DpPlanes<T> dp(g);
    dp.inf = inf;
    dp.start(gn, n_planes);

    // ---- first row --------------------------------------------------------
    if (banded) {
        g.mpl[beg_node_id] = g.mpr[beg_node_id] = 0;
        for (int out_id : g.nodes[beg_node_id].out_ids)
            if (index_map[g.node_id_to_index[out_id]])
                g.mpl[out_id] = g.mpr[out_id] = 1;
        dp.beg[0] = 0;
        dp.end[0] = ad_end(beg_node_id);
    } else {
        dp.beg[0] = 0;
        dp.end[0] = qlen;
    }

    auto append_row = [&](int i, int b, int e) { dp.append_row(i, b, e); };

    {
        int b0 = dp.beg[0], e0 = dp.end[0];
        append_row(0, b0, e0);
    }
    {
        int e0 = dp.end[0];
        int64_t p0 = dp.row_ptr[0];
        if (local) {
            for (int j = 0; j <= e0; ++j) {
                dp.H[p0 + j] = 0;
                if (n_planes >= 3) dp.E1[p0 + j] = dp.F1[p0 + j] = 0;
                if (n_planes >= 5) dp.E2[p0 + j] = dp.F2[p0 + j] = 0;
            }
        } else if (linear) {
            for (int j = 0; j <= e0; ++j)
                dp.H[p0 + j] = clamp_store<T>(-e1 * j);
        } else if (gap_mode == 1) {
            dp.H[p0] = 0; dp.E1[p0] = clamp_store<T>(-oe1);
            dp.F1[p0] = clamp_store<T>(inf);
            for (int j = 1; j <= e0; ++j) {
                dp.F1[p0 + j] = clamp_store<T>(-o1 - e1 * j);
                dp.H[p0 + j] = dp.F1[p0 + j];
                dp.E1[p0 + j] = clamp_store<T>(inf);
            }
        } else {
            dp.H[p0] = 0; dp.E1[p0] = clamp_store<T>(-oe1);
            dp.E2[p0] = clamp_store<T>(-oe2);
            dp.F1[p0] = dp.F2[p0] = clamp_store<T>(inf);
            for (int j = 1; j <= e0; ++j) {
                dp.F1[p0 + j] = clamp_store<T>(-o1 - e1 * j);
                dp.F2[p0 + j] = clamp_store<T>(-o2 - e2 * j);
                dp.H[p0 + j] = std::max(dp.F1[p0 + j], dp.F2[p0 + j]);
                dp.E1[p0 + j] = dp.E2[p0 + j] = clamp_store<T>(inf);
            }
        }
    }

    int32_t best_score = inf;
    int best_i = 0, best_j = 0, best_nid = beg_node_id;
    std::vector<int32_t> Mq, E1r, E2r, Hh;

    // query profile: qprof[k][j] = mat[k][query[j-1]], qprof[k][0] = 0 — one
    // gather pass per alignment so the per-row profile add is a contiguous
    // (vectorizable) load (the reference builds qp the same way,
    // abpoa_align_simd.c:463-580)
    std::vector<int32_t>& qprof = g.ws_qprof;
    if ((int64_t)qprof.size() < (int64_t)m * (qlen + 1))
        qprof.resize((int64_t)m * (qlen + 1));
    for (int k = 0; k < m; ++k) {
        int32_t* qp = qprof.data() + (int64_t)k * (qlen + 1);
        const int32_t* mk = mat + (int64_t)k * m;
        qp[0] = 0;
        for (int j = 1; j <= qlen; ++j) qp[j] = mk[query[j - 1]];
    }

    // ---- row loop ---------------------------------------------------------
    bool zdropped = false;
    for (int index_i = beg_index + 1; index_i < end_index && !zdropped; ++index_i) {
        if (!index_map[index_i]) continue;
        int i = index_i - beg_index;
        int nid = g.index_to_node_id[index_i];
        int b, e;
        if (banded) {
            b = ad_beg(nid);
            e = ad_end(nid);
            int mpb = INT32_MAX;
            for (int p : pre[i]) mpb = std::min(mpb, dp.beg[p]);
            if (b < mpb) b = mpb;
        } else { b = 0; e = qlen; }
        append_row(i, b, e);
        int width = e - b + 1;
        Mq.assign(width, inf);
        // linear-gap E candidates are (pred H - e1); uncovered cells carry
        // inf-e1 in the oracle's full-width arithmetic — replicate exactly
        E1r.assign(width, linear ? inf - e1 : inf);
        if (convex) E2r.assign(width, inf);
        const uint8_t base = g.nodes[nid].base;
        const int32_t* qrow = qprof.data() + (int64_t)base * (qlen + 1);

        for (int32_t t = pre_off[i]; t < pre_off[i + 1]; ++t) {
            const int p = pre_flat[t];
            // -G adds the pred's path score to every contribution
            // (oracle.py:232-245; reference abpoa_graph.c:429-437); the
            // ps==0 bodies keep the non-G inner loops byte-for-byte intact
            const int32_t ps = inc_ps ? pre_ps[t] : 0;
            const int pb = dp.beg[p], pe = dp.end[p];
            const int64_t pp = dp.row_ptr[p];
            // M from pred H at j-1: overlap of [b,e] with [pb+1, pe+1]
            {
                const int lo = std::max(b, pb + 1), hi = std::min(e, pe + 1);
                const T* Hp = dp.H.data() + pp - pb;  // Hp[j-1] valid
                int32_t* Mqp = Mq.data() - b;
                if (ps == 0) {
                    for (int j = lo; j <= hi; ++j)
                        Mqp[j] = std::max(Mqp[j], (int32_t)Hp[j - 1]);
                } else {
                    for (int j = lo; j <= hi; ++j)
                        Mqp[j] = std::max(Mqp[j], (int32_t)Hp[j - 1] + ps);
                }
            }
            // E from pred at j: overlap of [b,e] with [pb, pe]
            {
                const int lo = std::max(b, pb), hi = std::min(e, pe);
                if (linear) {
                    const T* Hp = dp.H.data() + pp - pb;
                    int32_t* Ep = E1r.data() - b;
                    const int32_t d = e1 - ps;
                    for (int j = lo; j <= hi; ++j)
                        Ep[j] = std::max(Ep[j], (int32_t)Hp[j] - d);
                } else {
                    const T* E1p = dp.E1.data() + pp - pb;
                    int32_t* Ep = E1r.data() - b;
                    if (ps == 0) {
                        for (int j = lo; j <= hi; ++j)
                            Ep[j] = std::max(Ep[j], (int32_t)E1p[j]);
                    } else {
                        for (int j = lo; j <= hi; ++j)
                            Ep[j] = std::max(Ep[j], (int32_t)E1p[j] + ps);
                    }
                    if (convex) {
                        const T* E2p = dp.E2.data() + pp - pb;
                        int32_t* E2o = E2r.data() - b;
                        if (ps == 0) {
                            for (int j = lo; j <= hi; ++j)
                                E2o[j] = std::max(E2o[j], (int32_t)E2p[j]);
                        } else {
                            for (int j = lo; j <= hi; ++j)
                                E2o[j] = std::max(E2o[j], (int32_t)E2p[j] + ps);
                        }
                    }
                }
            }
        }
        if (local && b == 0) {
            // H[-1] treated as 0; under -G the lead carries the path score,
            // so the seed is max over preds of (0 + ps) (oracle.py:237-241)
            int32_t lead = 0;
            if (inc_ps && pre_off[i] < pre_off[i + 1]) {
                lead = pre_ps[pre_off[i]];
                for (int32_t t = pre_off[i] + 1; t < pre_off[i + 1]; ++t)
                    lead = std::max(lead, pre_ps[t]);
            }
            if (Mq[0] < lead) Mq[0] = lead;
        }
        // add query profile; Hhat = max(M+q, E) — contiguous, vectorizable
        Hh.resize(width);  // fully overwritten below; no fill needed
        {
            const int32_t* qj = qrow + b;
            if (convex) {
                for (int j = 0; j < width; ++j) {
                    Mq[j] += qj[j];
                    Hh[j] = std::max(std::max(Mq[j], E1r[j]), E2r[j]);
                }
            } else {
                for (int j = 0; j < width; ++j) {
                    Mq[j] += qj[j];
                    Hh[j] = std::max(Mq[j], E1r[j]);
                }
            }
        }
        int64_t pi = dp.row_ptr[i];
        if (linear) {
            // in-row chain on H plane: H[j] = max(H[j], H[j-1]-e1)
            int32_t prev = Hh[0];
            dp.H[pi] = clamp_store<T>(local ? std::max(prev, 0) : prev);
            for (int j = 1; j < width; ++j) {
                int32_t v = std::max(Hh[j], prev - e1);
                prev = v;
                dp.H[pi + j] = clamp_store<T>(local ? std::max(v, 0) : v);
            }
        } else {
            // F chains: F[b]=Mq[b]-oe; F[j]=max(Hh[j-1]-oe, F[j-1]-e).
            // The carry is latency-bound and unavoidable (a log-doubling
            // vectorized form was measured SLOWER at typical ~220-cell
            // bands), so keep ONLY the carry sequential and finalize
            // H/E elementwise in a separate autovectorized pass.
            T* F1row = dp.F1.data() + pi;
            T* E1row = dp.E1.data() + pi;
            T* Hrow = dp.H.data() + pi;
            if (convex) {
                T* F2row = dp.F2.data() + pi;
                T* E2row = dp.E2.data() + pi;
                int32_t f1 = Mq[0] - oe1, f2 = Mq[0] - oe2;
                F1row[0] = clamp_store<T>(f1);
                F2row[0] = clamp_store<T>(f2);
                for (int j = 1; j < width; ++j) {
                    f1 = std::max(Hh[j - 1] - oe1, f1 - e1);
                    f2 = std::max(Hh[j - 1] - oe2, f2 - e2);
                    F1row[j] = clamp_store<T>(f1);
                    F2row[j] = clamp_store<T>(f2);
                }
                for (int j = 0; j < width; ++j) {
                    int32_t hrow = std::max(std::max(Hh[j], (int32_t)F1row[j]),
                                            (int32_t)F2row[j]);
                    if (local) hrow = std::max(hrow, 0);
                    int32_t e1n = std::max((int32_t)(E1r[j] - e1), hrow - oe1);
                    int32_t e2n = std::max((int32_t)(E2r[j] - e2), hrow - oe2);
                    if (local) {
                        e1n = std::max(e1n, 0);
                        e2n = std::max(e2n, 0);
                    }
                    Hrow[j] = clamp_store<T>(hrow);
                    E1row[j] = clamp_store<T>(e1n);
                    E2row[j] = clamp_store<T>(e2n);
                }
            } else {
                int32_t f1 = Mq[0] - oe1;
                F1row[0] = clamp_store<T>(f1);
                for (int j = 1; j < width; ++j) {
                    f1 = std::max(Hh[j - 1] - oe1, f1 - e1);
                    F1row[j] = clamp_store<T>(f1);
                }
                const int32_t dead = local ? 0 : inf;
                for (int j = 0; j < width; ++j) {
                    int32_t hrow = std::max(Hh[j], (int32_t)F1row[j]);
                    if (local) hrow = std::max(hrow, 0);
                    // affine E kill when F strictly dominates H
                    // (abpoa_align_simd.c:926-930)
                    int32_t e1n = (hrow == Hh[j])
                        ? std::max((int32_t)(E1r[j] - e1), hrow - oe1) : dead;
                    Hrow[j] = clamp_store<T>(hrow);
                    E1row[j] = clamp_store<T>(e1n);
                }
            }
        }

        // ---- row max: local/extend scoring + adaptive band ----------------
        if (local || extend || banded) {
            // vectorizable max reduction, then first/last-equal scans
            const T* Hp = dp.H.data() + pi;
            int32_t mx = inf;
            for (int j = 0; j < width; ++j) mx = std::max(mx, (int32_t)Hp[j]);
            int left = -1, right = -1;
            if (mx > inf) {
                int j = 0;
                while ((int32_t)Hp[j] != mx) ++j;
                left = b + j;
                j = width - 1;
                while ((int32_t)Hp[j] != mx) --j;
                right = b + j;
            }
            if (local) {
                if (mx > best_score) { best_score = mx; best_i = i; best_j = left; }
            } else if (extend) {
                if (mx > best_score) {
                    best_score = mx; best_i = i; best_j = right; best_nid = nid;
                } else if (params[4] > 0) {
                    int delta = g.max_remain[best_nid] - g.max_remain[nid];
                    if (best_score - mx > params[4] + e1 * std::abs(delta - (right - best_j))) {
                        zdropped = true;
                        break;
                    }
                }
            }
            if (banded) {
                for (int out_id : g.nodes[nid].out_ids) {
                    if (right + 1 > g.mpr[out_id]) g.mpr[out_id] = right + 1;
                    if (left + 1 < g.mpl[out_id]) g.mpl[out_id] = left + 1;
                }
            }
        }
    }

    // ---- global best over the end node's in-rows --------------------------
    if (align_mode == 0) {
        for (int in_id : g.nodes[end_node_id].in_ids) {
            int idx = g.node_id_to_index[in_id];
            if (!index_map[idx]) continue;
            int i = idx - beg_index;
            int e = std::min(qlen, (int)dp.end[i]);
            int32_t v = dp.h(i, e);
            if (v > best_score) { best_score = v; best_i = i; best_j = e; }
        }
    }
    meta[0] = best_score;
    if (!ret_cigar) { meta[7] = 0; return 0; }

    // ---- backtrack (reference op priority, abpoa_align_simd.c:116-458) ----
    CigBuf cig{cigar_out, cigar_cap};
    int i = best_i, j = best_j;
    int start_i = best_i, start_j = best_j;
    int nid = g.index_to_node_id[i + beg_index];
    if (best_j < qlen) cig.push(1, qlen - best_j, -1, qlen - 1);
    int look_gap = put_gap_at_end_flag ? 1 : 0;
    int cur_op = 0x1F;  // ALL
    const int M_OP = 1, E1_OP = 2, E2_OP = 4, F1_OP = 8, F2_OP = 16;
    while (i > 0 && j > 0) {
        if (local && dp.h(i, j) == 0) break;
        start_i = i; start_j = j;
        int32_t s = mat[(int64_t)g.nodes[nid].base * m + query[j - 1]];
        bool is_match = g.nodes[nid].base == query[j - 1];
        bool hit = false;
        int32_t Hij = dp.h(i, j);

        auto try_match = [&]() -> bool {
            for (int32_t t = pre_off[i]; t < pre_off[i + 1]; ++t) {
                const int p = pre_flat[t];
                const int32_t ps = inc_ps ? pre_ps[t] : 0;
                if (j - 1 < dp.beg[p] || j - 1 > dp.end[p]) continue;
                if (dp.h(p, j - 1) + s + ps == Hij) {
                    cig.push(0, 1, nid, j - 1);
                    i = p; --j; nid = g.index_to_node_id[i + beg_index];
                    cur_op = 0x1F;
                    meta[5]++; if (is_match) meta[6]++;
                    return true;
                }
            }
            return false;
        };

        if (!gap_on_right && look_gap == 0 && (linear || (cur_op & M_OP)))
            hit = try_match();

        if (!hit) {  // deletion
            if (linear) {
                for (int32_t t = pre_off[i]; t < pre_off[i + 1]; ++t) {
                    const int p = pre_flat[t];
                    const int32_t ps = inc_ps ? pre_ps[t] : 0;
                    if (j < dp.beg[p] || j > dp.end[p]) continue;
                    if (dp.h(p, j) - e1 + ps == Hij) {
                        cig.push(2, 1, nid, j - 1);
                        i = p; nid = g.index_to_node_id[i + beg_index];
                        hit = true; look_gap = 0;
                        break;
                    }
                }
            } else if (cur_op & (E1_OP | E2_OP)) {
                for (int32_t t = pre_off[i]; t < pre_off[i + 1]; ++t) {
                    const int p = pre_flat[t];
                    const int32_t ps = inc_ps ? pre_ps[t] : 0;
                    if (j < dp.beg[p] || j > dp.end[p]) continue;
                    bool done = false;
                    if (cur_op & E1_OP) {
                        bool cond = (cur_op & M_OP)
                            ? (Hij == dp.e1(p, j) + ps)
                            : (dp.e1(i, j) == dp.e1(p, j) - e1 + ps);
                        if (cond) {
                            cur_op = (dp.h(p, j) - oe1 == dp.e1(p, j))
                                ? (M_OP | F1_OP | F2_OP) : E1_OP;
                            cig.push(2, 1, nid, j - 1);
                            i = p; nid = g.index_to_node_id[i + beg_index];
                            hit = done = true; look_gap = 0;
                        }
                    }
                    if (!done && convex && (cur_op & E2_OP)) {
                        bool cond = (cur_op & M_OP)
                            ? (Hij == dp.e2(p, j) + ps)
                            : (dp.e2(i, j) == dp.e2(p, j) - e2 + ps);
                        if (cond) {
                            cur_op = (dp.h(p, j) - oe2 == dp.e2(p, j))
                                ? (M_OP | F1_OP | F2_OP) : E2_OP;
                            cig.push(2, 1, nid, j - 1);
                            i = p; nid = g.index_to_node_id[i + beg_index];
                            hit = done = true; look_gap = 0;
                        }
                    }
                    if (done) break;
                }
            }
        }

        if (!hit) {  // insertion
            if (linear) {
                if (dp.h(i, j - 1) - e1 == Hij) {
                    cig.push(1, 1, nid, j - 1);
                    --j; look_gap = 0; hit = true; meta[5]++;
                }
            } else if (cur_op & (F1_OP | F2_OP)) {
                bool got = false;
                if (cur_op & F1_OP) {
                    bool gate = (cur_op & M_OP) ? (Hij == dp.f1(i, j)) : true;
                    if (gate) {
                        if (dp.h(i, j - 1) - oe1 == dp.f1(i, j)) {
                            cur_op = M_OP | E1_OP | E2_OP; got = true;
                        } else if (dp.f1(i, j - 1) - e1 == dp.f1(i, j)) {
                            cur_op = F1_OP; got = true;
                        }
                    }
                }
                if (!got && convex && (cur_op & F2_OP)) {
                    bool gate = (cur_op & M_OP) ? (Hij == dp.f2(i, j)) : true;
                    if (gate) {
                        if (dp.h(i, j - 1) - oe2 == dp.f2(i, j)) {
                            cur_op = M_OP | E1_OP | E2_OP; got = true;
                        } else if (dp.f2(i, j - 1) - e2 == dp.f2(i, j)) {
                            cur_op = F2_OP; got = true;
                        }
                    }
                }
                if (got) {
                    cig.push(1, 1, nid, j - 1);
                    --j; look_gap = 0; hit = true; meta[5]++;
                }
            }
        }

        if (!hit && (linear || (cur_op & M_OP))) {
            hit = try_match();
            if (hit) look_gap = 0;
        }
        if (!hit) return -1;  // backtrack failure -> caller falls back
    }
    if (j > 0) cig.push(1, j, -1, j - 1);
    if (cig.overflow) return -2;
    // reverse (reference emits back-to-front then reverses)
    for (int a = 0, bb = cig.n - 1; a < bb; ++a, --bb)
        std::swap(cigar_out[a], cigar_out[bb]);
    meta[1] = g.index_to_node_id[start_i + beg_index];
    meta[2] = g.index_to_node_id[best_i + beg_index];
    meta[3] = start_j - 1;
    meta[4] = best_j - 1;
    meta[7] = cig.n;
    return 0;
}
