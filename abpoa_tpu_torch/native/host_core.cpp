// Native host graph of the per-read and seeded routes: the mutable POA graph
// between two alignments.
//
// Counterpart of abpoa_tpu/native/host_core.cpp (its graph core and the
// heaviest-bundling consensus; the host DP engine and the MSA ranks stay
// there, as the port runs its DP on the card and its MSA in Python). What
// lives here: cigar fusion (abPOA src/abpoa_graph.c:689-774), BFS
// topological sort with aligned-group atomicity (:221-266),
// weight-descending edge sort (:192-219), reverse-BFS max_remain
// (:268-309), the padded predecessor/out-edge tables the banded DP kernel
// B2 reads (apg_build_tables), the band write-back, the subgraph closure,
// the single-cluster heaviest-bundling consensus (apg_cons_hb), and the
// whole graph's export and import (apg_export, apg_get_band, apg_import).
//
// Exposed as a plain C ABI bound with ctypes (abpoa_tpu_torch/native).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

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
    std::vector<int32_t> ws_queue, ws_degree;  // BFS scratch (topo sort)

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
