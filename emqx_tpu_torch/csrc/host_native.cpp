// emqx_tpu_torch host library: word interning, batch topic encoding,
// the route trie, its CSR flatten and level compression, the host
// match and the MQTT frame scanner -- the host engine under the port's
// router and front door. Host C++ only; no CUDA.
//
// The authoritative trie lives in this library and is flattened
// straight into caller-provided numpy buffers, which the port's
// ops/convert.py places on the torch device. The Python side
// (emqx_tpu_torch/ops/native.py) binds it with ctypes. The code is
// kept identical to the JAX package's engine (native/emqx_native.cpp)
// so the two give byte-equal arrays (tests/test_torch_native.py).
//
// Semantics mirror emqx_tpu_torch/oracle.py + ops/csr.py exactly:
// '#' children collapse into hash_filter, '+' children are ordinary
// states, literal edges are CSR rows sorted by word id, state 0 is the
// root.
//
// Build: emqx_tpu_torch/ops/_build.py::build_host
//   (g++ -O2 -fPIC -std=c++17 -shared, at first use)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Word table: string -> dense int32 id (append-only interning)
// ---------------------------------------------------------------------------

struct WordTable {
    std::unordered_map<std::string, int32_t> ids;
    std::vector<std::string> words;
};

WordTable* wt_new() { return new WordTable(); }
void wt_free(WordTable* wt) { delete wt; }
int32_t wt_size(WordTable* wt) { return (int32_t)wt->words.size(); }

// word string by intern id (checkpoint export): copies up to cap
// bytes into out, returns the word's byte length (-1 = bad id)
int32_t wt_word_at(WordTable* wt, int32_t idx, char* out, int32_t cap) {
    if (idx < 0 || (size_t)idx >= wt->words.size()) return -1;
    const std::string& w = wt->words[(size_t)idx];
    int32_t n = (int32_t)w.size();
    if (out && cap > 0) {
        int32_t c = n < cap ? n : cap;
        memcpy(out, w.data(), (size_t)c);
    }
    return n;
}

int32_t wt_intern(WordTable* wt, const char* word, int32_t len) {
    std::string w(word, len);
    auto it = wt->ids.find(w);
    if (it != wt->ids.end()) return it->second;
    int32_t id = (int32_t)wt->words.size();
    wt->ids.emplace(std::move(w), id);
    wt->words.push_back(std::string(word, len));
    return id;
}

int32_t wt_lookup(WordTable* wt, const char* word, int32_t len) {
    auto it = wt->ids.find(std::string(word, len));
    return it == wt->ids.end() ? -1 : it->second;
}

// copy word i into buf (caller sized via wt_word_len)
int32_t wt_word_len(WordTable* wt, int32_t id) {
    if (id < 0 || id >= (int32_t)wt->words.size()) return -1;
    return (int32_t)wt->words[id].size();
}
void wt_word_copy(WordTable* wt, int32_t id, char* buf) {
    const std::string& w = wt->words[id];
    memcpy(buf, w.data(), w.size());
}

// ---------------------------------------------------------------------------
// Batch topic encoder (emqx_tpu_torch/ops/tokenize.encode_batch)
// topics: concatenated utf-8 blob; offsets[n+1] delimit each topic.
// out_ids[n*max_levels] filled with PAD(-2)/UNKNOWN(-1)/word ids;
// out_n[n] = word count or -1 when levels exceed max_levels;
// out_sys[n] = 1 when the first word starts with '$'.
// ---------------------------------------------------------------------------

void encode_topics(WordTable* wt, const char* blob, const int64_t* offsets,
                   int32_t n, int32_t max_levels, int32_t* out_ids,
                   int32_t* out_n, uint8_t* out_sys) {
    for (int32_t i = 0; i < n; i++) {
        const char* t = blob + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        int32_t* row = out_ids + (int64_t)i * max_levels;
        for (int32_t j = 0; j < max_levels; j++) row[j] = -2;  // PAD
        int32_t nw = 0;
        int64_t start = 0;
        bool overflow = false;
        for (int64_t p = 0; p <= len; p++) {
            if (p == len || t[p] == '/') {
                if (nw >= max_levels) { overflow = true; break; }
                row[nw++] = wt_lookup(wt, t + start, (int32_t)(p - start));
                start = p + 1;
            }
        }
        if (overflow)  // too many levels: leave the row fully padded
            for (int32_t j = 0; j < max_levels; j++) row[j] = -2;
        out_n[i] = overflow ? -1 : nw;
        // parity with Python encode_batch: over-level rows keep
        // sys_mask False (they never reach the kernel anyway)
        out_sys[i] = (!overflow && len > 0 && t[0] == '$') ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// Trie + CSR flattening (emqx_tpu_torch/oracle.TrieOracle + ops/csr.py)
// ---------------------------------------------------------------------------

struct TrieNode {
    // word id -> child node index; '#'/'+' tracked separately
    std::unordered_map<int32_t, int32_t> lits;
    int32_t plus = -1;        // node index of '+' child
    int32_t hash_filter = -1; // filter id of '#'-child terminal
    int32_t filter = -1;      // filter id terminating here
    int32_t refcount = 0;     // live filters through this node
};

struct Trie {
    WordTable* wt;           // shared, not owned
    std::vector<TrieNode> nodes;
    std::vector<int32_t> free_nodes;  // pruned slots for reuse
    int32_t plus_id;         // interned ids of "+" and "#"
    int32_t hash_id;
    // live literal-edge count, maintained incrementally on
    // insert/prune so trie_counts is O(1) instead of a full DFS —
    // the off-lock compaction flatten pays counts+flatten back to
    // back, and at 1M filters the DFS prepass was a visible slice
    // of the rebuild (docs/DELTA.md)
    int64_t live_edges = 0;
    std::unordered_map<std::string, int32_t> filter_refs;

    explicit Trie(WordTable* w) : wt(w) {
        nodes.emplace_back();  // root = 0
        plus_id = wt_intern(w, "+", 1);
        hash_id = wt_intern(w, "#", 1);
    }

    int32_t alloc_node() {
        if (!free_nodes.empty()) {
            int32_t i = free_nodes.back();
            free_nodes.pop_back();
            return i;
        }
        nodes.emplace_back();
        return (int32_t)nodes.size() - 1;
    }

    void release_node(int32_t i) {
        nodes[i].lits.clear();
        nodes[i].plus = -1;
        nodes[i].hash_filter = -1;
        nodes[i].filter = -1;
        nodes[i].refcount = 0;
        free_nodes.push_back(i);
    }
};

Trie* trie_new(WordTable* wt) { return new Trie(wt); }
void trie_free(Trie* t) { delete t; }
int32_t trie_num_filters(Trie* t) { return (int32_t)t->filter_refs.size(); }

// split filter into interned word ids
static void split_intern(Trie* t, const char* f, int32_t len,
                         std::vector<int32_t>& out) {
    int32_t start = 0;
    for (int32_t p = 0; p <= len; p++) {
        if (p == len || f[p] == '/') {
            out.push_back(wt_intern(t->wt, f + start, p - start));
            start = p + 1;
        }
    }
}

// insert filter with dense id; returns 1 if newly added
int32_t trie_insert(Trie* t, const char* filter, int32_t len,
                    int32_t filter_id) {
    std::string key(filter, len);
    auto it = t->filter_refs.find(key);
    if (it != t->filter_refs.end()) { it->second++; return 0; }
    t->filter_refs.emplace(std::move(key), 1);
    std::vector<int32_t> ws;
    split_intern(t, filter, len, ws);
    int32_t node = 0;
    for (size_t i = 0; i < ws.size(); i++) {
        int32_t w = ws[i];
        t->nodes[node].refcount++;
        if (w == t->hash_id) {
            // '#' must be last word: collapse into hash_filter
            t->nodes[node].hash_filter = filter_id;
            return 1;
        }
        int32_t child;
        if (w == t->plus_id) {
            child = t->nodes[node].plus;
            if (child < 0) {
                child = t->alloc_node();
                t->nodes[node].plus = child;
            }
        } else {
            auto e = t->nodes[node].lits.find(w);
            if (e == t->nodes[node].lits.end()) {
                child = t->alloc_node();
                t->nodes[node].lits.emplace(w, child);
                t->live_edges++;
            } else {
                child = e->second;
            }
        }
        node = child;
    }
    t->nodes[node].refcount++;
    t->nodes[node].filter = filter_id;
    return 1;
}

// delete filter; returns 1 when fully removed (refcount reached 0).
// Dead path nodes are physically pruned into a free list (a node at
// refcount 0 had exactly one filter through it, so its subtree is the
// remaining path suffix — unwound leaf-to-root below).
int32_t trie_delete(Trie* t, const char* filter, int32_t len) {
    std::string key(filter, len);
    auto it = t->filter_refs.find(key);
    if (it == t->filter_refs.end()) return 0;
    if (--it->second > 0) return 0;
    t->filter_refs.erase(it);
    std::vector<int32_t> ws;
    split_intern(t, filter, len, ws);
    int32_t node = 0;
    std::vector<std::pair<int32_t, int32_t>> edges;  // (parent, word)
    for (size_t i = 0; i < ws.size(); i++) {
        int32_t w = ws[i];
        t->nodes[node].refcount--;
        if (w == t->hash_id) {
            t->nodes[node].hash_filter = -1;
            node = -1;
            break;
        }
        edges.emplace_back(node, w);
        node = (w == t->plus_id) ? t->nodes[node].plus
                                 : t->nodes[node].lits[w];
    }
    if (node >= 0) {
        t->nodes[node].refcount--;
        t->nodes[node].filter = -1;
    }
    // prune dead suffix (emqx_trie delete_path / oracle.py prune loop)
    for (size_t i = edges.size(); i-- > 0;) {
        int32_t parent = edges[i].first;
        int32_t w = edges[i].second;
        int32_t child = (w == t->plus_id) ? t->nodes[parent].plus
                                          : t->nodes[parent].lits[w];
        if (t->nodes[child].refcount > 0) break;
        if (w == t->plus_id) {
            t->nodes[parent].plus = -1;
        } else {
            t->nodes[parent].lits.erase(w);
            t->live_edges--;
        }
        t->release_node(child);
    }
    return 1;
}

// live state/edge counts for capacity sizing (dead subtrees excluded)
struct FlattenCounts { int64_t states; int64_t edges; };

static void count_live(Trie* t, int32_t ni, int64_t& states,
                       int64_t& edges) {
    // iterative DFS
    std::vector<int32_t> stack{ni};
    while (!stack.empty()) {
        int32_t cur = stack.back(); stack.pop_back();
        states++;
        TrieNode& nd = t->nodes[cur];
        for (auto& kv : nd.lits) {
            if (t->nodes[kv.second].refcount > 0) {
                edges++;
                stack.push_back(kv.second);
            }
        }
        if (nd.plus >= 0 && t->nodes[nd.plus].refcount > 0)
            stack.push_back(nd.plus);
    }
}

// O(1): every allocated-and-not-released node is live (the delete
// prune releases the whole refcount-0 suffix and erases its parent
// edges), so the DFS reduces to arithmetic over maintained counters
void trie_counts(Trie* t, int64_t* out_states, int64_t* out_edges) {
    *out_states = (int64_t)t->nodes.size()
                  - (int64_t)t->free_nodes.size();
    *out_edges = t->live_edges;
}

// the old DFS, kept as the parity oracle for the O(1) counters
// (tests/test_native.py cross-checks after randomized churn)
void trie_counts_scan(Trie* t, int64_t* out_states, int64_t* out_edges) {
    int64_t s = 0, e = 0;
    count_live(t, 0, s, e);
    *out_states = s;
    *out_edges = e;
}

// Flatten into caller buffers (capacities pre-sized via trie_counts):
//   row_ptr[s_cap+1], edge_word[e_cap], edge_child[e_cap],
//   plus_child[s_cap], hash_filter[s_cap], end_filter[s_cap]
// Returns number of live states, or -1 if capacities are too small.
int64_t trie_flatten(Trie* t, int64_t s_cap, int64_t e_cap,
                     int32_t* row_ptr, int32_t* edge_word,
                     int32_t* edge_child, int32_t* plus_child,
                     int32_t* hash_filter, int32_t* end_filter) {
    const int32_t WORD_PAD = INT32_MAX;
    // BFS assigning dense ids (root first — matches csr.py)
    std::vector<int32_t> order;            // trie node index per state
    std::vector<int32_t> state_of(t->nodes.size(), -1);
    order.push_back(0);
    state_of[0] = 0;
    for (size_t qi = 0; qi < order.size(); qi++) {
        TrieNode& nd = t->nodes[order[qi]];
        // deterministic order: sort lit edges by word id
        for (auto& kv : nd.lits) {
            if (t->nodes[kv.second].refcount <= 0) continue;
            if (state_of[kv.second] < 0) {
                state_of[kv.second] = (int32_t)order.size();
                order.push_back(kv.second);
            }
        }
        if (nd.plus >= 0 && t->nodes[nd.plus].refcount > 0 &&
            state_of[nd.plus] < 0) {
            state_of[nd.plus] = (int32_t)order.size();
            order.push_back(nd.plus);
        }
    }
    int64_t S = (int64_t)order.size();
    if (S > s_cap) return -1;

    int64_t pos = 0;
    std::vector<std::pair<int32_t, int32_t>> row;
    for (int64_t s = 0; s < S; s++) {
        TrieNode& nd = t->nodes[order[s]];
        row_ptr[s] = (int32_t)pos;
        row.clear();
        for (auto& kv : nd.lits)
            if (t->nodes[kv.second].refcount > 0)
                row.emplace_back(kv.first, state_of[kv.second]);
        std::sort(row.begin(), row.end());
        if (pos + (int64_t)row.size() > e_cap) return -1;
        for (auto& e : row) {
            edge_word[pos] = e.first;
            edge_child[pos] = e.second;
            pos++;
        }
        plus_child[s] = (nd.plus >= 0 && t->nodes[nd.plus].refcount > 0)
                            ? state_of[nd.plus] : -1;
        hash_filter[s] = nd.hash_filter;
        end_filter[s] = nd.filter;
    }
    for (int64_t s = S; s <= s_cap; s++) row_ptr[s] = (int32_t)pos;
    for (int64_t e = pos; e < e_cap; e++) {
        edge_word[e] = WORD_PAD;
        edge_child[e] = -1;
    }
    for (int64_t s = S; s < s_cap; s++) {
        plus_child[s] = -1;
        hash_filter[s] = -1;
        end_filter[s] = -1;
    }
    return S;
}

// ---------------------------------------------------------------------------
// Level compression (ops/csr.py compress_automaton, wide mode)
// ---------------------------------------------------------------------------
// Fuse chains of single-child literal levels into one multi-word edge
// directly from the v1 CSR flatten, so deep literal spines collapse
// from one walk hop per level to one hop per wildcard-branch point.
// Semantics mirror the numpy compressor BIT-FOR-BIT (same hop-BFS
// emission order, same renumbering, same narrow/wide decision) —
// parity pinned by tests/test_native.py against compress_automaton.
//
// Outputs (filled only when the chosen mode is wide; the caller runs
// the cheap numpy narrow path otherwise):
//   e_src/e_word/e_take/e_child[e_cap], e_cw[e_cap*(max_take-1)],
//   node2[s_cap*4], v2_hop/v2_depth[s_cap] (dense, v2 ids),
//   hops_for_level[hl_cap].
// out_info[4] = {S2, E2, maxdepth, mode(1=wide, 0=narrow)}.
// Returns 0 on success, -1 when a capacity is too small.

int32_t csr_compress(const int32_t* row_ptr, const int32_t* edge_word,
                     const int32_t* edge_child,
                     const int32_t* plus_child,
                     const int32_t* hash_filter,
                     const int32_t* end_filter,
                     int64_t S, int32_t max_take,
                     int64_t e_cap, int64_t s_cap, int64_t hl_cap,
                     int32_t* e_src, int32_t* e_word, int32_t* e_take,
                     int32_t* e_child, int32_t* e_cw,
                     int32_t* node2, int16_t* v2_hop, int16_t* v2_depth,
                     int32_t* hops_for_level, int64_t* out_info) {
    const int32_t CHAIN_PAD = -3;  // csr.py CW_PAD
    const int32_t R = max_take;

    // depth per state (tree ⇒ unique regardless of traversal order)
    std::vector<int32_t> depth(S, -1);
    depth[0] = 0;
    {
        std::vector<int64_t> frontier{0}, nxt;
        int32_t d = 0;
        while (!frontier.empty()) {
            d++;
            nxt.clear();
            for (int64_t s : frontier) {
                for (int32_t e = row_ptr[s]; e < row_ptr[s + 1]; e++) {
                    depth[edge_child[e]] = d;
                    nxt.push_back(edge_child[e]);
                }
                if (plus_child[s] >= 0) {
                    depth[plus_child[s]] = d;
                    nxt.push_back(plus_child[s]);
                }
            }
            frontier.swap(nxt);
        }
    }
    int32_t maxdepth = 0;
    if (S > 1)
        for (int64_t s = 0; s < S; s++)
            if (depth[s] > maxdepth) maxdepth = depth[s];

    // chain interiors: exactly one literal child, no '+', no
    // terminals (the states the walk can skip); links[s] = skippable
    // hops below s, built deepest-first so children resolve first
    std::vector<uint8_t> elig(S, 0);
    for (int64_t s = 1; s < S; s++) {
        int32_t deg = row_ptr[s + 1] - row_ptr[s];
        elig[s] = (deg == 1 && plus_child[s] < 0 &&
                   hash_filter[s] < 0 && end_filter[s] < 0);
    }
    std::vector<int32_t> links(S, 0);
    {
        // counting sort by depth (descending sweep)
        std::vector<std::vector<int64_t>> by_depth(maxdepth + 1);
        for (int64_t s = 0; s < S; s++)
            if (elig[s]) by_depth[depth[s]].push_back(s);
        for (int32_t d = maxdepth; d >= 1; d--)
            for (int64_t s : by_depth[d])
                links[s] = 1 + links[edge_child[row_ptr[s]]];
    }

    // hop-BFS over the compressed graph: materialize branch states in
    // discovery order, emit one compressed edge per (src, literal)
    std::vector<int16_t> hop(S, -1);
    hop[0] = 0;
    std::vector<int64_t> mat{0};
    std::vector<int64_t> frontier{0}, next_lit, next_plus;
    int64_t E2 = 0;
    while (!frontier.empty()) {
        next_lit.clear();
        next_plus.clear();
        for (int64_t s : frontier) {
            for (int32_t e = row_ptr[s]; e < row_ptr[s + 1]; e++) {
                if (E2 >= e_cap) return -1;
                int64_t cur = edge_child[e];
                int32_t j = links[cur] < R - 1 ? links[cur] : R - 1;
                int32_t* cw = e_cw + E2 * (R - 1);
                for (int32_t i = 0; i < R - 1; i++) cw[i] = CHAIN_PAD;
                for (int32_t i = 0; i < j; i++) {
                    int32_t e0 = row_ptr[cur];
                    cw[i] = edge_word[e0];
                    cur = edge_child[e0];
                }
                hop[cur] = (int16_t)(hop[s] + 1);
                e_src[E2] = (int32_t)s;  // v1 ids; renumbered below
                e_word[E2] = edge_word[e];
                e_take[E2] = 1 + j;
                e_child[E2] = (int32_t)cur;
                E2++;
                next_lit.push_back(cur);
            }
        }
        for (int64_t s : frontier)
            if (plus_child[s] >= 0) {
                hop[plus_child[s]] = (int16_t)(hop[s] + 1);
                next_plus.push_back(plus_child[s]);
            }
        frontier.clear();
        frontier.insert(frontier.end(), next_lit.begin(),
                        next_lit.end());
        frontier.insert(frontier.end(), next_plus.begin(),
                        next_plus.end());
        mat.insert(mat.end(), frontier.begin(), frontier.end());
    }
    int64_t S2 = (int64_t)mat.size();
    if (S2 > s_cap) return -1;
    if (maxdepth + 1 > hl_cap) return -1;

    for (int32_t d = 0; d <= maxdepth; d++) hops_for_level[d] = 0;
    for (int64_t i = 0; i < S2; i++) {
        int32_t d = depth[mat[i]];
        int32_t h = hop[mat[i]] + 1;
        if (h > hops_for_level[d]) hops_for_level[d] = h;
    }
    for (int32_t d = 1; d <= maxdepth; d++)
        if (hops_for_level[d - 1] > hops_for_level[d])
            hops_for_level[d] = hops_for_level[d - 1];
    for (int32_t d = 0; d <= maxdepth; d++)
        if (hops_for_level[d] < 1) hops_for_level[d] = 1;

    // the same mode rule the numpy compressor applies (csr.py): wide
    // only when compression shortens the deepest walk by ≥ 2 steps
    // and the packed (state << 5 | level) lane word can hold the ids
    int32_t saved = (maxdepth + 1) - hops_for_level[maxdepth];
    int32_t mode = (saved >= 2 && S2 < ((int64_t)1 << 26) &&
                    maxdepth <= 31) ? 1 : 0;
    out_info[0] = S2;
    out_info[1] = E2;
    out_info[2] = maxdepth;
    out_info[3] = mode;
    if (mode == 0) return 0;  // caller runs the numpy narrow path

    std::vector<int32_t> newid(S, -1);
    for (int64_t i = 0; i < S2; i++) newid[mat[i]] = (int32_t)i;
    for (int64_t e = 0; e < E2; e++) {
        e_src[e] = newid[e_src[e]];
        e_child[e] = newid[e_child[e]];
    }
    for (int64_t i = 0; i < S2; i++) {
        int64_t m = mat[i];
        int32_t pc = plus_child[m];
        node2[i * 4 + 0] = pc >= 0 ? newid[pc] : -1;
        node2[i * 4 + 1] = hash_filter[m];
        node2[i * 4 + 2] = end_filter[m];
        node2[i * 4 + 3] = -1;
        v2_hop[i] = hop[m];
        v2_depth[i] = (int16_t)depth[m];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Host-side oracle match (fallback path, emqx_tpu_torch/oracle.py semantics)
// Returns count of matched filter ids written to out (max out_cap).
// ---------------------------------------------------------------------------

static void match_node(Trie* t, int32_t node, const int32_t* ws,
                       int32_t n, int32_t i, int32_t* out,
                       int32_t out_cap, int32_t* cnt) {
    TrieNode& nd = t->nodes[node];
    if (nd.hash_filter >= 0 && *cnt < out_cap)
        out[(*cnt)++] = nd.hash_filter;
    if (i == n) {
        if (nd.filter >= 0 && *cnt < out_cap) out[(*cnt)++] = nd.filter;
        return;
    }
    int32_t w = ws[i];
    // lits never hold '+'/'#' keys (insert routes them to plus/
    // hash_filter), so wildcard words in publish names can't descend
    // here — matching oracle.py's guards
    if (w >= 0) {
        auto it = nd.lits.find(w);
        if (it != nd.lits.end() && t->nodes[it->second].refcount > 0)
            match_node(t, it->second, ws, n, i + 1, out, out_cap, cnt);
    }
    if (nd.plus >= 0 && t->nodes[nd.plus].refcount > 0)
        match_node(t, nd.plus, ws, n, i + 1, out, out_cap, cnt);
}

int32_t trie_match(Trie* t, const char* topic, int32_t len, int32_t* out,
                   int32_t out_cap) {
    // tokenize (lookup only — unknown words can still match wildcards)
    std::vector<int32_t> ws;
    int32_t start = 0;
    for (int32_t p = 0; p <= len; p++) {
        if (p == len || topic[p] == '/') {
            ws.push_back(wt_lookup(t->wt, topic + start, p - start));
            start = p + 1;
        }
    }
    int32_t cnt = 0;
    bool sys = len > 0 && topic[0] == '$';
    if (sys) {
        if (ws[0] >= 0) {
            auto it = t->nodes[0].lits.find(ws[0]);
            if (it != t->nodes[0].lits.end() &&
                t->nodes[it->second].refcount > 0)
                match_node(t, it->second, ws.data(), (int32_t)ws.size(),
                           1, out, out_cap, &cnt);
        }
    } else {
        match_node(t, 0, ws.data(), (int32_t)ws.size(), 0, out, out_cap,
                   &cnt);
    }
    return cnt;
}

// ---------------------------------------------------------------------------
// MQTT frame scanner — the wire-framing hot loop
// ---------------------------------------------------------------------------
// The reference frames packets in the BEAM's native binary machinery
// (emqx_frame.erl pattern matches compile to BIF byte ops); the
// Python port's per-byte varint/slice loop is the live path's single
// biggest interpreter cost, so framing drops to C here. The scanner
// only SPLITS frames and pre-slices the PUBLISH layout — packet-body
// semantics (v5 properties, errors, every non-PUBLISH type) stay in
// Python (emqx_tpu_torch/mqtt/frame.py) so behavior/parity is pinned
// by the fuzz suites.
//
// Output: 7 int32 per frame:
//   [0] header byte   [1] body offset   [2] body length
//   [3] topic offset (-1 = not a pre-sliced PUBLISH)
//   [4] topic length  [5] packet id (-1 = QoS0)
//   [6] post-topic/pid offset (v4: payload start; v5: properties)
// Returns the frame count (>= 0), -1 on a malformed varint, -2 when a
// frame exceeds max_size. state[0] = bytes consumed; state[1] = the
// oversized frame's total size (for the -2 error message).

int32_t mqtt_scan(const uint8_t* buf, int64_t len, int64_t max_size,
                  int32_t max_frames, int32_t* out, int64_t* state) {
    int64_t pos = 0;
    int32_t nf = 0;
    state[1] = 0;
    while (nf < max_frames) {
        if (len - pos < 2) break;
        uint8_t header = buf[pos];
        int64_t rl = 0, mult = 1, i = 1;
        bool complete_varint = false, partial = false;
        for (;;) {
            if (pos + i >= len) {
                if (i > 4) { state[0] = pos; return -1; }
                partial = true;
                break;
            }
            uint8_t b = buf[pos + i];
            rl += (int64_t)(b & 0x7F) * mult;
            i++;
            if (!(b & 0x80)) { complete_varint = true; break; }
            if (i > 4) { state[0] = pos; return -1; }
            mult *= 128;
        }
        if (partial || !complete_varint) break;
        if (i + rl > max_size) {
            state[0] = pos;
            state[1] = i + rl;
            return -2;
        }
        if (len - pos < i + rl) break;
        int32_t* row = out + (int64_t)nf * 7;
        row[0] = header;
        row[1] = (int32_t)(pos + i);
        row[2] = (int32_t)rl;
        row[3] = -1;
        row[4] = 0;
        row[5] = -1;
        row[6] = -1;
        if ((header >> 4) == 3) {  // PUBLISH
            int32_t qos = (header >> 1) & 3;
            if (qos <= 2 && rl >= 2) {
                int64_t b0 = pos + i;
                int64_t tl = ((int64_t)buf[b0] << 8) | buf[b0 + 1];
                int64_t after = b0 + 2 + tl;
                bool ok = after <= b0 + rl;
                int32_t pid = -1;
                int64_t pp = after;
                if (ok && qos > 0) {
                    if (pp + 2 <= b0 + rl) {
                        pid = ((int32_t)buf[pp] << 8) | buf[pp + 1];
                        pp += 2;
                    } else {
                        ok = false;
                    }
                }
                if (ok) {
                    row[3] = (int32_t)(b0 + 2);
                    row[4] = (int32_t)tl;
                    row[5] = pid;
                    row[6] = (int32_t)pp;
                }
            }
        }
        pos += i + rl;
        nf++;
    }
    state[0] = pos;
    return nf;
}

// ---------------------------------------------------------------------------
// Stateful per-connection parser handle
// ---------------------------------------------------------------------------
// mqtt_scan is stateless: the Python caller owns the retained
// remainder and ships the WHOLE buffer across the ctypes boundary on
// every read — measured ~8% slower end-to-end than the Python loop
// because the per-feed marshalling costs more than the C parse saves.
// The handle inverts the ownership: the remainder lives HERE, a feed
// ships only the new bytes (one memcpy), and the scan resumes at the
// buffer front where at most one partial header re-decodes (O(1)).
// Descriptor rows are mqtt_scan's 7-int layout with offsets into the
// handle buffer; state[2] carries the buffer base address so Python
// can slice topic/payload zero-copy through a memoryview.
//
// feed() does NOT consume: the caller reports what it fully built via
// mqtt_parser_consume, so a frame whose Python-side body parse fails
// stays buffered — exactly the Python loop's raise-before-consume.
// A scan error (malformed varint / oversize) is reported in state[4]
// AFTER the descriptors of the complete frames preceding it, so the
// Python side parses those bodies first and surfaces errors in the
// same order the pure-Python loop would.
//
// state[0] = scan end (bytes consumable once every frame is built)
// state[1] = oversized frame's claimed size (err -2)
// state[2] = buffer base address   state[3] = buffered length
// state[4] = scan error: 0 ok, -1 malformed varint, -2 oversize

struct MqttParser {
    std::vector<uint8_t> buf;
    int64_t max_size;
};

void* mqtt_parser_new(int64_t max_size) {
    MqttParser* p = new MqttParser();
    p->max_size = max_size;
    return p;
}

void mqtt_parser_free(void* h) {
    delete static_cast<MqttParser*>(h);
}

int64_t mqtt_parser_pending(void* h) {
    return (int64_t)static_cast<MqttParser*>(h)->buf.size();
}

int32_t mqtt_parser_feed(void* h, const uint8_t* data, int64_t len,
                         int32_t max_frames, int32_t* out,
                         int64_t* state) {
    MqttParser* p = static_cast<MqttParser*>(h);
    if (len > 0) p->buf.insert(p->buf.end(), data, data + len);
    int64_t scan_state[2] = {0, 0};
    int32_t nf = mqtt_scan(p->buf.data(), (int64_t)p->buf.size(),
                           p->max_size, max_frames, out, scan_state);
    int32_t err = 0;
    if (nf < 0) {
        // mqtt_scan bails on the bad frame and loses the count of
        // the complete frames before it; rescan exactly that prefix
        // (scan_state[0] = bad frame's start) to recover their rows
        err = nf;
        int64_t prefix_state[2] = {0, 0};
        nf = mqtt_scan(p->buf.data(), scan_state[0], p->max_size,
                       max_frames, out, prefix_state);
    }
    state[0] = scan_state[0];
    state[1] = scan_state[1];
    state[2] = (int64_t)(intptr_t)p->buf.data();
    state[3] = (int64_t)p->buf.size();
    state[4] = err;
    return nf;
}

void mqtt_parser_consume(void* h, int64_t n) {
    MqttParser* p = static_cast<MqttParser*>(h);
    if (n <= 0) return;
    if (n >= (int64_t)p->buf.size()) p->buf.clear();
    else p->buf.erase(p->buf.begin(), p->buf.begin() + n);
    // a transient large PUBLISH must not pin its high-water capacity
    // on an idle connection forever — at 100K conns that's the fleet
    // bench's RSS floor
    if (p->buf.capacity() > 262144 && p->buf.size() < 4096)
        std::vector<uint8_t>(p->buf).swap(p->buf);
}

}  // extern "C"
