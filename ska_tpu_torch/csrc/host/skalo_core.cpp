// skalo graph core: degenerate middle-base expansion, colored-De-Bruijn
// extremity detection, chain compaction, and bounded-depth bubble
// traversal, operating directly on the merged array's (keys, ascii
// variants) handed over by ska_tpu_torch/skalo/core.py.
//
// A verbatim copy of the JAX package's csrc/skalo_core.cpp (only this
// header differs), so that `ska lo` writes the same bytes in both
// packages. The python graph route it mentions below is the JAX
// package's; the port has none.
//
// Semantics mirror the reference (src/skalo/{extremities,compaction,
// read_graph}.rs) exactly as reproduced by the python implementation in
// ska_tpu/skalo/{graph,traverse}.py: edge lists keep insertion order
// (including duplicates), compacted chains collapse single-successor
// corridors between extremities, the DFS corridor-walks with per-branch
// visited-set copies, records every pass over an exit node, and groups
// filter on distinct second / second-to-last nodes plus most-common path
// length. The python DFS costs minutes at genome scale (4M k-mers,
// ~8M steps, 1.85M kept paths); this core runs it at C++ speed.
//
// Node keys are (k-1)-mers of up to 62 bases packed 2-bit as (hi, lo)
// uint64 pairs.

#include <algorithm>
#include <atomic>
#include <memory>
#include <system_error>
#include <thread>
#include <chrono>

#include "host_pool.h"
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Key {
    uint64_t hi, lo;
    bool operator==(const Key& o) const { return hi == o.hi && lo == o.lo; }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t x = k.lo * 0x9E3779B97F4A7C15ULL ^ (k.hi + 0x9E3779B97F4A7C15ULL);
        x ^= x >> 29; x *= 0xBF58476D1CE4E5B9ULL; x ^= x >> 32;
        return (size_t)x;
    }
};

// flat open-addressing Key -> int32 map (linear probing, pow2 capacity).
// std::unordered_map spends ~700ns per op on the 18M interning ops of a
// dense genome (node-per-bucket chasing); this is a single probe chain
// over contiguous memory.
struct FlatKeyMap {
    // Two interleaved-slot layouts so a probe touches ONE cache line
    // (profiled: the 17.9M interning probes of a dense genome were the
    // single largest cost at 28% CPU with keys/vals/used in separate
    // arrays — three lines per probe). `narrow` stores lo-only keys
    // (valid whenever keys fit 62 bits, i.e. len_kmer <= 31, so ~0 is a
    // free empty sentinel); insertion ids are assigned by the caller in
    // arrival order, so the layout never affects output semantics.
    struct Slot64 { uint64_t k; int32_t v; };        // 16B padded
    struct Slot128 { Key k; int32_t v; uint8_t used; };  // 24B padded
    static constexpr uint64_t EMPTY64 = ~0ULL;
    bool narrow = false;
    std::vector<Slot64> s64;
    std::vector<Slot128> s128;
    size_t mask = 0, count = 0, limit = 0;

    void reserve(size_t expect, bool narrow_keys) {
        narrow = narrow_keys;
        size_t cap = 1024;
        while (cap * 3 < expect * 4) cap <<= 1;  // <= 0.75 load at `expect`
        rehash(cap);
    }
    void rehash(size_t cap) {
        mask = cap - 1;
        limit = cap - cap / 4;
        count = 0;
        if (narrow) {
            std::vector<Slot64> old = std::move(s64);
            s64.assign(cap, Slot64{EMPTY64, 0});
            for (auto& s : old)
                if (s.k != EMPTY64) *slot_fresh(Key{0, s.k}) = s.v;
        } else {
            std::vector<Slot128> old = std::move(s128);
            s128.assign(cap, Slot128{Key{0, 0}, 0, 0});
            for (auto& s : old)
                if (s.used) *slot_fresh(s.k) = s.v;
        }
    }
    int32_t* slot_fresh(const Key& k) {  // insert, key known absent
        size_t i = KeyHash{}(k) & mask;
        count++;
        if (narrow) {
            while (s64[i].k != EMPTY64) i = (i + 1) & mask;
            s64[i].k = k.lo;
            return &s64[i].v;
        }
        while (s128[i].used) i = (i + 1) & mask;
        s128[i].used = 1;
        s128[i].k = k;
        return &s128[i].v;
    }
    // returns value slot; *fresh says whether it was just inserted
    int32_t* get_or_insert(const Key& k, bool* fresh) {
        if (count >= limit) rehash((mask + 1) * 2);
        size_t i = KeyHash{}(k) & mask;
        if (narrow) {
            while (s64[i].k != EMPTY64) {
                if (s64[i].k == k.lo) { *fresh = false; return &s64[i].v; }
                i = (i + 1) & mask;
            }
            s64[i].k = k.lo;
            count++;
            *fresh = true;
            return &s64[i].v;
        }
        while (s128[i].used) {
            if (s128[i].k == k) { *fresh = false; return &s128[i].v; }
            i = (i + 1) & mask;
        }
        s128[i].used = 1;
        s128[i].k = k;
        count++;
        *fresh = true;
        return &s128[i].v;
    }
    int32_t find(const Key& k) const {  // -1 if absent
        if (mask == 0) return -1;
        size_t i = KeyHash{}(k) & mask;
        if (narrow) {
            while (s64[i].k != EMPTY64) {
                if (s64[i].k == k.lo) return s64[i].v;
                i = (i + 1) & mask;
            }
            return -1;
        }
        while (s128[i].used) {
            if (s128[i].k == k) return s128[i].v;
            i = (i + 1) & mask;
        }
        return -1;
    }
};

static inline uint64_t rev64(uint64_t x) {
    x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
    return (x >> 32) | (x << 32);
}

static inline Key rev_comp(const Key& k, int n_bases) {
    const uint64_t C = 0xAAAAAAAAAAAAAAAAULL;
    uint64_t rhi = rev64(k.lo) ^ C;
    uint64_t rlo = rev64(k.hi) ^ C;
    int s = 128 - 2 * n_bases;
    Key r;
    if (s == 0) { r.hi = rhi; r.lo = rlo; }
    else if (s < 64) { r.lo = (rlo >> s) | (rhi << (64 - s)); r.hi = rhi >> s; }
    else if (s == 64) { r.lo = rhi; r.hi = 0; }
    else { r.lo = rhi >> (s - 64); r.hi = 0; }
    return r;
}

struct Edge {
    Key dst;
    int32_t dst_id;     // node id (every dst key is registered as a node)
    int32_t mask_id;    // content id of the full k-mer's sample set
    int32_t dst_chain;  // chain starting at dst, or -1 (annotated post-compact)
    uint8_t dst_flags;  // bit0 = dst is an entry, bit1 = dst is an exit
};

struct Chain {
    std::vector<Key> nodes;       // chain after its start node (last popped)
    std::vector<int32_t> ids;     // node ids parallel to `nodes`
    std::vector<uint8_t> codes;   // node & 3 per node
    // (rel index, in_start, in_end) marks for nodes in either set
    std::vector<int32_t> mark_rel;
    std::vector<uint8_t> mark_se;  // bit0 = in_start, bit1 = in_end
};

// cons path node
struct PNode {
    int32_t parent;   // index into arena, -1 for root
    int32_t chain;    // >= 0: chain id payload; -1: single key payload
    Key single;       // valid when chain == -1
    Key single2;      // root payload carries two keys (entry, starting)
    uint8_t is_root;
    uint8_t flags;    // extremity flags of `single` (root: of entry)
    uint8_t flags2;   // root only: extremity flags of `single2`
    int64_t length;   // total nodes up to and including this payload
    Key prev_last, last;
};

struct Record {
    int32_t path;     // arena index
    Key second;       // starting_kmer
};

struct Result {
    // per kept path: instead of flat per-path code arrays (1.5 GB at
    // dense genome scale, ~75x denormalization of shared chains), each
    // path is a list of segments: seg >= 0 is a chain id, seg < 0 is a
    // single node with code -(seg + 1). Consumers (LazySeq tail, the
    // bulk SNP stage) re-assemble codes from the chain table on demand.
    std::vector<uint64_t> ent_hi, ent_lo, ex_hi, ex_lo;
    std::vector<int64_t> path_len, segs_off, snps_off;
    std::vector<int32_t> segs;      // concatenated segment descriptors
    std::vector<int64_t> snps;      // concatenated vec_snps values
    int64_t n_entries = 0;
};

struct Core {
    int k_graph;
    int max_depth;
    FlatKeyMap node_id;
    std::vector<Key> node_key;
    std::vector<std::vector<Edge>> adj;
    // per-node extremity flags: bit0 = entry ("starts"), bit1 = exit ("ends")
    std::vector<uint8_t> nflags;
    std::vector<int32_t> start_order;  // entry node ids, discovery order
    // start node id -> chain id, flat (-1 = none): the post-compaction
    // edge annotation queries this once per edge (~9M times); an
    // unordered_map there cost ~9s regardless of extremity count
    std::vector<int32_t> chain_of;
    std::vector<int32_t> chain_start_ids;  // insertion order, for rewiring
    std::vector<Chain> chains;
    Result res;
    // kmer_samples export (fused-expansion entry point only): first-wins
    // {full k-mer -> sample bitmask} rows, in insertion order until
    // ks_fill sorts them by (hi, lo)
    std::vector<Key> ks_keys;
    std::vector<uint64_t> ks_masks;  // ks_m limbs per row
    int64_t ks_m = 0;
    int64_t n_edges = 0;
};

static int32_t intern(Core& c, const Key& k) {
    bool fresh;
    int32_t* v = c.node_id.get_or_insert(k, &fresh);
    if (!fresh) return *v;
    int32_t id = (int32_t)c.node_key.size();
    *v = id;
    c.node_key.push_back(k);
    c.adj.emplace_back();
    return id;
}

// ---- fused expansion front-end (replaces the numpy _expand_arrays +
// edge_content_ids path of ska_tpu/skalo/graph.py for the native core) ----
//
// Expands each (split k-mer row, degenerate middle base) of the merged
// array into the cDBG's fwd and rc edges (reference src/skalo/input.rs:
// 18-125) directly inside the core: per row, middle bases are visited in
// "first contributing sample, then position in that sample's DEGENERATE
// expansion" order — exactly the scalar python formulation — and each
// expansion emits edge (k1 -> k2) then (rc2 -> rc1), matching the
// interleaved stream the array path produced. Sample bitmasks resolve
// first-wins per full k-mer; edge mask ids are dense content ids of the
// resolved bitmask (only their equality relation is ever used).

typedef unsigned __int128 u128;

// interns an M-limb mask row's CONTENT to a dense id (open addressing)
struct MaskMap {
    std::vector<uint64_t> rows;  // M limbs per id
    std::vector<int32_t> slot;   // hash table over ids, -1 empty
    size_t mask = 0;
    int64_t M = 1;

    void init(int64_t m) {
        M = m;
        slot.assign(1024, -1);
        mask = slot.size() - 1;
    }
    static uint64_t hash_row(const uint64_t* r, int64_t M) {
        uint64_t x = 0x9E3779B97F4A7C15ULL;
        for (int64_t j = 0; j < M; j++) {
            x ^= r[j] + 0x9E3779B97F4A7C15ULL + (x << 6) + (x >> 2);
            x *= 0xBF58476D1CE4E5B9ULL;
        }
        return x;
    }
    int32_t intern(const uint64_t* r) {
        size_t n_ids = rows.size() / (size_t)M;
        if (n_ids * 4 >= slot.size() * 3) {  // grow at 0.75 load
            std::vector<int32_t> ns(slot.size() * 2, -1);
            size_t nm = ns.size() - 1;
            for (size_t id = 0; id < n_ids; id++) {
                size_t i = hash_row(&rows[id * M], M) & nm;
                while (ns[i] >= 0) i = (i + 1) & nm;
                ns[i] = (int32_t)id;
            }
            slot = std::move(ns);
            mask = nm;
        }
        size_t i = hash_row(r, M) & mask;
        while (slot[i] >= 0) {
            if (memcmp(&rows[(size_t)slot[i] * M], r, (size_t)M * 8) == 0)
                return slot[i];
            i = (i + 1) & mask;
        }
        int32_t id = (int32_t)n_ids;
        slot[i] = id;
        rows.insert(rows.end(), r, r + M);
        return id;
    }
};

static void expand_and_build(Core& c, const uint64_t* keys_hi,
                             const uint64_t* keys_lo, const uint8_t* variants,
                             int64_t n, int64_t S, int64_t len_kmer,
                             bool tim = false) {
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto secs = [](auto a, auto b) {
        return std::chrono::duration<double>(b - a).count();
    };
    auto e0 = now();
    // degenerate middle-base table (input.rs:32-51 via kmer_utils.DEGENERATE):
    // per ascii char, 2-bit codes (A=0 C=1 T=2 G=3) in list order
    uint8_t deg_n[256] = {0};
    uint8_t deg_c[256][4];
    auto put = [&](char ch, const char* bases) {
        uint8_t cnt = 0;
        for (const char* p = bases; *p; p++)
            deg_c[(uint8_t)ch][cnt++] = (uint8_t)((*p >> 1) & 3);
        deg_n[(uint8_t)ch] = cnt;
    };
    put('A', "A"); put('T', "T"); put('G', "G"); put('C', "C");
    put('M', "AC"); put('S', "CG"); put('W', "AT"); put('R', "AG");
    put('Y', "CT"); put('K', "GT"); put('B', "CGT"); put('D', "AGT");
    put('H', "ACT"); put('V', "ACG"); put('N', "ACGT");

    // pre-count expansions for exact map reserves (one cheap pass)
    int64_t m_total = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = variants + i * S;
        uint8_t present = 0;
        for (int64_t s = 0; s < S; s++) {
            uint8_t ch = row[s];
            for (uint8_t t = 0; t < deg_n[ch]; t++)
                present |= (uint8_t)(1u << deg_c[ch][t]);
        }
        m_total += __builtin_popcount(present);
    }
    int64_t E = 2 * m_total;
    c.n_edges = E;
    auto e1 = now();
    // narrow (lo-only) slots whenever full k-mers fit 62 bits
    const bool narrow = len_kmer <= 31;
    // cDBG node count tracks the edge count closely (dense 4x4Mb:
    // 8.95M nodes / 8.98M edges); reserving E keeps load ~57% and
    // halves the map footprint vs 2E — a pathological graph merely
    // pays one growth rehash
    c.node_id.reserve((size_t)E, narrow);

    FlatKeyMap fullmap;  // full k-mer -> ks row id (first wins)
    fullmap.reserve((size_t)E, narrow);
    MaskMap cmap;
    const int64_t M = (S + 63) / 64;
    cmap.init(M);
    c.ks_m = M;
    std::vector<int32_t> row_cid;  // ks row -> mask content id
    row_cid.reserve((size_t)E / 2);

    const int h = (int)((len_kmer - 1) / 2);
    const u128 lowmask = (((u128)1) << (2 * h)) - 1;
    const u128 kmask = (((u128)1) << (2 * (len_kmer - 1))) - 1;

    std::vector<uint64_t> mrow((size_t)(4 * M));
    uint8_t order[4];

    auto resolve = [&](const Key& fk, int32_t cid,
                       const uint64_t* limbs) -> int32_t {
        bool fresh;
        int32_t* v = fullmap.get_or_insert(fk, &fresh);
        if (fresh) {
            *v = (int32_t)c.ks_keys.size();
            c.ks_keys.push_back(fk);
            c.ks_masks.insert(c.ks_masks.end(), limbs, limbs + M);
            row_cid.push_back(cid);
        }
        return row_cid[(size_t)*v];
    };

    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = variants + i * S;
        uint8_t present = 0;
        int n_ord = 0;
        for (int64_t s = 0; s < S; s++) {
            uint8_t ch = row[s];
            for (uint8_t t = 0; t < deg_n[ch]; t++) {
                uint8_t b = deg_c[ch][t];
                if (!(present & (1u << b))) {
                    present |= (uint8_t)(1u << b);
                    order[n_ord++] = b;
                    uint64_t* mr = &mrow[(size_t)b * M];
                    for (int64_t j = 0; j < M; j++) mr[j] = 0;
                }
                mrow[(size_t)b * M + (s >> 6)] |= 1ULL << (s & 63);
            }
        }
        if (!n_ord) continue;

        const u128 key = ((u128)(keys_hi ? keys_hi[i] : 0) << 64) | keys_lo[i];
        const u128 base = ((key >> (2 * h)) << (2 * (h + 1))) | (key & lowmask);
        for (int q = 0; q < n_ord; q++) {
            const uint8_t code = order[q];
            const uint64_t* limbs = &mrow[(size_t)code * M];
            const u128 full = base | ((u128)code << (2 * h));
            const Key fk{(uint64_t)(full >> 64), (uint64_t)full};
            const Key rk = rev_comp(fk, (int)len_kmer);
            const u128 rcf = ((u128)rk.hi << 64) | rk.lo;
            const int32_t cid = cmap.intern(limbs);
            const int32_t m1 = resolve(fk, cid, limbs);
            const int32_t m2 = resolve(rk, cid, limbs);

            const u128 k1 = full >> 2, k2 = full & kmask;
            const u128 rc1 = rcf & kmask, rc2 = rcf >> 2;
            int32_t sid = intern(c, Key{(uint64_t)(k1 >> 64), (uint64_t)k1});
            c.adj[sid].push_back(
                Edge{Key{(uint64_t)(k2 >> 64), (uint64_t)k2}, -1, m1, -1, 0});
            sid = intern(c, Key{(uint64_t)(rc2 >> 64), (uint64_t)rc2});
            c.adj[sid].push_back(
                Edge{Key{(uint64_t)(rc1 >> 64), (uint64_t)rc1}, -1, m2, -1, 0});
        }
    }

    // second pass: register destination-only nodes (same discovery order
    // as the array path — all sources first, then dsts in edge order)
    auto e2 = now();
    for (size_t id = 0, n0 = c.adj.size(); id < n0; id++)
        for (size_t j = 0; j < c.adj[id].size(); j++) {
            Key d = c.adj[id][j].dst;
            // intern() may reallocate c.adj (emplace_back); form the
            // lvalue only after it returns — do not fold into one
            // statement (unsequenced under pre-C++17 CXXFLAGS overrides)
            int32_t di = intern(c, d);
            c.adj[id][j].dst_id = di;
        }
    if (tim)
        fprintf(stderr,
                "[skalo_core]   expand: count %.1fs emit %.1fs dst %.1fs "
                "(%zu nodes / %lld edges)\n",
                secs(e0, e1), secs(e1, e2), secs(e2, now()),
                c.node_id.count, (long long)E);
}

// extremities.rs:10-51: >= 2 out-edges whose sample sets differ
static bool find_extremities(Core& c) {
    int64_t n = (int64_t)c.node_key.size();
    c.nflags.assign((size_t)n, 0);
    for (int64_t id = 0; id < n; id++) {
        auto& lst = c.adj[id];
        if (lst.size() < 2) continue;
        bool entry = false;
        for (size_t i = 0; i + 1 < lst.size() && !entry; i++)
            for (size_t j = i + 1; j < lst.size(); j++)
                if (lst[i].mask_id != lst[j].mask_id) { entry = true; break; }
        if (entry) {
            c.nflags[id] |= 1;
            c.start_order.push_back((int32_t)id);
            // the exit twin is only ever tested on graph nodes, so an RC
            // key that is not a node can be dropped (it can never be hit)
            int32_t rid = c.node_id.find(rev_comp(c.node_key[id], c.k_graph));
            if (rid >= 0) c.nflags[rid] |= 2;
        }
    }
    return !c.start_order.empty();
}

// compaction.rs:10-117 (walks first, then rewiring; order-independent)
static void compact(Core& c) {
    const size_t nN = c.node_key.size();
    c.chain_of.assign(nN, -1);

    // packed per-node walk state: corridor successor (dst when out-degree
    // is exactly 1, else -1) and extremity flags in ONE 8-byte record.
    // The walk previously read adj[cur] (header + edge), vis_epoch and
    // nflags — ~4 cache misses per corridor step over millions of steps
    // (profiled 4s dense).
    struct WN { int32_t succ; uint8_t flags; };
    std::vector<WN> wn(nN);
    for (size_t i = 0; i < c.adj.size(); i++)
        wn[i] = WN{c.adj[i].size() == 1 ? c.adj[i][0].dst_id : -1,
                   c.nflags[i]};

    // A walk is a pure function of `starting` on the unmodified graph and
    // registration is first-wins with identical values on re-walks, so the
    // sequential loop factors into: (a) candidate starts deduped in first-
    // appearance order, (b) independent walks — the reference's own
    // parallel axis (compaction.rs:18,55 par_iter over start/end kmers) —
    // and (c) sequential registration in candidate order, which keeps
    // c.chains / chain ids byte-identical at any SKA_THREADS.
    std::vector<int32_t> cand;
    {
        std::vector<uint8_t> in_cand(nN, 0);
        auto push_cands = [&](int32_t id) {
            // snapshot: python iterates list(all_kmers[kmer])
            for (const auto& e : c.adj[id])
                if (!in_cand[e.dst_id]) {
                    in_cand[e.dst_id] = 1;
                    cand.push_back(e.dst_id);
                }
        };
        for (int32_t id : c.start_order) push_cands(id);
        for (int32_t id : c.start_order) {
            Key rc = rev_comp(c.node_key[id], c.k_graph);
            int32_t rid = c.node_id.find(rc);
            if (rid >= 0) push_cands(rid);
        }
    }

    const size_t nC = cand.size();
    std::vector<std::unique_ptr<Chain>> slots(nC);
    // walk one corridor; vis is a per-worker epoch-stamp array
    auto walk_one = [&](int32_t starting, int32_t* vis, int32_t epoch,
                        std::vector<int32_t>& chain_ids) {
        chain_ids.clear();
        int32_t cur = starting;
        while (true) {
            int32_t d = wn[cur].succ;  // -1 when out-degree != 1
            if (d < 0) break;
            if (vis[d] == epoch) break;
            cur = d;
            chain_ids.push_back(cur);
            vis[cur] = epoch;
            if (wn[cur].flags) break;
        }
    };
    auto build_chain = [&](const std::vector<int32_t>& chain_ids) {
        std::unique_ptr<Chain> up(new Chain{});
        Chain& ch = *up;
        ch.nodes.reserve(chain_ids.size());
        ch.ids = chain_ids;
        ch.codes.reserve(chain_ids.size());
        for (size_t i = 0; i < chain_ids.size(); i++) {
            const Key& k = c.node_key[chain_ids[i]];
            ch.nodes.push_back(k);
            ch.codes.push_back((uint8_t)(k.lo & 3));
            uint8_t f = c.nflags[chain_ids[i]];
            if (f) {
                ch.mark_rel.push_back((int32_t)i);
                ch.mark_se.push_back(f);
            }
        }
        return up;
    };

    const int T = env_threads();
    if (T <= 1 || nC < 2) {
        std::vector<int32_t> vis(nN, 0);
        std::vector<int32_t> chain_ids;
        for (size_t i = 0; i < nC; i++) {
            walk_one(cand[i], vis.data(), (int32_t)i + 1, chain_ids);
            if (chain_ids.size() > 1) slots[i] = build_chain(chain_ids);
        }
    } else {
        struct WState {
            std::vector<int32_t> vis;
            std::vector<int32_t> chain_ids;
        };
        pool_for_each(
            nC, T,
            [&]() {
                WState s;
                s.vis.assign(nN, 0);
                return s;
            },
            [&](WState& s, size_t i) {
                // epoch (i + 1) is unique per ITEM, so a shared
                // per-worker vis array never aliases across walks
                walk_one(cand[i], s.vis.data(), (int32_t)i + 1, s.chain_ids);
                if (s.chain_ids.size() > 1) slots[i] = build_chain(s.chain_ids);
            });
    }

    for (size_t i = 0; i < nC; i++) {
        if (!slots[i]) continue;
        // python dict assignment overwrites; values are identical for
        // repeated walks (graph unmodified during walks) and the dedup
        // above keeps first appearance, so first-wins is preserved
        int32_t cid = (int32_t)c.chains.size();
        c.chain_of[cand[i]] = cid;
        c.chains.push_back(std::move(*slots[i]));
        c.chain_start_ids.push_back(cand[i]);
        slots[i].reset();
    }

    // rewiring: remove the chain from the graph, bridge start -> chain end
    for (int32_t sid : c.chain_start_ids) {
        Chain& ch = c.chains[c.chain_of[sid]];
        const Key& first = ch.nodes[0];
        auto& lst = c.adj[sid];
        lst.erase(std::remove_if(lst.begin(), lst.end(),
                                 [&](const Edge& e) { return e.dst == first; }),
                  lst.end());
        // interiors: remove ONLY the edge to the chain successor
        // (compaction.rs:98-105 retain(neighbor != window[1])). A clear()
        // here would wipe bridge edges appended for overlapping chains
        // whose start node sits mid-corridor of this one. Node ids were
        // recorded during the walk — no map lookups here.
        for (size_t i = 0; i + 2 < ch.nodes.size() + 0u; i++) {
            const Key& nxt = ch.nodes[i + 1];
            auto& al = c.adj[ch.ids[i]];
            al.erase(
                std::remove_if(al.begin(), al.end(),
                               [&](const Edge& e) { return e.dst == nxt; }),
                al.end());
        }
        // bridge to the chain end, then pop it from the stored chain
        Key endk = ch.nodes.back();
        c.adj[sid].push_back(Edge{endk, ch.ids.back(), -1, -1, 0});
        { std::vector<int32_t> tmp; ch.ids.swap(tmp); }  // ids done
        ch.nodes.pop_back();
        ch.codes.pop_back();
        // the popped end never contributes marks in the stored chain
        if (!ch.mark_rel.empty() &&
            (size_t)ch.mark_rel.back() == ch.nodes.size()) {
            ch.mark_rel.pop_back();
            ch.mark_se.pop_back();
        }
    }

    // annotate every surviving edge with its dst's flags and chain (turns
    // per-step hash lookups in the traversal into array reads)
    for (auto& lst : c.adj)
        for (auto& e : lst) {
            e.dst_flags = c.nflags[e.dst_id];
            e.dst_chain = c.chain_of[e.dst_id];
        }
}

// read_graph.rs:19-272 via the cons-path formulation of traverse.py.
// traverse_entry is a pure READER of the compacted graph: all paths from
// one entry node, kept-path decode into R. The per-entry independence is
// the reference's own parallel axis (read_graph.rs:41 par_iter over
// start_kmers); the orchestrator below runs entries across SKA_THREADS
// workers with per-entry result slots concatenated in entry order, so
// output is byte-identical at any thread count.
static void traverse_entry(const Core& c, int32_t entry_id,
                           std::vector<PNode>& arena, Result& R) {
    auto mk_root = [&](const Key& a, uint8_t fa, const Key& b,
                       uint8_t fb) -> int32_t {
        PNode p;
        p.parent = -1; p.chain = -1; p.is_root = 1;
        p.single = a; p.single2 = b;
        p.flags = fa; p.flags2 = fb;
        p.length = 2; p.prev_last = a; p.last = b;
        arena.push_back(p);
        return (int32_t)arena.size() - 1;
    };
    auto mk_append = [&](int32_t par, const Key& item, uint8_t f) -> int32_t {
        PNode p;
        p.parent = par; p.chain = -1; p.is_root = 0;
        p.single = item;
        p.flags = f; p.flags2 = 0;
        p.length = arena[par].length + 1;
        p.prev_last = arena[par].last; p.last = item;
        arena.push_back(p);
        return (int32_t)arena.size() - 1;
    };
    auto mk_extend = [&](int32_t par, int32_t cid) -> int32_t {
        const Chain& ch = c.chains[cid];
        if (ch.nodes.empty()) return par;
        PNode p;
        p.parent = par; p.chain = cid; p.is_root = 0;
        p.length = arena[par].length + (int64_t)ch.nodes.size();
        p.prev_last = ch.nodes.size() >= 2 ? ch.nodes[ch.nodes.size() - 2]
                                           : arena[par].last;
        p.last = ch.nodes.back();
        arena.push_back(p);
        return (int32_t)arena.size() - 1;
    };

    struct Frame {
        int32_t cur_id;
        // per-path visited node ids. Paths visit few nodes (branch points
        // and chain starts/ends only — corridors are compacted), so a flat
        // vector with linear find beats an unordered_set: branching copies
        // become memcpys instead of per-element rehashes
        std::vector<int32_t> visited;
        int32_t path;
        int32_t depth;
    };
    auto seen = [](const std::vector<int32_t>& v, int32_t id) {
        for (int32_t x : v)
            if (x == id) return true;
        return false;
    };

    auto decode_path = [&](int32_t pidx, const Key& entry, const Key& exitk) {
        // collect segments root -> leaf
        std::vector<int32_t> segs;
        int64_t n = arena[pidx].length;
        for (int32_t q = pidx; q != -1; q = arena[q].parent) segs.push_back(q);
        R.ent_hi.push_back(entry.hi); R.ent_lo.push_back(entry.lo);
        R.ex_hi.push_back(exitk.hi); R.ex_lo.push_back(exitk.lo);
        R.path_len.push_back(n);
        R.segs_off.push_back((int64_t)R.segs.size());
        R.snps_off.push_back((int64_t)R.snps.size());
        int64_t off = 0;
        int64_t cutoff = n - c.k_graph;
        for (auto si = segs.rbegin(); si != segs.rend(); ++si) {
            PNode& p = arena[*si];
            if (p.is_root) {
                const Key* ks[2] = {&p.single, &p.single2};
                const uint8_t fs[2] = {p.flags, p.flags2};
                for (int q2 = 0; q2 < 2; q2++) {
                    R.segs.push_back(-(int32_t)(ks[q2]->lo & 3) - 1);
                    if ((fs[q2] & 1) && (cutoff < 0 || off <= cutoff))
                        R.snps.push_back(off + c.k_graph);
                    else if (fs[q2] & 2) R.snps.push_back(off - 1);
                    off++;
                }
            } else if (p.chain >= 0) {
                const Chain& ch = c.chains[p.chain];
                R.segs.push_back(p.chain);
                for (size_t m = 0; m < ch.mark_rel.size(); m++) {
                    int64_t i = off + ch.mark_rel[m];
                    if ((ch.mark_se[m] & 1) && (cutoff < 0 || i <= cutoff))
                        R.snps.push_back(i + c.k_graph);
                    else if (ch.mark_se[m] & 2)
                        R.snps.push_back(i - 1);
                }
                off += (int64_t)ch.codes.size();
            } else {
                R.segs.push_back(-(int32_t)(p.single.lo & 3) - 1);
                if ((p.flags & 1) && (cutoff < 0 || off <= cutoff))
                    R.snps.push_back(off + c.k_graph);
                else if (p.flags & 2) R.snps.push_back(off - 1);
                off++;
            }
        }
    };

    const Key entry = c.node_key[entry_id];
    // tmp_container: exit key -> records, insertion-ordered
    std::vector<std::pair<Key, std::vector<Record>>> tmp;
    std::unordered_map<Key, size_t, KeyHash> tmp_idx;
    arena.clear();

    auto record = [&](const Key& exitk, int32_t path, const Key& second) {
        auto it = tmp_idx.find(exitk);
        size_t gi;
        if (it == tmp_idx.end()) {
            gi = tmp.size();
            tmp.emplace_back(exitk, std::vector<Record>{});
            tmp_idx.emplace(exitk, gi);
        } else gi = it->second;
        tmp[gi].second.push_back(Record{path, second});
    };

    for (const auto& e0 : c.adj[entry_id]) {
        const Key starting = e0.dst;
        Frame f;
        f.cur_id = e0.dst_id;
        f.visited.reserve(8);
        f.visited.push_back(entry_id);
        f.visited.push_back(e0.dst_id);
        f.path = mk_root(entry, c.nflags[entry_id], starting, e0.dst_flags);
        if (e0.dst_chain >= 0) f.path = mk_extend(f.path, e0.dst_chain);
        f.depth = 0;

        std::vector<Frame> stack;
        stack.push_back(std::move(f));
        std::vector<const Edge*> good;
        while (!stack.empty()) {
            Frame fr = std::move(stack.back());
            stack.pop_back();
            if (fr.depth > c.max_depth) continue;

            bool walking = true;
            while (walking) {
                good.clear();
                for (const auto& e : c.adj[fr.cur_id])
                    if (!seen(fr.visited, e.dst_id)) good.push_back(&e);
                if (good.size() == 1) {
                    const Edge& e = *good[0];
                    fr.visited.push_back(e.dst_id);
                    fr.path = mk_append(fr.path, e.dst, e.dst_flags);
                    fr.cur_id = e.dst_id;
                    if (e.dst_chain >= 0)
                        fr.path = mk_extend(fr.path, e.dst_chain);
                    if (e.dst_flags & 2) record(e.dst, fr.path, starting);
                } else if (good.size() > 1) {
                    for (size_t gi2 = 0; gi2 < good.size(); gi2++) {
                        const Edge* ep = good[gi2];
                        Frame nf;
                        nf.cur_id = ep->dst_id;
                        if (gi2 + 1 == good.size())
                            nf.visited = std::move(fr.visited);
                        else
                            nf.visited = fr.visited;
                        nf.visited.push_back(ep->dst_id);
                        nf.path = mk_append(fr.path, ep->dst, ep->dst_flags);
                        if (ep->dst_chain >= 0)
                            nf.path = mk_extend(nf.path, ep->dst_chain);
                        if (ep->dst_flags & 2)
                            record(ep->dst, nf.path, starting);
                        nf.depth = fr.depth + 1;
                        stack.push_back(std::move(nf));
                    }
                    walking = false;
                } else {
                    walking = false;
                }
            }
        }
    }

    bool any_multi = false;
    for (auto& g : tmp)
        if (g.second.size() > 1) { any_multi = true; break; }
    if (!any_multi) return;

    for (auto& g : tmp) {
        auto& recs = g.second;
        // distinct seconds and second-to-lasts (read_graph.rs:166-172)
        std::unordered_set<Key, KeyHash> seconds, prevs;
        for (auto& r : recs) {
            seconds.insert(r.second);
            prevs.insert(arena[r.path].prev_last);
        }
        if (seconds.size() < 2 || prevs.size() < 2) continue;
        // most common length, first-encountered wins ties
        std::vector<std::pair<int64_t, int64_t>> counts;  // (len, count)
        for (auto& r : recs) {
            int64_t L = arena[r.path].length;
            bool found = false;
            for (auto& kv : counts)
                if (kv.first == L) { kv.second++; found = true; break; }
            if (!found) counts.emplace_back(L, 1);
        }
        int64_t mcl = counts[0].first, best = counts[0].second;
        for (auto& kv : counts)
            if (kv.second > best) { best = kv.second; mcl = kv.first; }
        if (recs.size() == 2) {
            for (auto& r : recs) decode_path(r.path, entry, g.first);
        } else {
            for (auto& r : recs)
                if (arena[r.path].length == mcl)
                    decode_path(r.path, entry, g.first);
        }
    }
}

static void traverse(Core& c) {
    const size_t nE = c.start_order.size();
    const int T = env_threads();
    if (T <= 1 || nE < 2) {
        std::vector<PNode> arena;
        arena.reserve(1 << 20);
        for (int32_t entry_id : c.start_order)
            traverse_entry(c, entry_id, arena, c.res);
        return;
    }

    // per-entry result slots filled by a work-stealing counter; workers
    // never touch shared output state, and the sequential concatenation
    // below preserves entry order exactly
    std::vector<std::unique_ptr<Result>> per(nE);
    pool_for_each(
        nE, T,
        [&]() {
            std::vector<PNode> arena;
            arena.reserve(1 << 16);
            return arena;
        },
        [&](std::vector<PNode>& arena, size_t i) {
            Result tmp;
            traverse_entry(c, c.start_order[i], arena, tmp);
            if (!tmp.path_len.empty())
                per[i].reset(new Result(std::move(tmp)));
        });

    Result& R = c.res;
    for (size_t i = 0; i < nE; i++) {
        if (!per[i]) continue;
        Result& r = *per[i];
        const int64_t so = (int64_t)R.segs.size();
        const int64_t po = (int64_t)R.snps.size();
        R.ent_hi.insert(R.ent_hi.end(), r.ent_hi.begin(), r.ent_hi.end());
        R.ent_lo.insert(R.ent_lo.end(), r.ent_lo.begin(), r.ent_lo.end());
        R.ex_hi.insert(R.ex_hi.end(), r.ex_hi.begin(), r.ex_hi.end());
        R.ex_lo.insert(R.ex_lo.end(), r.ex_lo.begin(), r.ex_lo.end());
        R.path_len.insert(R.path_len.end(), r.path_len.begin(), r.path_len.end());
        for (int64_t v : r.segs_off) R.segs_off.push_back(v + so);
        for (int64_t v : r.snps_off) R.snps_off.push_back(v + po);
        R.segs.insert(R.segs.end(), r.segs.begin(), r.segs.end());
        R.snps.insert(R.snps.end(), r.snps.begin(), r.snps.end());
        per[i].reset();
    }
}

}  // namespace

extern "C" {

// A null handle means "no entry node" (the reference's hard exit) unless
// this flag says the run died on allocation instead: a repeat-dense graph
// at small k with a high max_depth can grow the kept-path buffers
// combinatorially (tens of GB from a KB-scale input — the reference's
// Rust Vec growth aborts the same way). Catching it here turns a C++
// terminate() into a clean python MemoryError.
static thread_local int g_skalo_oom = 0;
int skalo_core_oom(void) { return g_skalo_oom; }

// single source of truth for the narrow-keys rule (full k-mer fits 62
// bits): python's NULL-hi ks export must agree with the C++ packing
int64_t skalo_core_narrow_limit(void) { return 31; }

// Fused entry: expansion + graph build + extremities + compaction +
// traversal from the merged array itself (keys (n,) limb arrays, ascii
// variants (n, S)). keys_hi may be NULL for single-limb k. Returns the
// same handle as skalo_core_run, additionally carrying the kmer_samples
// export (skalo_core_ks_*).
void* skalo_expand_run(
    const uint64_t* keys_hi, const uint64_t* keys_lo,
    const uint8_t* variants, int64_t n, int64_t S,
    int64_t len_kmer, int64_t max_depth
) {
    g_skalo_oom = 0;
    Core* c = new Core();
    c->k_graph = (int)(len_kmer - 1);
    c->max_depth = (int)max_depth;
    const bool tim = getenv("SKALO_CORE_TIME") != nullptr;
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto secs = [](auto a, auto b) {
        return std::chrono::duration<double>(b - a).count();
    };
    try {
        auto t0 = now();
        expand_and_build(*c, keys_hi, keys_lo, variants, n, S, len_kmer, tim);
        auto t1 = now();
        if (!find_extremities(*c)) {
            delete c;
            return nullptr;  // no entry node: caller raises like the reference
        }
        auto t2 = now();
        compact(*c);
        auto t3 = now();
        traverse(*c);
        auto t4 = now();
        if (tim)
            fprintf(stderr,
                    "[skalo_core] expand+nodes %.1fs extrem %.1fs compact %.1fs "
                    "traverse %.1fs (%zu segs)\n",
                    secs(t0, t1), secs(t1, t2), secs(t2, t3), secs(t3, t4),
                    c->res.segs.size());
        return c;
    } catch (const std::bad_alloc&) {
        delete c;
        g_skalo_oom = 1;
        return nullptr;
    } catch (const std::length_error&) {
        // vector::reserve past max_size (combinatorial blowup) — same
        // disposition as exhaustion: clean MemoryError, not terminate()
        delete c;
        g_skalo_oom = 1;
        return nullptr;
    }
}

int64_t skalo_core_n_edges(void* h) { return ((Core*)h)->n_edges; }
int64_t skalo_core_ks_len(void* h) { return (int64_t)((Core*)h)->ks_keys.size(); }
int64_t skalo_core_ks_m(void* h) { return ((Core*)h)->ks_m; }

// kmer_samples export sorted by (hi, lo): hi/lo length G, masks G x M
// hi may be NULL when the caller knows every full k-mer fits 62 bits
// (len_kmer <= 31): skips writing a G*8-byte all-zero limb array,
// which is pure fresh-page fault cost on this host (BASELINE.md)
void skalo_core_ks_fill(void* h, uint64_t* hi, uint64_t* lo, uint64_t* masks) {
  try {
    Core& c = *(Core*)h;
    const int64_t G = (int64_t)c.ks_keys.size();
    const int64_t M = c.ks_m;
    // sort contiguous records rather than indices: the comparator and the
    // output pass then read sequential memory instead of chasing random
    // rows (the gather per output row dominated on the fault-bound host)
    if (M == 1) {
        bool allhi0 = true;
        for (int64_t i = 0; i < G; i++)
            if (c.ks_keys[(size_t)i].hi) { allhi0 = false; break; }
        if (allhi0 && G > (1 << 16)) {
            // MSD bucket partition on the top 13 bits straight into the
            // output arrays, then cache-resident per-bucket sorts: one
            // global comparison sort of ~9M 24B records cost ~4.5s CPU
            // on the dense set, most of it cache misses
            constexpr int SH = 51, B = 1 << 13;
            std::vector<int64_t> off((size_t)B + 1, 0);
            for (int64_t i = 0; i < G; i++)
                off[(size_t)(c.ks_keys[(size_t)i].lo >> SH) + 1]++;
            for (int b = 0; b < B; b++) off[(size_t)b + 1] += off[(size_t)b];
            std::vector<int64_t> pos(off.begin(), off.end() - 1);
            for (int64_t i = 0; i < G; i++) {
                uint64_t k = c.ks_keys[(size_t)i].lo;
                int64_t j = pos[(size_t)(k >> SH)]++;
                lo[j] = k;
                masks[j] = c.ks_masks[(size_t)i];
            }
            if (hi) memset(hi, 0, (size_t)G * 8);
            struct P { uint64_t k, m; };
            std::vector<P> tmp;
            for (int b = 0; b < B; b++) {
                int64_t s = off[(size_t)b], e = off[(size_t)b + 1];
                if (e - s < 2) continue;
                tmp.resize((size_t)(e - s));
                for (int64_t i = s; i < e; i++)
                    tmp[(size_t)(i - s)] = P{lo[i], masks[i]};
                std::sort(tmp.begin(), tmp.end(),
                          [](const P& a, const P& b2) { return a.k < b2.k; });
                for (int64_t i = s; i < e; i++) {
                    lo[i] = tmp[(size_t)(i - s)].k;
                    masks[i] = tmp[(size_t)(i - s)].m;
                }
            }
            return;
        }
        struct KRM { Key k; uint64_t m; };
        std::vector<KRM> v((size_t)G);
        for (int64_t i = 0; i < G; i++)
            v[(size_t)i] = KRM{c.ks_keys[(size_t)i], c.ks_masks[(size_t)i]};
        std::sort(v.begin(), v.end(), [](const KRM& a, const KRM& b) {
            return a.k.hi != b.k.hi ? a.k.hi < b.k.hi : a.k.lo < b.k.lo;
        });
        for (int64_t i = 0; i < G; i++) {
            if (hi) hi[i] = v[(size_t)i].k.hi;
            lo[i] = v[(size_t)i].k.lo;
            masks[i] = v[(size_t)i].m;
        }
        return;
    }
    struct KR { Key k; int32_t r; };
    std::vector<KR> v((size_t)G);
    for (int64_t i = 0; i < G; i++)
        v[(size_t)i] = KR{c.ks_keys[(size_t)i], (int32_t)i};
    std::sort(v.begin(), v.end(), [](const KR& a, const KR& b) {
        return a.k.hi != b.k.hi ? a.k.hi < b.k.hi : a.k.lo < b.k.lo;
    });
    for (int64_t i = 0; i < G; i++) {
        if (hi) hi[i] = v[(size_t)i].k.hi;
        lo[i] = v[(size_t)i].k.lo;
        memcpy(masks + i * M, &c.ks_masks[(size_t)v[(size_t)i].r * M],
               (size_t)M * 8);
    }
  } catch (const std::bad_alloc&) {
    g_skalo_oom = 1;  // caller checks skalo_core_oom() after the fill
  } catch (const std::length_error&) {
    g_skalo_oom = 1;
  }
}

int64_t skalo_core_n_paths(void* h) { return (int64_t)((Core*)h)->res.path_len.size(); }
int64_t skalo_core_segs_len(void* h) { return (int64_t)((Core*)h)->res.segs.size(); }
int64_t skalo_core_snps_len(void* h) { return (int64_t)((Core*)h)->res.snps.size(); }
int64_t skalo_core_n_chains(void* h) { return (int64_t)((Core*)h)->chains.size(); }

int64_t skalo_core_chain_codes_len(void* h) {
    int64_t total = 0;
    for (auto& ch : ((Core*)h)->chains) total += (int64_t)ch.codes.size();
    return total;
}

// chain_off: n_chains + 1 offsets; chain_codes: concatenated chain codes
void skalo_core_fill_chains(void* h, int64_t* chain_off, uint8_t* chain_codes) {
    Core& c = *(Core*)h;
    int64_t off = 0;
    for (size_t i = 0; i < c.chains.size(); i++) {
        chain_off[i] = off;
        memcpy(chain_codes + off, c.chains[i].codes.data(),
               c.chains[i].codes.size());
        off += (int64_t)c.chains[i].codes.size();
    }
    chain_off[c.chains.size()] = off;
}

void skalo_core_fill(
    void* h,
    uint64_t* ent_hi, uint64_t* ent_lo, uint64_t* ex_hi, uint64_t* ex_lo,
    int64_t* path_len, int64_t* segs_off, int64_t* snps_off,
    int32_t* segs, int64_t* snps
) {
    Result& r = ((Core*)h)->res;
    size_t n = r.path_len.size();
    memcpy(ent_hi, r.ent_hi.data(), n * 8);
    memcpy(ent_lo, r.ent_lo.data(), n * 8);
    memcpy(ex_hi, r.ex_hi.data(), n * 8);
    memcpy(ex_lo, r.ex_lo.data(), n * 8);
    memcpy(path_len, r.path_len.data(), n * 8);
    memcpy(segs_off, r.segs_off.data(), n * 8);
    memcpy(snps_off, r.snps_off.data(), n * 8);
    memcpy(segs, r.segs.data(), r.segs.size() * 4);
    memcpy(snps, r.snps.data(), r.snps.size() * 8);
}

void skalo_core_free(void* h) { delete (Core*)h; }

}  // extern "C"
