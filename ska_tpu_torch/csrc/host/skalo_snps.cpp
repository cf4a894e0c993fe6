// skalo SNP-processing stage (reference src/skalo/process_variants.rs:62-225
// and positioning.rs:129-255), ported 1:1 from ska_tpu/skalo/variants.py's
// "Processing SNPs" loop: per sorted variant group, find candidate
// positions (>1 distinct base), build SNP columns from first-wins sample
// bitmasks with N on conflicts, dedup against already-seen k-mers
// (entries_done), then position the group on the reference genome by
// majority vote of (stored position - window offset) over forward and
// reverse-complement window matches.
//
// A verbatim copy of the JAX package's csrc/skalo_snps.cpp (only this
// header differs); ska_tpu_torch/skalo/variants.py calls it, and the
// port has no python SNP loop.
//
// Groups arrive pre-sorted and pre-filtered (ratio sort, indel-entry skip
// and path filtering stay in python); sequences arrive as 2-bit code
// arrays. Window encodes replicate python string-slice semantics at the
// boundaries (negative start wraps, stop clips).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <system_error>
#include <thread>

#include "host_pool.h"
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

struct K2 {
    uint64_t hi, lo;
    bool operator==(const K2& o) const { return hi == o.hi && lo == o.lo; }
};
struct K2Hash {
    size_t operator()(const K2& k) const {
        uint64_t x = k.lo * 0x9E3779B97F4A7C15ULL ^ (k.hi + 0x9E3779B97F4A7C15ULL);
        x ^= x >> 29; x *= 0xBF58476D1CE4E5B9ULL; x ^= x >> 32;
        return (size_t)x;
    }
};

static inline uint64_t rev64s(uint64_t x) {
    x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
    return (x >> 32) | (x << 32);
}

// rev comp of an n-base value packed in (hi, lo); n <= 62
static inline K2 rc2(const K2& k, int n) {
    const uint64_t C = 0xAAAAAAAAAAAAAAAAULL;
    uint64_t rhi = rev64s(k.lo) ^ C, rlo = rev64s(k.hi) ^ C;
    int s = 128 - 2 * n;
    K2 r;
    if (s == 0) { r.hi = rhi; r.lo = rlo; }
    else if (s < 64) { r.lo = (rlo >> s) | (rhi << (64 - s)); r.hi = rhi >> s; }
    else if (s == 64) { r.lo = rhi; r.hi = 0; }
    else { r.lo = rhi >> (s - 64); r.hi = 0; }
    return r;
}

// python slice semantics: seq[a:b] with possibly-negative a
static inline void py_slice(int64_t a, int64_t b, int64_t L, int64_t* s, int64_t* e) {
    if (a < 0) { a += L; if (a < 0) a = 0; }
    if (a > L) a = L;
    if (b < 0) { b += L; if (b < 0) b = 0; }
    if (b > L) b = L;
    if (a > b) b = a;
    *s = a; *e = b;
}

// encode codes[s:e) as a 2-bit packed value (< 2^62 needed; guarded by caller)
static inline K2 enc_range(const uint8_t* codes, int64_t s, int64_t e) {
    K2 v{0, 0};
    for (int64_t i = s; i < e; i++) {
        v.hi = (v.hi << 2) | (v.lo >> 62);
        v.lo = (v.lo << 2) | codes[i];
    }
    return v;
}

static const char DEC[4] = {'A', 'C', 'T', 'G'};

// positioning scratch, one per worker thread: window_votes' pipelined-pass
// buffers (sized to one variant's windows) plus the per-group vote vectors
struct PosScratch {
    std::vector<uint64_t> encs;
    std::vector<int64_t> blo, bhi;
    std::vector<uint32_t> fwd, rev;
    std::vector<uint8_t> rcc;
};

struct SnpsCtx {
    // kmer_samples: sorted unique full-kmer keys + mask limbs
    const uint64_t *ks_hi, *ks_lo;
    const uint64_t* ks_masks;  // (G, M)
    int64_t ks_n;
    int64_t mask_limbs;
    // genome kmer map (positioning): (hi, lo) two-limb lex-sorted keys;
    // gm_hi is null for k_graph <= 32 (single-limb fast path)
    const uint64_t* gm_hi;
    const uint64_t* gm_lo;
    const uint8_t* gm_keep;
    const int64_t* gm_starts;
    const int64_t* gm_counts;
    const int64_t* gm_pos;
    int64_t gm_n;
    int do_positioning;
    int k_graph;
    int n_samples;
    double max_missing;

    // packed per-genome-key hit record: keep flag, <=3 positions
    // (positioning keeps at most the first 3, positioning.rs:80-88) and
    // their count in ONE 16-byte line — the hit path previously read
    // gm_keep/gm_starts/gm_counts/gm_pos, four scattered arrays
    struct GRec { uint32_t pos[3]; uint8_t keep; uint8_t cnt; uint16_t pad; };
    std::vector<GRec> gm_rec;

    // prefix-bucket index over the genome keys: bucket = top B key bits;
    // windows then probe ~1 entry instead of a ~22-step binary search
    // (the genome map has millions of keys and most windows miss)
    std::vector<int64_t> gm_bucket;  // 2^B + 1 start offsets
    int gm_shift = 0;  // key_bits - B for the single-limb path
    int gm_B = 0;

    std::unordered_set<K2, K2Hash> entries_done;
    // positioning scratch for the sequential paths (threaded workers own
    // their own PosScratch)
    mutable PosScratch seq_scratch;
    // SKALO_CORE_TIME=1: accumulated per-phase seconds
    bool timing = false;
    double t_cols = 0, t_pos = 0;
    // final_snps insertion-ordered map
    std::unordered_map<int64_t, size_t> snp_idx;
    std::vector<int64_t> out_pos;
    std::vector<uint8_t> out_cols;  // n_samples per entry
    int64_t not_positioned = 0;
    int64_t counter = 0;
};

static int64_t ks_find(const SnpsCtx& c, const K2& k) {
    int64_t lo = 0, hi = c.ks_n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        const uint64_t mh = c.ks_hi ? c.ks_hi[mid] : 0;  // NULL = narrow keys, hi==0
        if (mh < k.hi || (mh == k.hi && c.ks_lo[mid] < k.lo))
            lo = mid + 1;
        else hi = mid;
    }
    if (lo < c.ks_n && (c.ks_hi ? c.ks_hi[lo] : 0) == k.hi && c.ks_lo[lo] == k.lo) return lo;
    return -1;
}

// positioning.rs:217-255
static void most_frequent(const std::vector<uint32_t>& votes, int64_t* elem, int64_t* cnt) {
    *elem = 0; *cnt = 0;
    if (votes.empty()) return;
    std::unordered_map<uint32_t, int64_t> counts;
    std::vector<uint32_t> order;
    for (uint32_t v : votes) {
        auto it = counts.find(v);
        if (it == counts.end()) { counts.emplace(v, 1); order.push_back(v); }
        else it->second++;
    }
    int64_t best = 0, bestc = 0;
    bool tie = false;
    for (uint32_t v : order) {
        int64_t cN = counts[v];
        if (cN > bestc) { best = v; bestc = cN; tie = false; }
        else if (cN == bestc) tie = true;
    }
    if (tie || bestc < 10) { *elem = 0; *cnt = 0; return; }
    *elem = best; *cnt = bestc;
}

// top B bits of a key_bits-wide (hi, lo) value (key_bits > 64)
static inline uint64_t topb2(uint64_t hi, uint64_t lo, int key_bits, int B) {
    int sh = key_bits - B;  // B <= 22 and key_bits >= 66 keep sh > 0
    if (sh >= 64) return hi >> (sh - 64);
    return ((hi << (64 - sh)) | (lo >> sh)) & (((uint64_t)1 << B) - 1);
}

// window votes for one code array (positioning, k_graph <= 32 fast path)
static void window_votes(const SnpsCtx& c, const uint8_t* codes, int64_t L,
                         std::vector<uint32_t>& votes, PosScratch& sc) {
    int kg = c.k_graph;
    if (L < kg || c.gm_n == 0) return;
    uint64_t enc = 0;
    uint64_t mask = (kg >= 32) ? ~0ULL : ((1ULL << (2 * kg)) - 1);
    // Three pipelined passes over this variant's windows (the per-window
    // scratch is L1-resident): rolling encode, then bucket-span reads,
    // then the in-bucket search — each with its memory prefetched a few
    // iterations ahead. The fused loop was one dependent miss chain per
    // window (gprof: 5.8s of the dense SNP stage's 8s CPU).
    int64_t nw = L - kg + 1;
    auto& encs = sc.encs;
    auto& blos = sc.blo;
    auto& bhis = sc.bhi;
    encs.resize((size_t)nw);
    blos.resize((size_t)nw);
    bhis.resize((size_t)nw);
    for (int64_t i = 0; i < kg - 1; i++) enc = ((enc << 2) | codes[i]) & mask;
    for (int64_t p = 0; p < nw; p++) {
        enc = ((enc << 2) | codes[p + kg - 1]) & mask;
        encs[(size_t)p] = enc;
    }
    constexpr int64_t D = 12;
    for (int64_t p = 0; p < nw; p++) {
        if (p + D < nw)
            __builtin_prefetch(&c.gm_bucket[encs[(size_t)(p + D)] >> c.gm_shift]);
        uint64_t b = encs[(size_t)p] >> c.gm_shift;
        blos[(size_t)p] = c.gm_bucket[b];
        bhis[(size_t)p] = c.gm_bucket[b + 1];
    }
    for (int64_t p = 0; p < nw; p++) {
        if (p + D < nw) {
            __builtin_prefetch(&c.gm_lo[blos[(size_t)(p + D)]]);
            // .data()+idx, not operator[]: idx can be gm_n (all-empty
            // tail buckets) and a one-past-end operator[] is UB under
            // hardened libstdc++ even though only the address is formed
            __builtin_prefetch(c.gm_rec.data() + blos[(size_t)(p + D)]);
        }
        enc = encs[(size_t)p];
        int64_t lo = blos[(size_t)p], hi = bhis[(size_t)p];
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (c.gm_lo[mid] < enc) lo = mid + 1; else hi = mid;
        }
        if (lo < c.gm_n && c.gm_lo[lo] == enc) {
            const SnpsCtx::GRec& r = c.gm_rec[(size_t)lo];
            if (r.keep)
                for (int j = 0; j < r.cnt; j++)
                    votes.push_back(r.pos[j] - (uint32_t)p);
        }
    }
}

// window votes, two-limb keys (32 < k_graph <= 62)
static void window_votes2(const SnpsCtx& c, const uint8_t* codes, int64_t L,
                          std::vector<uint32_t>& votes, PosScratch&) {
    int kg = c.k_graph;
    if (L < kg || c.gm_n == 0) return;
    int key_bits = 2 * kg;
    uint64_t mhi = (key_bits - 64 >= 64) ? ~0ULL : ((1ULL << (key_bits - 64)) - 1);
    K2 enc{0, 0};
    for (int64_t i = 0; i < kg - 1; i++) {
        enc.hi = ((enc.hi << 2) | (enc.lo >> 62)) & mhi;
        enc.lo = (enc.lo << 2) | codes[i];
    }
    for (int64_t p = 0; p + kg <= L; p++) {
        enc.hi = ((enc.hi << 2) | (enc.lo >> 62)) & mhi;
        enc.lo = (enc.lo << 2) | codes[p + kg - 1];
        uint64_t b = topb2(enc.hi, enc.lo, key_bits, c.gm_B);
        int64_t lo = c.gm_bucket[b], hi = c.gm_bucket[b + 1];
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (c.gm_hi[mid] < enc.hi ||
                (c.gm_hi[mid] == enc.hi && c.gm_lo[mid] < enc.lo))
                lo = mid + 1;
            else hi = mid;
        }
        if (lo < c.gm_n && c.gm_hi[lo] == enc.hi && c.gm_lo[lo] == enc.lo) {
            const SnpsCtx::GRec& r = c.gm_rec[(size_t)lo];
            if (r.keep)
                for (int j = 0; j < r.cnt; j++)
                    votes.push_back(r.pos[j] - (uint32_t)p);
        }
    }
}

}  // namespace

extern "C" {

void* skalo_snps_new(
    const uint64_t* ks_hi, const uint64_t* ks_lo, const uint64_t* ks_masks,
    int64_t ks_n, int64_t mask_limbs,
    const uint64_t* gm_hi, const uint64_t* gm_lo, const uint8_t* gm_keep,
    const int64_t* gm_starts,
    const int64_t* gm_counts, const int64_t* gm_pos, int64_t gm_n,
    int64_t do_positioning, int64_t k_graph, int64_t n_samples,
    double max_missing
) {
    SnpsCtx* c = new SnpsCtx();
    c->ks_hi = ks_hi; c->ks_lo = ks_lo; c->ks_masks = ks_masks;
    c->ks_n = ks_n; c->mask_limbs = mask_limbs;
    c->gm_hi = gm_hi;
    c->gm_lo = gm_lo; c->gm_keep = gm_keep; c->gm_starts = gm_starts;
    c->gm_counts = gm_counts; c->gm_pos = gm_pos; c->gm_n = gm_n;
    c->gm_rec.resize((size_t)gm_n);
    for (int64_t i = 0; i < gm_n; i++) {
        SnpsCtx::GRec& r = c->gm_rec[(size_t)i];
        r.keep = gm_keep[i];
        int64_t nctn = gm_counts[i];
        r.cnt = (uint8_t)(nctn > 3 ? 3 : nctn);
        for (int64_t j = 0; j < r.cnt; j++)
            r.pos[j] = (uint32_t)gm_pos[gm_starts[i] + j];
    }
    c->do_positioning = (int)do_positioning;
    c->k_graph = (int)k_graph;
    c->n_samples = (int)n_samples;
    c->max_missing = max_missing;
    c->timing = getenv("SKALO_CORE_TIME") != nullptr;
    if (gm_n > 0) {
        int key_bits = (int)(2 * k_graph);
        int B = 1;
        while (B < 22 && B < key_bits && ((int64_t)1 << B) < gm_n) B++;
        c->gm_B = B;
        int64_t nb = (int64_t)1 << B;
        c->gm_bucket.assign((size_t)nb + 1, 0);
        if (k_graph <= 32) {
            c->gm_shift = key_bits - B;
            if (c->gm_shift >= 64) c->gm_shift = 63;
            for (int64_t i = 0; i < gm_n; i++)
                c->gm_bucket[(gm_lo[i] >> c->gm_shift) + 1]++;
        } else {
            for (int64_t i = 0; i < gm_n; i++)
                c->gm_bucket[topb2(gm_hi[i], gm_lo[i], key_bits, B) + 1]++;
        }
        for (int64_t b = 0; b < nb; b++) c->gm_bucket[b + 1] += c->gm_bucket[b];
    }
    return c;
}

// Columns phase of one group (order-dependent: consumes and extends the
// entries_done dedup set, so callers must run groups in processing order).
// codes: concatenated variant code arrays; voff: V+1 offsets; snps:
// concatenated candidate positions; soff: V+1 offsets. Fills `found` with
// (pos, column) pairs that survive dedup + missing-data checks. Returns 0
// on success, -1 if a full k-mer was missing from kmer_samples (caller
// falls back to python, which raises like the reference panics).
static int64_t columns_phase(
    SnpsCtx& c, const uint8_t* codes, const int64_t* voff,
    const int64_t* snps, const int64_t* soff, int64_t V,
    std::vector<std::pair<int64_t, std::vector<uint8_t>>>& found
) {
    int kg = c.k_graph;
    auto tc0 = std::chrono::steady_clock::now();

    // get_potential_snp: positions with > 1 distinct base among variants
    std::unordered_set<int64_t> cand_set;
    for (int64_t v = 0; v < V; v++)
        for (int64_t i = soff[v]; i < soff[v + 1]; i++) cand_set.insert(snps[i]);
    std::vector<int64_t> cand(cand_set.begin(), cand_set.end());
    // positions where >1 distinct code
    std::vector<int64_t> real;
    for (int64_t p : cand) {
        // p == -1 encodes the reference's `i - 1` usize wrap at i == 0
        // (read_graph.rs:205, release mode): usize::MAX never < len, so
        // it can never be real — and indexing codes[voff[v] - 1] here
        // would read out of bounds.
        if (p < 0) continue;
        int seen = 0;
        int cnt = 0;
        for (int64_t v = 0; v < V; v++) {
            int64_t L = voff[v + 1] - voff[v];
            if (p < L) {
                int b = 1 << codes[voff[v] + p];
                if (!(seen & b)) { seen |= b; cnt++; }
            }
        }
        if (cnt > 1) real.push_back(p);
    }
    std::sort(real.begin(), real.end());

    std::vector<K2> kmers_to_save;

    for (int64_t pos : real) {
        std::vector<uint8_t> col((size_t)c.n_samples, (uint8_t)'-');
        std::vector<K2> tmp;
        bool new_snp = true;

        for (int64_t v = 0; v < V; v++) {
            const uint8_t* vc = codes + voff[v];
            int64_t L = voff[v + 1] - voff[v];
            int64_t s, e;
            py_slice(pos - kg, pos + 1, L, &s, &e);
            K2 fb = enc_range(vc, s, e);
            py_slice(pos, pos + kg + 1, L, &s, &e);
            K2 fa = enc_range(vc, s, e);
            K2 rca = rc2(fa, kg + 1);

            if (!c.entries_done.count(fb) && !c.entries_done.count(rca)) {
                char ln = DEC[fb.lo & 3];
                int64_t gi = ks_find(c, fb);
                if (gi < 0) return -1;
                for (int64_t limb = 0; limb < c.mask_limbs; limb++) {
                    uint64_t m = c.ks_masks[gi * c.mask_limbs + limb];
                    int base = (int)(limb * 64);
                    while (m) {
                        int bit = __builtin_ctzll(m);
                        int i = base + bit;
                        if (i < c.n_samples) {
                            if (col[i] == '-' || col[i] == (uint8_t)ln)
                                col[i] = (uint8_t)ln;
                            else col[i] = 'N';
                        }
                        m &= m - 1;
                    }
                }
                tmp.push_back(fb);
                tmp.push_back(rc2(fb, kg + 1));
                tmp.push_back(fa);
                tmp.push_back(rca);
            } else {
                new_snp = false;
            }
        }

        if (new_snp) {
            // check_missing_data
            int present = 0, missing = 0;
            for (uint8_t ch : col) {
                if (ch == 'A' || ch == 'T' || ch == 'G' || ch == 'C') {
                    present |= 1 << ((ch >> 1) & 3);
                } else missing++;
            }
            int distinct = __builtin_popcount((unsigned)present);
            double ratio = (double)missing / (double)c.n_samples;
            if (distinct >= 2 && ratio <= c.max_missing) {
                for (auto& k : tmp) kmers_to_save.push_back(k);
                found.emplace_back(pos, std::move(col));
            }
        }
    }

    for (auto& k : kmers_to_save) c.entries_done.insert(k);

    if (c.timing)
        c.t_cols += std::chrono::duration<double>(
            std::chrono::steady_clock::now() - tc0).count();
    return 0;
}

struct PosResult {
    bool pos_found = false;
    int64_t position = 0;
    bool is_forward = true;
};

// Positioning phase: a PURE function of the group's sequences (no dedup
// state, no output state) — this is what the threaded bulk driver fans
// out across workers. scan_variants over all variants, fwd + rc; vote
// values are u32 by construction (reference positioning is u32
// arithmetic) and the scratch buffers are reused across a worker's groups
// (~25M pushes at dense scale).
static PosResult position_group(
    const SnpsCtx& c, const uint8_t* codes, const int64_t* voff, int64_t V,
    PosScratch& sc
) {
    std::vector<uint32_t>&fwd = sc.fwd, &rev = sc.rev;
    fwd.clear(); rev.clear();
    std::vector<uint8_t>& rc_codes = sc.rcc;
    auto wv = (c.k_graph <= 32) ? window_votes : window_votes2;
    for (int64_t v = 0; v < V; v++) {
        const uint8_t* vc = codes + voff[v];
        int64_t L = voff[v + 1] - voff[v];
        wv(c, vc, L, fwd, sc);
        rc_codes.resize((size_t)L);
        for (int64_t i = 0; i < L; i++) rc_codes[L - 1 - i] = vc[i] ^ 2;
        wv(c, rc_codes.data(), L, rev, sc);
    }
    int64_t fe, fc, re, rcnt;
    most_frequent(fwd, &fe, &fc);
    most_frequent(rev, &re, &rcnt);
    bool fok = fc != 0, rok = rcnt != 0;
    PosResult pr;
    if (fok && rok) {
        if (fc == rcnt) pr.pos_found = false;
        else if (fc > rcnt) { pr.pos_found = true; pr.position = fe; pr.is_forward = true; }
        else { pr.pos_found = true; pr.position = re; pr.is_forward = false; }
    } else if (fok) { pr.pos_found = true; pr.position = fe; pr.is_forward = true; }
    else if (rok) { pr.pos_found = true; pr.position = re; pr.is_forward = false; }
    return pr;
}

// Commit phase (order-dependent: snp_idx/out_pos insertion order defines
// the output order, so callers commit groups in processing order).
static void commit_group(
    SnpsCtx& c, std::vector<std::pair<int64_t, std::vector<uint8_t>>>& found,
    const PosResult& pr, int64_t seq_len
) {
    int kg = c.k_graph;
    if (pr.pos_found) {
        for (auto& pc : found) {
            int64_t fp = pr.is_forward
                ? ((pr.position + (pc.first - kg)) & 0xFFFFFFFFLL)
                : ((pr.position + (seq_len - pc.first - kg - 1)) & 0xFFFFFFFFLL);
            if (c.snp_idx.count(fp)) {
                c.not_positioned++;
            } else {
                c.snp_idx.emplace(fp, c.out_pos.size());
                c.out_pos.push_back(fp);
                if (pr.is_forward) {
                    c.out_cols.insert(c.out_cols.end(), pc.second.begin(), pc.second.end());
                } else {
                    for (uint8_t ch : pc.second) {
                        uint8_t o = ch;
                        if (ch == 'A') o = 'T'; else if (ch == 'T') o = 'A';
                        else if (ch == 'C') o = 'G'; else if (ch == 'G') o = 'C';
                        c.out_cols.push_back(o);
                    }
                }
            }
        }
    } else {
        c.not_positioned += (int64_t)found.size();
    }
}

// Process one group, fused (the per-group python path and T=1 bulk path).
static int64_t process_group(
    SnpsCtx& c, const uint8_t* codes, const int64_t* voff,
    const int64_t* snps, const int64_t* soff, int64_t V
) {
    std::vector<std::pair<int64_t, std::vector<uint8_t>>> found;
    int64_t r = columns_phase(c, codes, voff, snps, soff, V, found);
    if (r != 0) return r;
    if (found.empty()) return 0;
    auto tp0 = std::chrono::steady_clock::now();

    if (c.do_positioning) {
        PosResult pr = position_group(c, codes, voff, V, c.seq_scratch);
        commit_group(c, found, pr, voff[1] - voff[0]);
    } else {
        for (auto& pc : found) {
            c.counter++;
            c.snp_idx.emplace(c.counter, c.out_pos.size());
            c.out_pos.push_back(c.counter);
            c.out_cols.insert(c.out_cols.end(), pc.second.begin(), pc.second.end());
        }
    }
    if (c.timing)
        c.t_pos += std::chrono::duration<double>(
            std::chrono::steady_clock::now() - tp0).count();
    return 0;
}

int64_t skalo_snps_group(
    void* h, const uint8_t* codes, const int64_t* voff,
    const int64_t* snps, const int64_t* soff, int64_t V
) {
    try {
        return process_group(*(SnpsCtx*)h, codes, voff, snps, soff, V);
    } catch (const std::bad_alloc&) {
        return -2;  // OOM: caller raises MemoryError, not KeyError
    } catch (const std::length_error&) {
        return -2;  // reserve past max_size: same clean disposition
    }
}

// Bulk driver over the traversal core's master buffers (zero python-side
// marshaling): paths are addressed by index into the arrays that
// skalo_core_fill produced. A path's full sequence codes are its entry
// (k_graph bases, decoded from ent_hi/ent_lo) followed by the codes of
// its segments (seg >= 0: chain_codes[chain_off[seg]..chain_off[seg+1]),
// seg < 0: the single code -(seg+1)) with the FIRST segment element
// skipped — it is the root entry single, duplicating the entry's last
// base (see LazySeq.tail). path_idx/grp_off give the groups in
// processing order (ratio-sorted, indel-skipped, filtered — python keeps
// that logic). Returns 0, or -1 if a full k-mer was missing from
// kmer_samples.
namespace {

// Assemble one group's concatenated code arrays (and optionally its
// candidate-SNP lists) from the traversal core's master buffers. Pure
// function of the read-only buffers, so pass-2 workers can re-derive a
// group's sequences without holding them across passes.
static void assemble_group(
    const int32_t* segs, const int64_t* segs_off, const int64_t* chain_off,
    const uint8_t* chain_codes, const uint64_t* ent_hi, const uint64_t* ent_lo,
    const int64_t* master_snps, const int64_t* soff,
    const int64_t* path_idx, const int64_t* grp_off, int kg, int64_t g,
    std::vector<uint8_t>& codes_s, std::vector<int64_t>& voff_s,
    std::vector<int64_t>* snps_s, std::vector<int64_t>* soff_s
) {
    int64_t V = grp_off[g + 1] - grp_off[g];
    codes_s.clear(); voff_s.clear();
    voff_s.push_back(0);
    if (snps_s) { snps_s->clear(); soff_s->clear(); soff_s->push_back(0); }
    for (int64_t v = 0; v < V; v++) {
        int64_t p = path_idx[grp_off[g] + v];
        for (int j = 0; j < kg; j++) {
            int shift = 2 * (kg - 1 - j);
            uint8_t code = shift >= 64
                ? (uint8_t)((ent_hi[p] >> (shift - 64)) & 3)
                : (uint8_t)((ent_lo[p] >> shift) & 3);
            codes_s.push_back(code);
        }
        for (int64_t s = segs_off[p]; s < segs_off[p + 1]; s++) {
            int32_t sg = segs[s];
            if (sg >= 0) {
                codes_s.insert(codes_s.end(),
                               chain_codes + chain_off[sg],
                               chain_codes + chain_off[sg + 1]);
            } else if (s > segs_off[p]) {
                codes_s.push_back((uint8_t)(-sg - 1));
            }
            // s == segs_off[p]: root entry single, skipped
        }
        voff_s.push_back((int64_t)codes_s.size());
        if (snps_s) {
            for (int64_t i = soff[p]; i < soff[p + 1]; i++)
                snps_s->push_back(master_snps[i]);
            soff_s->push_back((int64_t)snps_s->size());
        }
    }
}

}  // namespace

int64_t skalo_snps_run_paths(
    void* h, const int32_t* segs, const int64_t* segs_off,
    const int64_t* chain_off, const uint8_t* chain_codes,
    const uint64_t* ent_hi, const uint64_t* ent_lo,
    const int64_t* master_snps, const int64_t* soff,
    const int64_t* path_idx, const int64_t* grp_off, int64_t n_groups
) {
  try {
    SnpsCtx& c = *(SnpsCtx*)h;
    int kg = c.k_graph;
    const int T = env_threads();
    std::vector<uint8_t> codes_s;
    std::vector<int64_t> voff_s, snps_s, soff_s;

    if (T <= 1 || !c.do_positioning || n_groups < 2) {
        for (int64_t g = 0; g < n_groups; g++) {
            assemble_group(segs, segs_off, chain_off, chain_codes, ent_hi,
                           ent_lo, master_snps, soff, path_idx, grp_off, kg,
                           g, codes_s, voff_s, &snps_s, &soff_s);
            int64_t r = process_group(
                c, codes_s.data(), voff_s.data(), snps_s.data(), soff_s.data(),
                grp_off[g + 1] - grp_off[g]);
            if (r != 0) return r;
        }
        return 0;
    }

    // Threaded bulk mode, deterministic 3-pass split (the reference runs
    // this stage serially, process_variants.rs:20-225; --threads here is
    // a new capability): the dedup set makes the column pass
    // order-dependent, but positioning is a pure function of a group's
    // sequences — so pass 1 runs columns sequentially in group order,
    // pass 2 fans positioning of the surviving groups across a
    // work-stealing pool, and pass 3 commits in group order. Outputs are
    // byte-identical at any T.
    struct Pending {
        int64_t g;
        int64_t seq_len;
        std::vector<std::pair<int64_t, std::vector<uint8_t>>> found;
        PosResult pr;
    };
    std::vector<Pending> pending;
    for (int64_t g = 0; g < n_groups; g++) {
        assemble_group(segs, segs_off, chain_off, chain_codes, ent_hi,
                       ent_lo, master_snps, soff, path_idx, grp_off, kg,
                       g, codes_s, voff_s, &snps_s, &soff_s);
        std::vector<std::pair<int64_t, std::vector<uint8_t>>> found;
        int64_t r = columns_phase(
            c, codes_s.data(), voff_s.data(), snps_s.data(), soff_s.data(),
            grp_off[g + 1] - grp_off[g], found);
        if (r != 0) return r;
        if (!found.empty())
            pending.push_back(
                Pending{g, voff_s[1] - voff_s[0], std::move(found), PosResult{}});
    }

    auto tp0 = std::chrono::steady_clock::now();
    struct WState {
        PosScratch sc;
        std::vector<uint8_t> wcodes;
        std::vector<int64_t> wvoff;
    };
    pool_for_each(
        pending.size(), T,
        [&]() { return WState{}; },
        [&](WState& w, size_t i) {
            Pending& p = pending[i];
            assemble_group(segs, segs_off, chain_off, chain_codes,
                           ent_hi, ent_lo, master_snps, soff, path_idx,
                           grp_off, kg, p.g, w.wcodes, w.wvoff,
                           nullptr, nullptr);
            p.pr = position_group(c, w.wcodes.data(), w.wvoff.data(),
                                  grp_off[p.g + 1] - grp_off[p.g], w.sc);
        });

    for (auto& p : pending) commit_group(c, p.found, p.pr, p.seq_len);
    if (c.timing)
        c.t_pos += std::chrono::duration<double>(
            std::chrono::steady_clock::now() - tp0).count();
    return 0;
  } catch (const std::bad_alloc&) {
    return -2;  // OOM: caller raises MemoryError, not KeyError
  } catch (const std::length_error&) {
    return -2;
  }
}

int64_t skalo_snps_count(void* h) { return (int64_t)((SnpsCtx*)h)->out_pos.size(); }
int64_t skalo_snps_not_positioned(void* h) { return ((SnpsCtx*)h)->not_positioned; }

void skalo_snps_fill(void* h, int64_t* pos, uint8_t* cols) {
    SnpsCtx& c = *(SnpsCtx*)h;
    memcpy(pos, c.out_pos.data(), c.out_pos.size() * 8);
    memcpy(cols, c.out_cols.data(), c.out_cols.size());
}

void skalo_snps_free(void* h) {
    SnpsCtx* c = (SnpsCtx*)h;
    if (c->timing)
        fprintf(stderr, "[skalo_snps] columns %.1fs positioning %.1fs\n",
                c->t_cols, c->t_pos);
    delete c;
}

}  // extern "C"
