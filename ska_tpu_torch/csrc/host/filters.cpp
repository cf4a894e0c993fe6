// Site filters of `ska align`: the keep mask of SkaArray.filter and the
// per-row recount of SkaArray.update_counts (ska_tpu_torch/array.py).
// A copy of ska_filter_keep and ska_update_counts from the JAX package's
// csrc/host_build.cpp, so that `align` keeps the same rows.

#include <cstdint>
#include <cstddef>

extern "C" {

// Single-pass site-filter predicates (merge_ska_array.rs:289-402 /
// ska_tpu/array.py SkaArray.filter): per row of the (n x S) ASCII
// variants matrix, out_keep[i] = (counts[i] >= min_count) && pred(mode).
// Replaces numpy's full-matrix int16 widening + where + min/max
// reduction chain (~140 MB of temporaries at 4.4M x 4, ~2.5 s on this
// host's fault weather) with one read of the matrix itself.
//
// modes: 0 = no-filter; 1 = no-const (>1 distinct value among the
// considered cells; considered = all cells, or non-'-' cells when
// ignore_const_gaps); 2 = no-ambig (no cell is IUPAC-ambiguous per the
// 256-entry is_ambig table); 3 = no-ambig-or-const (>1 of the presence
// classes {A,C,G,T,U} — plus '-' unless ignore_const_gaps — occur).
// counts is int64 (counts_is_i64) or uint8 (the byte-narrow .skf
// decode); is_ambig may be NULL for modes 0/1.
void ska_filter_keep(const uint8_t* v, long long n, int S,
                     const void* counts, int counts_is_i64,
                     long long min_count, int mode,
                     int ignore_const_gaps, const uint8_t* is_ambig,
                     uint8_t* out_keep) {
    const int64_t* c64 = counts_is_i64 ? (const int64_t*)counts : nullptr;
    const uint8_t* c8 = counts_is_i64 ? nullptr : (const uint8_t*)counts;
    for (long long i = 0; i < n; ++i) {
        long long cnt = c64 ? c64[i] : (long long)c8[i];
        bool keep = cnt >= min_count;
        if (keep && mode != 0) {
            const uint8_t* row = v + (size_t)i * S;
            if (mode == 1) {
                int first = -1;
                bool two = false;
                for (int s = 0; s < S; ++s) {
                    uint8_t b = row[s];
                    if (ignore_const_gaps && b == '-') continue;
                    if (first < 0) first = b;
                    else if (b != first) { two = true; break; }
                }
                keep = two;
            } else if (mode == 2) {
                bool amb = false;
                for (int s = 0; s < S; ++s) amb |= is_ambig[row[s]] != 0;
                keep = !amb;
            } else {  // mode 3
                unsigned classes = 0;
                for (int s = 0; s < S; ++s) {
                    switch (row[s]) {
                        case 'A': classes |= 1u; break;
                        case 'C': classes |= 2u; break;
                        case 'G': classes |= 4u; break;
                        case 'T': classes |= 8u; break;
                        case 'U': classes |= 16u; break;
                        case '-': if (!ignore_const_gaps) classes |= 32u;
                                  break;
                        default: break;
                    }
                }
                keep = __builtin_popcount(classes) > 1;
            }
        }
        out_keep[i] = keep ? 1 : 0;
    }
}

// Single-pass per-row non-missing recount (merge_ska_array.rs:139-163 /
// ska_tpu/array.py update_counts): cells != '-' (and not ambiguous when
// drop_ambig). One matrix read instead of numpy's bool matrix + mask +
// sum-reduce temporaries.
void ska_update_counts(const uint8_t* v, long long n, int S,
                       int drop_ambig, const uint8_t* is_ambig,
                       int64_t* out_counts) {
    for (long long i = 0; i < n; ++i) {
        const uint8_t* row = v + (size_t)i * S;
        long long c = 0;
        if (drop_ambig) {
            for (int s = 0; s < S; ++s)
                c += (row[s] != '-' && !is_ambig[row[s]]);
        } else {
            for (int s = 0; s < S; ++s) c += row[s] != '-';
        }
        out_counts[i] = c;
    }
}

}  // extern "C"
