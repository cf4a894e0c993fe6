// Cross-batch merge for `ska build` / `ska merge`: B-way merge of sorted
// split k-mer key arrays with column-block copies into the union matrix.
//
// A copy of the JAX package's csrc/merge_batches.cpp, called by
// ska_tpu_torch/merge.py extend_arrays. It replaces a host lexsort (one
// lexsort over the concatenation of every batch's keys) with a linear
// k-way merge over the already-sorted per-batch arrays — the reference
// analog is MergeSkaDict::extend/merge (merge_ska_dict.rs:119-193), which
// this generalizes to B inputs in a single pass. No host sort ever
// touches the full union.
//
// Inputs are concatenated on the python side:
//   keys_cat  (sum_n, W) uint64, lex-ordered within each batch
//   n_off     (B+1) int64 row offsets of each batch in keys_cat
//   var_cat   concatenated row-major per-batch variant blocks
//   v_off     (B+1) int64 element offsets of each batch in var_cat
//   col_off   (B+1) int64 column start of each batch in the output
// Outputs (allocated by the caller at worst-case sum_n rows):
//   out_keys  (sum_n, W), out_var (sum_n, S_total) pre-filled with '-',
//   out_counts (sum_n)
// Returns the number of union rows.

#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

int64_t ska_merge_batches(
    const uint64_t* keys_cat, const int64_t* n_off,
    const uint8_t* var_cat, const int64_t* v_off,
    const int64_t* col_off,
    int64_t B, int64_t W,
    uint64_t* out_keys, uint8_t* out_var, int64_t* out_counts,
    int64_t s_total
) {
    // per-batch cursors; -2 on allocation failure (caller raises a clean
    // MemoryError — a bad_alloc escaping extern "C" into ctypes aborts)
    int64_t* cur = new (std::nothrow) int64_t[B];
    if (!cur) return -2;
    for (int64_t b = 0; b < B; b++) cur[b] = n_off[b];

    int64_t r = 0;
    for (;;) {
        // min key across live cursors (B is small: linear scan)
        const uint64_t* mink = nullptr;
        for (int64_t b = 0; b < B; b++) {
            if (cur[b] >= n_off[b + 1]) continue;
            const uint64_t* k = keys_cat + cur[b] * W;
            if (!mink) { mink = k; continue; }
            for (int64_t w = 0; w < W; w++) {
                if (k[w] < mink[w]) { mink = k; break; }
                if (k[w] > mink[w]) break;
            }
        }
        if (!mink) break;

        uint64_t* ok = out_keys + r * W;
        for (int64_t w = 0; w < W; w++) ok[w] = mink[w];
        uint8_t* orow = out_var + r * s_total;
        int64_t cnt = 0;
        for (int64_t b = 0; b < B; b++) {
            if (cur[b] >= n_off[b + 1]) continue;
            const uint64_t* k = keys_cat + cur[b] * W;
            bool eq = true;
            for (int64_t w = 0; w < W; w++)
                if (k[w] != mink[w]) { eq = false; break; }
            if (!eq) continue;
            // skip past any equal-key duplicates within this batch (only
            // possible for malformed/third-party .skf inputs) keeping the
            // LAST one, matching the numpy fallback's lexsort+unique
            // last-write-wins collapse in extend_arrays
            while (cur[b] + 1 < n_off[b + 1]) {
                const uint64_t* nk = keys_cat + (cur[b] + 1) * W;
                bool neq = true;
                for (int64_t w = 0; w < W; w++)
                    if (nk[w] != mink[w]) { neq = false; break; }
                if (!neq) break;
                cur[b]++;
            }
            int64_t sb = col_off[b + 1] - col_off[b];
            const uint8_t* src =
                var_cat + v_off[b] + (cur[b] - n_off[b]) * sb;
            memcpy(orow + col_off[b], src, (size_t)sb);
            for (int64_t j = 0; j < sb; j++)
                if (src[j] != (uint8_t)'-') cnt++;
            cur[b]++;
        }
        out_counts[r] = cnt;
        r++;
    }
    delete[] cur;
    return r;
}

}  // extern "C"
