// The pseudoalignment writer of `ska map` (ska_tpu_torch/ref.py,
// RefSka.pseudoalignment): a copy of ska_aln_write from the JAX
// package's csrc/skanative.cpp, so that both write the same alignment
// bytes. Plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---- pseudoalignment writer (ska map) -------------------------------------------
//
// Exact port of the AlnWriter state machine semantics
// (reference src/ska_ref/aln_writer.rs:48-186): fills split k-mer flanks
// from the reference, overhangs between matches, middle bases at
// finalisation, and repeat masking. One call per sample; O(genome).

int ska_aln_write(
    const uint8_t* ref_seq,      // concatenated reference
    const int64_t* chrom_len,    // per-chromosome lengths
    int64_t n_chrom,
    const int32_t* m_chrom,      // mapped chrom per hit row
    const int64_t* m_pos,        // mapped position per hit row
    const uint8_t* bases,        // this sample's base per hit row
    int64_t n_hits,
    int64_t half,                // (k-1)/2
    const uint8_t* is_ambig,     // 256-entry ambiguity table
    int mask_ambig,
    const int64_t* repeat_coors,
    int64_t n_repeats,
    uint8_t* out                 // pre-filled with '-', length = total ref
) {                              // returns 0, or -2 on allocation failure
    int64_t next_pos = half;
    int64_t curr_chrom = 0;
    int64_t last_mapped = 0;
    int64_t last_written = 0;
    int64_t chrom_offset = 0;

    // middle-base buffer — a bad_alloc here must not escape the extern
    // "C" boundary (ctypes would terminate the process); the caller
    // raises a clean MemoryError on -2
    int64_t* mid_pos = new (std::nothrow) int64_t[n_hits];
    uint8_t* mid_base = new (std::nothrow) uint8_t[n_hits];
    if (!mid_pos || !mid_base) {
        delete[] mid_pos;
        delete[] mid_base;
        return -2;
    }
    int64_t n_mid = 0;

    const uint8_t* chrom_seq = ref_seq;  // start of current chromosome

    auto fill_fwd = [&](int64_t maximum) {
        if (last_written > 0) {
            int64_t overhang = last_mapped + half - last_written;
            if (overhang < 0) overhang = 0;
            int64_t start = last_written + 1;
            int64_t end = start + overhang;
            if (end > maximum) end = maximum;
            if (end > start) {
                memcpy(out + start + chrom_offset, chrom_seq + start, end - start);
                last_written = end;
            }
        }
    };
    auto fill_contig = [&]() {
        int64_t clen = chrom_len[curr_chrom];
        fill_fwd(clen);
        chrom_offset += clen;
        chrom_seq += clen;
        curr_chrom += 1;
        next_pos = half;
    };

    for (int64_t i = 0; i < n_hits; i++) {
        uint8_t base = bases[i];
        if (base == '-') continue;
        int64_t mc = m_chrom[i];
        int64_t mp = m_pos[i];
        while (mc > curr_chrom) fill_contig();
        uint8_t b = (mask_ambig && is_ambig[base]) ? (uint8_t)'N' : base;
        mid_pos[n_mid] = mp + chrom_offset;
        mid_base[n_mid] = b;
        n_mid++;
        if (mp < next_pos) {
            last_mapped = mp;
        } else {
            if (mp > next_pos) fill_fwd(mp - half);
            memcpy(out + (mp - half) + chrom_offset, chrom_seq + (mp - half), half);
            next_pos = mp + half + 1;
            last_mapped = mp;
            last_written = mp;
        }
    }
    while (curr_chrom < n_chrom) fill_contig();
    for (int64_t i = 0; i < n_mid; i++) out[mid_pos[i]] = mid_base[i];
    for (int64_t i = 0; i < n_repeats; i++) {
        int64_t p = repeat_coors[i];
        if (out[p] != '-') out[p] = 'N';
    }
    delete[] mid_pos;
    delete[] mid_base;
    return 0;
}

}  // extern "C"
