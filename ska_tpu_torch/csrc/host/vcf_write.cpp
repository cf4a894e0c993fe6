// The VCF writer of `ska map -f vcf` (ska_tpu_torch/ref.py,
// RefSka._vcf_records): the records of reference src/ska_ref.rs:707-750
// from the samples' pseudoalignment rows, in one pass. Plain C ABI for
// ctypes.

#include <cstdint>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

// allele code of a byte: A C G T keep their letter, any other byte is N
// (ska_ref.rs:148-156)
struct Alleles {
    uint8_t code[256];
    Alleles() {
        memset(code, 4, sizeof code);
        code['A'] = 0;
        code['C'] = 1;
        code['G'] = 2;
        code['T'] = 3;
    }
};
const Alleles kAlleles;
const char kLetter[5] = {'A', 'C', 'G', 'T', 'N'};

// columns a tile spans: its samples' bytes (tile x samples) stay in L2
int64_t tile_cols(int64_t n_samples) {
    int64_t t = (int64_t(1) << 18) / (n_samples > 0 ? n_samples : 1);
    if (t < 64) t = 64;
    if (t > 8192) t = 8192;
    return t;
}

inline char* put_u64(char* p, uint64_t v) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

}  // namespace

extern "C" {

// Writes the records of the variant columns in [col, len) into out, in
// column order, and stops before the first record that might not fit in
// the cap bytes left. A column is a variant where any sample's byte
// differs from the reference's. Its record:
//   CHROM \t POS \t . \t REF \t ALT \t . \t . \t . \t GT \t gt_1 \t ... gt_S \n
// POS counts from 1 in each contig; REF and the ALT alleles are allele
// letters; a genotype is 0 where the byte is the reference's, . where it
// is a gap, else the 1-based index of its allele in ALT, which lists the
// alleles in order of first appearance over the samples (. when none).
// Returns the bytes written and sets *next_col to the first column not
// written (len when done); -1 when no record fits in an empty buffer,
// -2 on allocation failure.
int64_t ska_vcf_write(
    const uint8_t* aln,          // (n_samples, len) rows, C order
    int64_t n_samples,
    int64_t len,
    const uint8_t* ref,          // the concatenated reference, len bytes
    const int64_t* contig_start, // each contig's first column, ascending
    int64_t n_contig,
    const char* names,           // the contig names, NUL-separated
    int64_t names_len,
    int64_t col,                 // first column to scan
    uint8_t* out,
    int64_t cap,
    int64_t* next_col
) {
    *next_col = len;
    try {
        std::vector<const char*> name(n_contig);
        std::vector<int64_t> name_len(n_contig);
        int64_t longest = 0;
        for (int64_t c = 0, at = 0; c < n_contig; c++) {
            const char* s = names + at;
            int64_t n = 0;
            while (at + n < names_len && s[n]) n++;
            name[c] = s;
            name_len[c] = n;
            if (n > longest) longest = n;
            at += n + 1;
        }
        // the longest record: name, POS, fixed fields, five alleles
        const int64_t bound = longest + 2 * n_samples + 64;
        const int64_t T = tile_cols(n_samples);
        std::vector<uint8_t> diff(T);
        std::vector<int64_t> var(T);
        std::vector<uint8_t> bases(T * (n_samples > 0 ? n_samples : 1));

        int64_t ci = 0;  // contig of the column written last
        int64_t used = 0;
        for (int64_t c0 = col; c0 < len; c0 += T) {
            const int64_t t = len - c0 < T ? len - c0 : T;
            memset(diff.data(), 0, t);
            for (int64_t s = 0; s < n_samples; s++) {
                const uint8_t* row = aln + s * len + c0;
                const uint8_t* r = ref + c0;
                uint8_t* d = diff.data();
                for (int64_t j = 0; j < t; j++) d[j] |= row[j] ^ r[j];
            }
            int64_t nv = 0;
            for (int64_t j = 0; j < t; j++)
                if (diff[j]) var[nv++] = j;
            if (!nv) continue;
            // the variant columns' bytes, sample-minor
            for (int64_t s = 0; s < n_samples; s++) {
                const uint8_t* row = aln + s * len + c0;
                uint8_t* b = bases.data() + s;
                for (int64_t v = 0; v < nv; v++) b[v * n_samples] = row[var[v]];
            }
            for (int64_t v = 0; v < nv; v++) {
                const int64_t cc = c0 + var[v];
                if (cap - used < bound) {
                    if (!used) return -1;
                    *next_col = cc;
                    return used;
                }
                while (ci + 1 < n_contig && contig_start[ci + 1] <= cc) ci++;
                const uint8_t rb = ref[cc];
                const uint8_t* b = bases.data() + v * n_samples;
                char* p = reinterpret_cast<char*>(out) + used;
                memcpy(p, name[ci], name_len[ci]);
                p += name_len[ci];
                *p++ = '\t';
                p = put_u64(p, uint64_t(cc - contig_start[ci] + 1));
                memcpy(p, "\t.\t", 3);
                p += 3;
                *p++ = kLetter[kAlleles.code[rb]];
                *p++ = '\t';
                // ALT goes before the genotypes: find the alleles first
                int8_t rank[5] = {-1, -1, -1, -1, -1};
                int n_alt = 0;
                char alt[5];
                for (int64_t s = 0; s < n_samples; s++) {
                    const uint8_t x = b[s];
                    if (x == rb || x == '-') continue;
                    const uint8_t a = kAlleles.code[x];
                    if (rank[a] < 0) {
                        rank[a] = int8_t(n_alt);
                        alt[n_alt++] = kLetter[a];
                    }
                }
                if (n_alt) {
                    *p++ = alt[0];
                    for (int i = 1; i < n_alt; i++) {
                        *p++ = ',';
                        *p++ = alt[i];
                    }
                } else {
                    *p++ = '.';
                }
                memcpy(p, "\t.\t.\t.\tGT\t", 10);
                p += 10;
                for (int64_t s = 0; s < n_samples; s++) {
                    const uint8_t x = b[s];
                    *p++ = x == rb ? '0'
                         : x == '-' ? '.'
                         : char('1' + rank[kAlleles.code[x]]);
                    *p++ = '\t';
                }
                if (n_samples) p--;
                *p++ = '\n';
                used = p - reinterpret_cast<char*>(out);
            }
        }
        return used;
    } catch (const std::bad_alloc&) {
        return -2;
    } catch (const std::length_error&) {
        return -2;
    }
}

}  // extern "C"
