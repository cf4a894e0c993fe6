// CRC-32C, the snappy block codec, snappy frame decoding and the CBOR
// uint-array codecs behind the port's .skf reader and writer
// (ska_tpu_torch/io/{snappy,cbor,skf}.py, csrc/host/save.cpp).
//
// A copy of the functions of the JAX package's csrc/skanative.cpp that
// `build`, `load` and `align` call, so that both write and read the same
// bytes: the greedy snappy compressor in particular fixes the .skf
// bytes. Two changes make every function safe to call from several
// threads at once (save.cpp compresses chunks on the host pool), and
// neither changes a byte: the compressor's hash table is the call's own
// (the table is cleared on every call in both), and the CRC table and
// the SSE4.2 probe are set up once under std::call_once. The multi-threaded
// frame decoder (SKA_THREADS), the byte-narrow and u128 CBOR encoders
// are not copied: the port's path does not call them; the
// pseudoalignment writer is in aln_write.cpp. Plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <mutex>

#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>
#define SKA_X86 1
#endif

extern "C" {

// ---- CRC-32C (Castagnoli), slice-by-8 ----------------------------------------

static uint32_t crc_table[8][256];
static std::once_flag crc_once;

static void crc_init() {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
        crc_table[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = crc_table[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc_table[0][c & 0xFF] ^ (c >> 8);
            crc_table[t][i] = c;
        }
    }
}

#ifdef SKA_X86
// Hardware CRC32C (SSE4.2 crc32 instruction, ~15 GB/s vs ~1.3 GB/s for
// the sliced table): the frame decoder CRC-checks every chunk of every
// .skf load, so this was 45% of the whole-frame decode wall time.
__attribute__((target("sse4.2"))) static uint32_t
crc32c_hw(const uint8_t* data, size_t n) {
    uint64_t crc = 0xFFFFFFFFu;
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        memcpy(&w, data + i, 8);
        crc = _mm_crc32_u64(crc, w);
    }
    uint32_t c = (uint32_t)crc;
    for (; i < n; i++) c = _mm_crc32_u8(c, data[i]);
    return c ^ 0xFFFFFFFFu;
}
static bool crc_hw_ok = false;
static std::once_flag crc_hw_once;  // the cpuid probe is cheap but not free
#endif

uint32_t ska_crc32c(const uint8_t* data, size_t n) {
#ifdef SKA_X86
    std::call_once(crc_hw_once, [] {
        crc_hw_ok = __builtin_cpu_supports("sse4.2");
    });
    if (crc_hw_ok) return crc32c_hw(data, n);
#endif
    std::call_once(crc_once, crc_init);
    uint32_t crc = 0xFFFFFFFFu;
    size_t i = 0;
    while (i + 8 <= n) {
        uint64_t w;
        memcpy(&w, data + i, 8);
        w ^= crc;
        crc = crc_table[7][w & 0xFF] ^ crc_table[6][(w >> 8) & 0xFF] ^
              crc_table[5][(w >> 16) & 0xFF] ^ crc_table[4][(w >> 24) & 0xFF] ^
              crc_table[3][(w >> 32) & 0xFF] ^ crc_table[2][(w >> 40) & 0xFF] ^
              crc_table[1][(w >> 48) & 0xFF] ^ crc_table[0][(w >> 56) & 0xFF];
        i += 8;
    }
    for (; i < n; i++) crc = crc_table[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

// ---- snappy block decompress ---------------------------------------------------

// returns uncompressed length, or -1 on error; call with out=null to query size
long long ska_snappy_uncompressed_length(const uint8_t* in, size_t n) {
    size_t pos = 0;
    uint64_t len = 0;
    int shift = 0;
    while (pos < n) {
        uint8_t b = in[pos++];
        len |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) return (long long)len;
        shift += 7;
        if (shift > 63) return -1;
    }
    return -1;
}

// 8-byte copy through a register: load completes before the store, so
// overlapping ranges replicate the already-written prefix — exactly the
// distance-doubling behavior the overlap fast path below relies on.
static inline void ska_copy8(uint8_t* d, const uint8_t* s) {
    uint64_t w;
    memcpy(&w, s, 8);
    memcpy(d, &w, 8);
}

long long ska_snappy_uncompress(const uint8_t* in, size_t n, uint8_t* out, size_t out_cap) {
    size_t pos = 0;
    // skip varint length
    while (pos < n && (in[pos] & 0x80)) pos++;
    if (pos >= n) return -1;
    pos++;

    size_t opos = 0;
    while (pos < n) {
        uint8_t tag = in[pos++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            size_t len = tag >> 2;
            if (len >= 60) {
                size_t nb = len - 59;
                if (pos + nb > n) return -1;
                len = 0;
                for (size_t j = 0; j < nb; j++) len |= (size_t)in[pos + j] << (8 * j);
                pos += nb;
            }
            len += 1;
            if (pos + len > n || opos + len > out_cap) return -1;
            if (len <= 16 && pos + 16 <= n && opos + 16 <= out_cap) {
                // unconditional 16-byte copy: short literals dominate and
                // the slack bytes are rewritten by the next op
                ska_copy8(out + opos, in + pos);
                ska_copy8(out + opos + 8, in + pos + 8);
            } else {
                memcpy(out + opos, in + pos, len);
            }
            pos += len;
            opos += len;
        } else {
            size_t len, off;
            if (kind == 1) {
                len = ((tag >> 2) & 0x7) + 4;
                if (pos >= n) return -1;
                off = ((size_t)(tag >> 5) << 8) | in[pos++];
            } else if (kind == 2) {
                len = (tag >> 2) + 1;
                if (pos + 2 > n) return -1;
                off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8);
                pos += 2;
            } else {
                len = (tag >> 2) + 1;
                if (pos + 4 > n) return -1;
                off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8) |
                      ((size_t)in[pos + 2] << 16) | ((size_t)in[pos + 3] << 24);
                pos += 4;
            }
            if (off == 0 || off > opos || opos + len > out_cap) return -1;
            if (off >= len) {
                if (len <= 16 && opos + 16 <= out_cap) {
                    // inline 16-byte register copy: short back-copies
                    // dominate the stream and a memcpy call per op costs
                    // more than the copy; slack bytes past len are
                    // rewritten by the strictly-sequential next op (the
                    // same convention as the literal fast path above)
                    ska_copy8(out + opos, out + opos - off);
                    ska_copy8(out + opos + 8, out + opos - off + 8);
                } else {
                    memcpy(out + opos, out + opos - off, len);
                }
            } else if (opos + len + 8 <= out_cap) {
                // overlapping copy (period `off` < len): double the copy
                // distance with register-buffered 8-byte copies until it
                // reaches 8, then stride 8 — may scribble up to 7 slack
                // bytes past len, which the next op rewrites (hence the
                // +8 cap guard; the tail falls back to the byte loop)
                uint8_t* op = out + opos;
                const uint8_t* sp = op - off;
                long long rem = (long long)len;
                while (op - sp < 8) {
                    ska_copy8(op, sp);
                    size_t d = (size_t)(op - sp);
                    rem -= (long long)d;
                    if (rem <= 0) break;
                    op += d;
                }
                while (rem > 0) {
                    ska_copy8(op, sp);
                    op += 8;
                    sp += 8;
                    rem -= 8;
                }
            } else {
                for (size_t j = 0; j < len; j++) out[opos + j] = out[opos - off + j];
            }
            opos += len;
        }
    }
    return (long long)opos;
}

// ---- snappy framing: whole-frame decode ------------------------------------
// One call walks every chunk of a framed stream (framing_format.txt),
// CRC-checks and decompresses straight into `out` — replacing the
// python per-chunk loop (1229 chunks on a 4-sample dense .skf cost
// ~0.3-0.5 s of interpreter overhead + intermediate bytes churn).
// Call with out=NULL to size the output (no CRC checks on that pass).
// Returns total uncompressed bytes; -1 malformed or unskippable chunk;
// -2 stored-checksum mismatch.
long long ska_snappy_frame_decompress(const uint8_t* in, size_t n,
                                      uint8_t* out, size_t cap) {
    static const uint8_t MAGIC[10] = {0xFF, 0x06, 0x00, 0x00,
                                      's',  'N',  'a',  'P', 'p', 'Y'};
    if (n < 10 || memcmp(in, MAGIC, 10) != 0) return -1;
    size_t pos = 10, opos = 0;
    while (pos < n) {
        if (pos + 4 > n) return -1;
        uint8_t ctype = in[pos];
        size_t clen = (size_t)in[pos + 1] | ((size_t)in[pos + 2] << 8) |
                      ((size_t)in[pos + 3] << 16);
        pos += 4;
        if (pos + clen > n) return -1;
        if (ctype == 0x00 || ctype == 0x01) {
            if (clen < 4) return -1;
            const uint8_t* body = in + pos + 4;
            size_t blen = clen - 4;
            size_t ulen;
            if (ctype == 0x00) {
                long long u = ska_snappy_uncompressed_length(body, blen);
                if (u < 0) return -1;
                ulen = (size_t)u;
            } else {
                ulen = blen;
            }
            if (out) {
                if (opos + ulen > cap) return -1;
                if (ctype == 0x00) {
                    long long got =
                        ska_snappy_uncompress(body, blen, out + opos, cap - opos);
                    if (got != (long long)ulen) return -1;
                } else {
                    memcpy(out + opos, body, ulen);
                }
                uint32_t crc = ska_crc32c(out + opos, ulen);
                uint32_t masked =
                    (uint32_t)(((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
                uint32_t want = (uint32_t)in[pos] | ((uint32_t)in[pos + 1] << 8) |
                                ((uint32_t)in[pos + 2] << 16) |
                                ((uint32_t)in[pos + 3] << 24);
                if (masked != want) return -2;
            }
            opos += ulen;
        } else if (ctype != 0xFF && !(ctype >= 0x80 && ctype <= 0xFD)) {
            return -1;  // unskippable unknown chunk type
        }
        pos += clen;
    }
    return (long long)opos;
}

// ---- snappy block compress (greedy hash-table matcher) --------------------------

static inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline size_t emit_literal(uint8_t* out, size_t opos, const uint8_t* lit, size_t len) {
    size_t n = len - 1;
    if (n < 60) {
        out[opos++] = (uint8_t)(n << 2);
    } else if (n < 0x100) {
        out[opos++] = 60 << 2;
        out[opos++] = (uint8_t)n;
    } else if (n < 0x10000) {
        out[opos++] = 61 << 2;
        out[opos++] = (uint8_t)n;
        out[opos++] = (uint8_t)(n >> 8);
    } else {
        out[opos++] = 62 << 2;
        out[opos++] = (uint8_t)n;
        out[opos++] = (uint8_t)(n >> 8);
        out[opos++] = (uint8_t)(n >> 16);
    }
    memcpy(out + opos, lit, len);
    return opos + len;
}

static inline size_t emit_copy(uint8_t* out, size_t opos, size_t off, size_t len) {
    // emit copies of length <= 64; caller splits longer matches
    while (len > 0) {
        size_t chunk = len > 64 ? 64 : len;
        if (len > 64 && len - 64 < 4) chunk = 60;  // avoid leaving <4 remainder
        if (chunk >= 4 && chunk <= 11 && off < 2048) {
            out[opos++] = (uint8_t)(1 | ((chunk - 4) << 2) | ((off >> 8) << 5));
            out[opos++] = (uint8_t)off;
        } else {
            out[opos++] = (uint8_t)(2 | ((chunk - 1) << 2));
            out[opos++] = (uint8_t)off;
            out[opos++] = (uint8_t)(off >> 8);
        }
        len -= chunk;
    }
    return opos;
}

// out_cap must be >= 32 + n + n/6 (snappy MaxCompressedLength). The
// hash table is on the call's stack, so concurrent calls share nothing.
long long ska_snappy_compress(const uint8_t* in, size_t n, uint8_t* out, size_t out_cap) {
    (void)out_cap;
    size_t opos = 0;
    // varint uncompressed length
    size_t v = n;
    while (v >= 0x80) {
        out[opos++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    out[opos++] = (uint8_t)v;

    if (n < 15) {
        if (n) opos = emit_literal(out, opos, in, n);
        return (long long)opos;
    }

    const size_t HASH_BITS = 14;
    const size_t HASH_SIZE = (size_t)1 << HASH_BITS;
    uint16_t table[1 << 14];
    memset(table, 0, sizeof(table));

    size_t ip = 0;
    size_t lit_start = 0;
    size_t limit = n - 4;

    while (ip <= limit) {
        uint32_t h = (load32(in + ip) * 0x1E35A7BDu) >> (32 - HASH_BITS);
        size_t cand = table[h % HASH_SIZE];
        table[h % HASH_SIZE] = (uint16_t)(ip & 0xFFFF);
        // 16-bit table entries: reconstruct candidate in the last 64KB window
        size_t base = ip & ~(size_t)0xFFFF;
        size_t cpos = base + cand;
        if (cpos >= ip) {
            if (cpos < 0x10000 || cpos - 0x10000 >= ip) {
                ip++;
                continue;
            }
            cpos -= 0x10000;
        }
        if (cpos < ip && ip - cpos < 0x10000 && load32(in + cpos) == load32(in + ip)) {
            // emit pending literal
            if (ip > lit_start) opos = emit_literal(out, opos, in + lit_start, ip - lit_start);
            // extend match
            size_t mlen = 4;
            while (ip + mlen < n && in[cpos + mlen] == in[ip + mlen]) mlen++;
            opos = emit_copy(out, opos, ip - cpos, mlen);
            ip += mlen;
            lit_start = ip;
        } else {
            ip++;
        }
    }
    if (lit_start < n) opos = emit_literal(out, opos, in + lit_start, n - lit_start);
    return (long long)opos;
}

// ---- CBOR bulk uint array codecs -------------------------------------------------
//
// The .skf format (reference merge_ska_array.rs:191-204) serializes split
// k-mers / variant bytes / counts as CBOR arrays of unsigned ints (ciborium:
// minimal-length heads; u128 values above u64::MAX become tag-2 positive
// bignums). Per-element Python encode/decode costs ~10s per 4M-k-mer file;
// these bulk codecs run at memory speed.

static inline size_t put_be(uint8_t* o, size_t p, uint64_t x, int nbytes) {
    for (int i = nbytes - 1; i >= 0; i--) o[p++] = (uint8_t)(x >> (8 * i));
    return p;
}

// Encode n uint64 values as consecutive CBOR unsigned ints. out capacity
// must be >= 9*n. Returns bytes written.
long long ska_cbor_encode_uints(const uint64_t* v, long long n, uint8_t* out) {
    size_t p = 0;
    for (long long i = 0; i < n; i++) {
        uint64_t x = v[i];
        if (x < 24) out[p++] = (uint8_t)x;
        else if (x < 0x100) { out[p++] = 0x18; out[p++] = (uint8_t)x; }
        else if (x < 0x10000) { out[p++] = 0x19; p = put_be(out, p, x, 2); }
        else if (x < 0x100000000ULL) { out[p++] = 0x1A; p = put_be(out, p, x, 4); }
        else { out[p++] = 0x1B; p = put_be(out, p, x, 8); }
    }
    return (long long)p;
}

// Decode up to n consecutive CBOR unsigned ints (incl. tag-2 bignums up to
// 16 bytes) into hi/lo limb arrays. Returns the count decoded (stops early
// at any non-uint item or truncation); *consumed gets bytes read.
// hi may be NULL: then bignums also stop the scan (the caller re-enters
// with limb buffers from the stop point) — this lets pure-u64 arrays
// decode with HALF the output traffic, which matters because fresh-page
// faults dominate bulk decode cost on some hosts (see BASELINE.md).
long long ska_cbor_decode_uints(
    const uint8_t* in, long long len, long long n,
    uint64_t* hi, uint64_t* lo, long long* consumed
) {
    size_t p = 0;
    long long i = 0;
    for (; i < n; i++) {
        if ((long long)p >= len) break;
        uint8_t ib = in[p];
        uint8_t major = ib >> 5, info = ib & 0x1F;
        if (major == 0) {
            uint64_t x;
            if (info < 24) { x = info; p += 1; }
            else if (info == 24) { if ((long long)(p + 2) > len) break; x = in[p + 1]; p += 2; }
            else if (info == 25) { if ((long long)(p + 3) > len) break; x = ((uint64_t)in[p+1] << 8) | in[p+2]; p += 3; }
            else if (info == 26) {
                if ((long long)(p + 5) > len) break;
                x = 0; for (int b = 1; b <= 4; b++) x = (x << 8) | in[p + b];
                p += 5;
            } else if (info == 27) {
                if ((long long)(p + 9) > len) break;
                x = 0; for (int b = 1; b <= 8; b++) x = (x << 8) | in[p + b];
                p += 9;
            } else break;
            if (hi) hi[i] = 0;
            lo[i] = x;
        } else if (major == 6 && info == 2) {
            // tag 2 bignum; byte string follows
            if (hi == nullptr) break;
            if ((long long)(p + 1) >= len) break;
            uint8_t sb = in[p + 1];
            if ((sb >> 5) != 2) break;
            uint8_t sinfo = sb & 0x1F;
            size_t q = p + 2;
            uint64_t blen;
            if (sinfo < 24) blen = sinfo;
            else if (sinfo == 24) { if ((long long)(q + 1) > len) break; blen = in[q]; q += 1; }
            else break;
            if (blen > 16 || (long long)(q + blen) > len) break;
            uint64_t h = 0, l = 0;
            for (uint64_t b = 0; b < blen; b++) {
                h = (h << 8) | (l >> 56);
                l = (l << 8) | in[q + b];
            }
            hi[i] = h; lo[i] = l;
            p = q + blen;
        } else break;
    }
    *consumed = (long long)p;
    return i;
}

// Byte-narrow variant: decode consecutive CBOR unsigned ints that all fit
// u8 straight into a uint8 array — 1/8th the output pages of the u64
// decoder, which is what the big `.skf` variant matrix (one base byte per
// cell) actually needs on fault-slow hosts (see BASELINE.md). Stops at the
// first value > 255, non-uint item, or truncation; the caller then redoes
// the whole array through ska_cbor_decode_uints (decode CPU is ~3 ns/item,
// so a discarded partial pass is cheap next to the page traffic saved).
long long ska_cbor_decode_u8(
    const uint8_t* in, long long len, long long n,
    uint8_t* out, long long* consumed
) {
    size_t p = 0;
    long long i = 0;
    for (; i < n; i++) {
        if ((long long)p >= len) break;
        uint8_t ib = in[p];
        if (ib < 24) { out[i] = ib; p += 1; }
        else if (ib == 0x18) {
            if ((long long)(p + 2) > len) break;
            out[i] = in[p + 1]; p += 2;
        } else break;
    }
    *consumed = (long long)p;
    return i;
}
}  // extern "C"
