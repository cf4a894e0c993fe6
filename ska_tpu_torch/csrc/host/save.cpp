// The one-pass .skf writer behind ska_tpu_torch/io/skf.py save: CBOR
// encode + snappy framing, a copy of save_impl and ska_host_save from
// the JAX package's csrc/host_modes.cpp, so that both packages write the
// same bytes for the same array.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

extern "C" {
long long ska_cbor_encode_uints(const uint64_t* v, long long n, uint8_t* out);
long long ska_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                              size_t out_cap);
uint32_t ska_crc32c(const uint8_t* data, size_t n);
}


namespace {

// split a NUL-separated blob into n views; short blobs yield empty tails
static std::vector<std::pair<const char*, size_t>> split_blob(
    const uint8_t* blob, long long blob_len, long long n_items) {
    std::vector<std::pair<const char*, size_t>> out;
    const uint8_t* p = blob;
    const uint8_t* end = blob + blob_len;
    for (long long i = 0; i < n_items; i++) {
        const uint8_t* z = (const uint8_t*)memchr(p, 0, end - p);
        size_t ln = z ? (size_t)(z - p) : (size_t)(end - p);
        out.emplace_back((const char*)p, ln);
        p += ln + (z ? 1 : 0);
    }
    return out;
}

// `.skf` save: the full CBOR encode + snappy framing in one pass,
// byte-identical to the python encoder (io/skf.py save + io/snappy.py
// frame_compress; reference merge_ska_array.rs:191-204). Field order,
// minimal-width heads, ciborium bignums and the 64 KiB framing chunks
// all match — tests/test_host_cmds.py pins equality. 0 ok, nonzero =
// caller falls back to the python encoder.
static long long save_impl(
    const char* path, const uint64_t* keys, long long n, int W,
    const uint8_t* variants, long long S, const uint64_t* counts,
    const std::vector<std::pair<const char*, size_t>>& names, int k,
    int rc, const uint8_t* version, long long version_len) {
    if (W != 1 && W != 2) return -1;
    long long n_names = (long long)names.size();
    size_t names_bytes = 0;
    for (const auto& nm : names) names_bytes += nm.second + 3;
    std::vector<uint8_t> buf;
    try {
        buf.reserve((size_t)n * (W == 1 ? 9 : 19) + (size_t)n * S * 2 +
                    (size_t)n * 9 + names_bytes + 256);
    } catch (const std::bad_alloc&) {
        return -1;
    }
    auto head = [&](int major, uint64_t v) {
        uint8_t m = (uint8_t)(major << 5);
        if (v < 24) buf.push_back(m | (uint8_t)v);
        else if (v < 0x100) { buf.push_back(m | 24); buf.push_back((uint8_t)v); }
        else if (v < 0x10000) {
            buf.push_back(m | 25);
            buf.push_back((uint8_t)(v >> 8));
            buf.push_back((uint8_t)v);
        } else if (v < 0x100000000ULL) {
            buf.push_back(m | 26);
            for (int i = 3; i >= 0; i--) buf.push_back((uint8_t)(v >> (8 * i)));
        } else {
            buf.push_back(m | 27);
            for (int i = 7; i >= 0; i--) buf.push_back((uint8_t)(v >> (8 * i)));
        }
    };
    auto text = [&](const char* s_, size_t ln) {
        head(3, ln);
        buf.insert(buf.end(), (const uint8_t*)s_, (const uint8_t*)s_ + ln);
    };

    head(5, 8);  // same insertion order as io/skf.py save()
    text("k", 1); head(0, (uint64_t)k);
    text("rc", 2); buf.push_back(rc ? 0xF5 : 0xF4);
    text("names", 5);
    head(4, (uint64_t)n_names);
    for (const auto& nm : names) text(nm.first, nm.second);
    text("split_kmers", 11);
    head(4, (uint64_t)n);
    if (W == 1) {
        size_t base = buf.size();
        buf.resize(base + (size_t)n * 9);
        long long wrote = ska_cbor_encode_uints(keys, n, buf.data() + base);
        buf.resize(base + (size_t)wrote);
    } else {
        // ciborium u128s: plain uint when hi == 0, else tag-2 positive
        // bignum with minimal big-endian bytes (io/cbor.py U128s)
        for (long long i = 0; i < n; i++) {
            uint64_t hi = keys[2 * i], lo = keys[2 * i + 1];
            if (hi == 0) {
                head(0, lo);
            } else {
                buf.push_back(0xC2);
                int hbits = 64 - __builtin_clzll(hi);
                int nbytes = (64 + hbits + 7) / 8;
                head(2, (uint64_t)nbytes);
                for (int b = nbytes - 1; b >= 0; b--) {
                    uint64_t limb = b >= 8 ? hi : lo;
                    buf.push_back((uint8_t)(limb >> (8 * (b & 7))));
                }
            }
        }
    }
    text("variants", 8);
    head(5, 3);
    text("v", 1); head(0, 1);
    text("dim", 3);
    head(4, 2); head(0, (uint64_t)n); head(0, (uint64_t)S);
    text("data", 4);
    head(4, (uint64_t)(n * S));
    {
        const size_t cells = (size_t)(n * S);
        size_t base = buf.size();
        buf.resize(base + 2 * cells);
        uint8_t* o = buf.data() + base;
        for (size_t i = 0; i < cells; i++) {
            uint8_t c = variants[i];
            if (c < 24) {
                *o++ = c;
            } else {
                *o++ = 0x18;
                *o++ = c;
            }
        }
        buf.resize((size_t)(o - buf.data()));
    }
    text("variant_count", 13);
    head(4, (uint64_t)n);
    {
        size_t base = buf.size();
        buf.resize(base + (size_t)n * 9);
        long long wrote = ska_cbor_encode_uints(counts, n, buf.data() + base);
        buf.resize(base + (size_t)wrote);
    }
    text("ska_version", 11);
    text((const char*)version, (size_t)version_len);
    text("k_bits", 6); head(0, W == 1 ? 64u : 128u);

    // snappy framing, 64 KiB chunks (io/snappy.py frame_compress)
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    static const uint8_t MAGIC[10] = {0xFF, 0x06, 0x00, 0x00,
                                      's',  'N',  'a',  'P', 'p', 'Y'};
    fwrite(MAGIC, 1, 10, f);
    const size_t CH = 65536;
    std::vector<uint8_t> comp;
    try {
        comp.resize(32 + CH + CH / 6);
    } catch (const std::bad_alloc&) {
        fclose(f);
        return -1;
    }
    for (size_t pos = 0; pos < buf.size(); pos += CH) {
        size_t ln = buf.size() - pos < CH ? buf.size() - pos : CH;
        const uint8_t* chunk = buf.data() + pos;
        uint32_t crc = ska_crc32c(chunk, ln);
        uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
        long long cl = ska_snappy_compress(chunk, ln, comp.data(), comp.size());
        bool use_comp = cl > 0 && (size_t)cl < ln;
        size_t body = 4 + (use_comp ? (size_t)cl : ln);
        uint8_t hdr[4] = {use_comp ? (uint8_t)0x00 : (uint8_t)0x01,
                          (uint8_t)body, (uint8_t)(body >> 8),
                          (uint8_t)(body >> 16)};
        uint8_t crcb[4] = {(uint8_t)masked, (uint8_t)(masked >> 8),
                           (uint8_t)(masked >> 16), (uint8_t)(masked >> 24)};
        fwrite(hdr, 1, 4, f);
        fwrite(crcb, 1, 4, f);
        fwrite(use_comp ? comp.data() : chunk, 1, body - 4, f);
    }
    if (fclose(f) != 0) return -1;
    return 0;
}

// one FASTA file -> flat record batch with 0x00 separators, exactly as
// io/fastx.py read_fastx + build_batch produce it (headers dropped,
// '\n'/'\r' stripped, one separator byte between records). false =
// not plain FASTA (gz, FASTQ, empty) — caller falls back to python.

}  // namespace

extern "C" {

long long ska_host_save(const char* path, const uint64_t* keys,
                        long long n, int W, const uint8_t* variants,
                        long long S, const uint64_t* counts,
                        const uint8_t* names_blob, long long names_len,
                        long long n_names, int k, int rc,
                        const uint8_t* version, long long version_len) {
    try {
        return save_impl(path, keys, n, W, variants, S, counts,
                         split_blob(names_blob, names_len, n_names), k, rc,
                         version, version_len);
    } catch (...) {
        return -3;
    }
}


}  // extern "C"
