// The .skf writer behind ska_tpu_torch/io/skf.py save: the CBOR encode
// and the snappy framing of save_impl and ska_host_save in the JAX
// package's csrc/host_modes.cpp, run in parallel on the host pool
// (host_pool.h, SKA_THREADS threads). Its bytes equal those of the JAX
// package's serial writer for the same array, whatever the thread count:
// every block of the encode is written at the offset a size pass gave
// it, and the 64 KiB framing chunks are compressed independently (the
// compressor clears its table on every call) and written in order.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <utility>
#include <vector>

#include "host_pool.h"

extern "C" {
long long ska_cbor_encode_uints(const uint64_t* v, long long n, uint8_t* out);
long long ska_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                              size_t out_cap);
uint32_t ska_crc32c(const uint8_t* data, size_t n);
}


namespace {

const size_t CH = 65536;            // framing chunk (ska_tpu/io/snappy.py frame_compress)
const size_t ROUND_CHUNKS = 512;    // chunks compressed a round: 32 MiB of CBOR
const size_t BLOCK = 1 << 16;       // keys or counts encoded per block
const size_t CELL_BLOCK = 1 << 18;  // variant cells encoded per block
// one framed chunk at most: type and length, masked CRC, and snappy's
// MaxCompressedLength of a full chunk
const size_t SLOT = 8 + 32 + CH + CH / 6;

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

// bytes of a minimal-width CBOR head of value v
static inline size_t head_len(uint64_t v) {
    return v < 24 ? 1 : v < 0x100 ? 2 : v < 0x10000 ? 3
         : v < 0x100000000ULL ? 5 : 9;
}

// big-endian bytes of a tag-2 bignum with a nonzero hi limb
static inline int bignum_len(uint64_t hi) {
    return (64 + (64 - __builtin_clzll(hi)) + 7) / 8;
}

// One piece of the CBOR text: the small fields between the bulk arrays
// as literal bytes, or a block [begin, end) of one bulk array.
enum Kind { LITERAL, KEYS64, KEYS128, CELLS, COUNTS };
struct Piece {
    Kind kind;
    size_t begin, end;
    const std::vector<uint8_t>* lit;
};

struct Array {
    const uint64_t* keys;
    const uint8_t* variants;
    const uint64_t* counts;
};

// bytes of a piece's encoding; *wide counts the keys of a KEYS128 piece
// written as bignums
static size_t piece_size(const Piece& p, const Array& a, size_t* wide) {
    size_t s = 0;
    switch (p.kind) {
    case LITERAL:
        return p.lit->size();
    case KEYS64:
        for (size_t i = p.begin; i < p.end; i++) s += head_len(a.keys[i]);
        return s;
    case KEYS128:
        // ciborium u128s: plain uint when hi == 0, else tag-2 positive
        // bignum (tag, byte-string head, bytes) (io/cbor.py U128s)
        for (size_t i = p.begin; i < p.end; i++) {
            uint64_t hi = a.keys[2 * i];
            s += hi == 0 ? head_len(a.keys[2 * i + 1]) : 2 + bignum_len(hi);
            *wide += hi != 0;
        }
        return s;
    case CELLS:
        for (size_t i = p.begin; i < p.end; i++) s += a.variants[i] < 24 ? 1 : 2;
        return s;
    case COUNTS:
        for (size_t i = p.begin; i < p.end; i++) s += head_len(a.counts[i]);
        return s;
    }
    return 0;
}

static void put_uint(uint8_t*& o, uint64_t v) {
    if (v < 24) {
        *o++ = (uint8_t)v;
        return;
    }
    int nb = v < 0x100 ? 1 : v < 0x10000 ? 2 : v < 0x100000000ULL ? 4 : 8;
    *o++ = (uint8_t)(nb == 1 ? 24 : nb == 2 ? 25 : nb == 4 ? 26 : 27);
    for (int i = nb - 1; i >= 0; i--) *o++ = (uint8_t)(v >> (8 * i));
}

static void encode_piece(const Piece& p, const Array& a, uint8_t* o) {
    switch (p.kind) {
    case LITERAL:
        memcpy(o, p.lit->data(), p.lit->size());
        return;
    case KEYS64:
        ska_cbor_encode_uints(a.keys + p.begin, (long long)(p.end - p.begin), o);
        return;
    case KEYS128:
        for (size_t i = p.begin; i < p.end; i++) {
            uint64_t hi = a.keys[2 * i], lo = a.keys[2 * i + 1];
            if (hi == 0) {
                put_uint(o, lo);
                continue;
            }
            int nbytes = bignum_len(hi);
            *o++ = 0xC2;
            *o++ = (uint8_t)(0x40 | nbytes);  // byte string, nbytes < 24
            for (int b = nbytes - 1; b >= 0; b--) {
                uint64_t limb = b >= 8 ? hi : lo;
                *o++ = (uint8_t)(limb >> (8 * (b & 7)));
            }
        }
        return;
    case CELLS:
        for (size_t i = p.begin; i < p.end; i++) {
            uint8_t c = a.variants[i];
            if (c >= 24) *o++ = 0x18;
            *o++ = c;
        }
        return;
    case COUNTS:
        ska_cbor_encode_uints(a.counts + p.begin, (long long)(p.end - p.begin), o);
        return;
    }
}

// the small fields, encoded as CBOR literal bytes
struct Lit {
    std::vector<uint8_t> b;
    void head(int major, uint64_t v) {
        uint8_t tmp[9];
        uint8_t* o = tmp;
        put_uint(o, v);
        tmp[0] |= (uint8_t)(major << 5);
        b.insert(b.end(), tmp, o);
    }
    void text(const char* s, size_t ln) {
        head(3, ln);
        b.insert(b.end(), (const uint8_t*)s, (const uint8_t*)s + ln);
    }
};

static void add_blocks(std::vector<Piece>& pieces, Kind kind, size_t n,
                       size_t block) {
    for (size_t b = 0; b < n; b += block)
        pieces.push_back({kind, b, b + block < n ? b + block : n, nullptr});
}

// `.skf` save: the full CBOR encode + snappy framing, byte-identical to
// the JAX package's writer (ska_tpu/io/skf.py save; reference
// merge_ska_array.rs:191-204). Field order, minimal-width heads,
// ciborium bignums and the 64 KiB framing chunks all match —
// tests/test_torch_host.py pins equality. 0 ok, nonzero = not written
// (io/native.py raises). stats[0] gets the framing chunks, stats[1] the
// threads used, stats[2] the keys written as tag-2 bignums.
static long long save_impl(
    const char* path, const uint64_t* keys, long long n, int W,
    const uint8_t* variants, long long S, const uint64_t* counts,
    const std::vector<std::pair<const char*, size_t>>& names, int k,
    int rc, const uint8_t* version, long long version_len,
    long long* stats) {
    if (W != 1 && W != 2) return -1;
    const Array arr{keys, variants, counts};

    // the small fields, in io/skf.py save()'s insertion order
    Lit lit[4];
    lit[0].head(5, 8);
    lit[0].text("k", 1); lit[0].head(0, (uint64_t)k);
    lit[0].text("rc", 2); lit[0].b.push_back(rc ? 0xF5 : 0xF4);
    lit[0].text("names", 5);
    lit[0].head(4, (uint64_t)names.size());
    for (const auto& nm : names) lit[0].text(nm.first, nm.second);
    lit[0].text("split_kmers", 11);
    lit[0].head(4, (uint64_t)n);
    lit[1].text("variants", 8);
    lit[1].head(5, 3);
    lit[1].text("v", 1); lit[1].head(0, 1);
    lit[1].text("dim", 3);
    lit[1].head(4, 2); lit[1].head(0, (uint64_t)n); lit[1].head(0, (uint64_t)S);
    lit[1].text("data", 4);
    lit[1].head(4, (uint64_t)(n * S));
    lit[2].text("variant_count", 13);
    lit[2].head(4, (uint64_t)n);
    lit[3].text("ska_version", 11);
    lit[3].text((const char*)version, (size_t)version_len);
    lit[3].text("k_bits", 6); lit[3].head(0, W == 1 ? 64u : 128u);

    std::vector<Piece> pieces;
    pieces.push_back({LITERAL, 0, 0, &lit[0].b});
    add_blocks(pieces, W == 1 ? KEYS64 : KEYS128, (size_t)n, BLOCK);
    pieces.push_back({LITERAL, 0, 0, &lit[1].b});
    add_blocks(pieces, CELLS, (size_t)(n * S), CELL_BLOCK);
    pieces.push_back({LITERAL, 0, 0, &lit[2].b});
    add_blocks(pieces, COUNTS, (size_t)n, BLOCK);
    pieces.push_back({LITERAL, 0, 0, &lit[3].b});

    // a pass of sizes, offsets by a prefix sum, then every piece encoded
    // in its place; the buffer is not zero-filled, so its pages are first
    // touched by the threads that write them. The sizes are not known
    // yet, so the encode's threads are bounded by the chunks of the
    // largest encoding: a payload that fits one chunk is encoded on the
    // calling thread.
    const int T0 = env_threads();
    size_t most = (size_t)n * (W == 1 ? 9 : 18) + (size_t)(n * S) * 2 +
                  (size_t)n * 9;
    for (const Lit& l : lit) most += l.b.size();
    const size_t most_chunks = (most + CH - 1) / CH;
    const int TE = (int)(most_chunks < (size_t)T0 ? most_chunks : (size_t)T0);
    std::vector<size_t> off(pieces.size() + 1, 0), wide(pieces.size(), 0);
    pool_for_each(pieces.size(), TE, [] { return 0; }, [&](int&, size_t i) {
        off[i + 1] = piece_size(pieces[i], arr, &wide[i]);
    });
    size_t wide_keys = 0;
    for (size_t i = 0; i < pieces.size(); i++) {
        off[i + 1] += off[i];
        wide_keys += wide[i];
    }
    const size_t total = off.back();
    std::unique_ptr<uint8_t[]> buf(new uint8_t[total]);
    pool_for_each(pieces.size(), TE, [] { return 0; },
                  [&](int&, size_t i) {
                      encode_piece(pieces[i], arr, buf.get() + off[i]);
                  });

    // snappy framing, 64 KiB chunks, compressed a round at a time into
    // one slot each of the round's buffer, two buffers in turn. The pool
    // that compresses a round also writes the round before it, as one
    // more item, and the last round is written after them: the file
    // holds the chunks in order, and the write overlaps the compression.
    const size_t chunks = (total + CH - 1) / CH;
    const int T = (int)(chunks < (size_t)T0 ? chunks : (size_t)T0);
    const size_t round = chunks < ROUND_CHUNKS ? chunks : ROUND_CHUNKS;
    const size_t rounds = (chunks + round - 1) / round;
    const size_t nbuf = rounds > 1 ? 2 : 1;
    std::unique_ptr<uint8_t[]> slots(new uint8_t[nbuf * round * SLOT]);
    std::vector<size_t> framed(nbuf * round);
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    static const uint8_t MAGIC[10] = {0xFF, 0x06, 0x00, 0x00,
                                      's',  'N',  'a',  'P', 'p', 'Y'};
    bool ok = fwrite(MAGIC, 1, 10, f) == 10;
    auto chunks_of = [&](size_t r) {
        return chunks - r * round < round ? chunks - r * round : round;
    };
    auto write_round = [&](size_t r) {
        const size_t b = (r % 2) * round;
        for (size_t i = b; ok && i < b + chunks_of(r); i++)
            ok = fwrite(slots.get() + i * SLOT, 1, framed[i], f) == framed[i];
    };
    for (size_t r = 0; ok && r < rounds; r++) {
        const size_t w = r > 0 ? 1 : 0;  // item 0 writes round r - 1
        const size_t items = w + chunks_of(r);
        auto item = [&](int&, size_t i) {
            if (i < w) {
                write_round(r - 1);
                return;
            }
            size_t pos = (r * round + i - w) * CH;
            size_t ln = total - pos < CH ? total - pos : CH;
            const uint8_t* chunk = buf.get() + pos;
            const size_t j = (r % 2) * round + i - w;
            uint8_t* slot = slots.get() + j * SLOT;
            uint32_t crc = ska_crc32c(chunk, ln);
            uint32_t masked = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
            long long cl = ska_snappy_compress(chunk, ln, slot + 8, SLOT - 8);
            bool use_comp = cl > 0 && (size_t)cl < ln;
            if (!use_comp) memcpy(slot + 8, chunk, ln);
            size_t body = 4 + (use_comp ? (size_t)cl : ln);
            slot[0] = use_comp ? 0x00 : 0x01;
            slot[1] = (uint8_t)body;
            slot[2] = (uint8_t)(body >> 8);
            slot[3] = (uint8_t)(body >> 16);
            for (int b = 0; b < 4; b++) slot[4 + b] = (uint8_t)(masked >> (8 * b));
            framed[j] = 4 + body;
        };
        pool_for_each(items, (int)(items < (size_t)T ? items : (size_t)T),
                      [] { return 0; }, item);
    }
    if (ok) write_round(rounds - 1);
    if (fclose(f) != 0 || !ok) return -1;
    stats[0] = (long long)chunks;
    stats[1] = T;
    stats[2] = (long long)wide_keys;
    return 0;
}

}  // namespace

extern "C" {

long long ska_host_save(const char* path, const uint64_t* keys,
                        long long n, int W, const uint8_t* variants,
                        long long S, const uint64_t* counts,
                        const uint8_t* names_blob, long long names_len,
                        long long n_names, int k, int rc,
                        const uint8_t* version, long long version_len,
                        long long* stats) {
    try {
        return save_impl(path, keys, n, W, variants, S, counts,
                         split_blob(names_blob, names_len, n_names), k, rc,
                         version, version_len, stats);
    } catch (...) {
        return -3;
    }
}


}  // extern "C"
