// Snappy framing-format decoder for reading .skf files, written from
// google/snappy's framing_format.txt and format_description.txt. Every
// compressed or uncompressed chunk's masked CRC-32C is checked.
// Plain C ABI for ctypes; built by skabench/reference/skf.py.

#include <cstdint>
#include <cstring>

namespace {

uint32_t crc_table[256];
bool crc_ready = false;

void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int j = 0; j < 8; j++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        crc_table[i] = c;
    }
    crc_ready = true;
}

uint32_t masked_crc(const uint8_t* p, int64_t n) {
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    c ^= 0xFFFFFFFFu;
    return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

uint32_t le(const uint8_t* p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v |= (uint32_t)p[i] << (8 * i);
    return v;
}

// the uncompressed length that opens a snappy block, or -1
int64_t varint(const uint8_t* p, int64_t n) {
    int64_t v = 0;
    for (int64_t i = 0, shift = 0; i < n && shift <= 35; i++, shift += 7) {
        v |= (int64_t)(p[i] & 0x7F) << shift;
        if (!(p[i] & 0x80)) return v;
    }
    return -1;
}

// one snappy block into out[0, cap); returns its length or -1
int64_t block(const uint8_t* p, int64_t n, uint8_t* out, int64_t cap) {
    int64_t i = 0, want = varint(p, n);
    if (want < 0 || want > cap) return -1;
    while (i < n && (p[i] & 0x80)) i++;
    i++;
    int64_t o = 0;
    while (i < n) {
        uint8_t tag = p[i++];
        int64_t len, off;
        if ((tag & 3) == 0) {
            len = tag >> 2;
            if (len >= 60) {
                int extra = (int)len - 59;
                if (i + extra > n) return -1;
                len = le(p + i, extra);
                i += extra;
            }
            len += 1;
            if (i + len > n || o + len > want) return -1;
            memcpy(out + o, p + i, len);
            i += len;
            o += len;
            continue;
        }
        if ((tag & 3) == 1) {
            if (i + 1 > n) return -1;
            len = ((tag >> 2) & 7) + 4;
            off = ((int64_t)(tag >> 5) << 8) | p[i];
            i += 1;
        } else if ((tag & 3) == 2) {
            if (i + 2 > n) return -1;
            len = (tag >> 2) + 1;
            off = le(p + i, 2);
            i += 2;
        } else {
            if (i + 4 > n) return -1;
            len = (tag >> 2) + 1;
            off = le(p + i, 4);
            i += 4;
        }
        if (off == 0 || off > o || o + len > want) return -1;
        for (int64_t j = 0; j < len; j++) out[o + j] = out[o + j - off];
        o += len;
    }
    return o == want ? o : -1;
}

}  // namespace

extern "C" {

// Decodes a framed stream into out, or with out null only sums the
// chunks' stated lengths. Returns the decoded length, -1 for a malformed stream, -2 for a
// checksum mismatch, -3 when cap is too small.
int64_t skb_unframe(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    if (!crc_ready) crc_init();
    int64_t i = 0, o = 0;
    while (i < n) {
        if (i + 4 > n) return -1;
        uint8_t type = in[i];
        int64_t len = le(in + i + 1, 3);
        i += 4;
        if (i + len > n) return -1;
        const uint8_t* body = in + i;
        i += len;
        if (type == 0xFF || type == 0xFE || (type >= 0x80 && type <= 0xFD)) continue;
        if (type > 0x01 || len < 4) return -1;
        uint32_t crc = le(body, 4);
        int64_t got;
        if (!out) {  // sizing: the chunk's stated length alone
            got = type == 0x01 ? len - 4 : varint(body + 4, len - 4);
            if (got < 0) return -1;
            o += got;
            continue;
        }
        if (type == 0x01) {
            got = len - 4;
            if (got > cap - o) return -3;
            memcpy(out + o, body + 4, got);
        } else {
            int64_t want = varint(body + 4, len - 4);
            if (want < 0) return -1;
            if (want > cap - o) return -3;
            got = block(body + 4, len - 4, out + o, want);
            if (got < 0) return -1;
        }
        uint8_t* dst = out + o;
        if (masked_crc(dst, got) != crc) return -2;
        o += got;
    }
    return o;
}

}  // extern "C"
