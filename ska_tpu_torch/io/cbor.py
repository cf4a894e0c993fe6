"""Minimal CBOR (RFC 8949) decoder for `.skf` loads (the port's copy of
the reading half of ska_tpu/io/cbor.py).

Only the subset the reference writes with ciborium
(merge_ska_array.rs:191-204) is read: definite-length maps/arrays, text
keys, unsigned integers, booleans, and positive bignums (tag 2), which
ciborium uses for u128 split k-mer keys above u64. Long uint arrays
decode in bulk through the host library. The writing half is
csrc/host/save.cpp.
"""

import struct

import numpy as np

from . import native

_FAST_DECODE_MIN = 64  # bulk-decode arrays at least this long


class UIntArray:
    """Bulk-decoded CBOR array of unsigned ints, as (hi, lo) uint64 limbs.

    hi is materialized lazily: the bulk decoder returns None for it when
    every value fit u64, and the zeros appear only if a consumer asks
    for the high limbs."""

    __slots__ = ("_hi", "lo")

    def __init__(self, hi, lo):
        self._hi = hi
        self.lo = lo

    @property
    def hi(self):
        if self._hi is None:
            self._hi = np.zeros_like(self.lo)
        return self._hi

    def __len__(self):
        return len(self.lo)

    def tolist(self):
        if self._hi is None or not self._hi.any():
            return self.lo.tolist()
        return [(int(h) << 64) | int(l) for h, l in zip(self._hi, self.lo)]


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("CBOR: truncated input")
        self.pos += n
        return b

    def byte(self):
        b = self.buf[self.pos]
        self.pos += 1
        return b


class Tagged:
    """A CBOR tagged value (tag 2 = positive bignum is decoded inline)."""

    __slots__ = ("tag", "value")

    def __init__(self, tag, value):
        self.tag = tag
        self.value = value


def _read_uint(r, info):
    if info < 24:
        return info
    if info == 24:
        return r.byte()
    if info == 25:
        return struct.unpack(">H", r.take(2))[0]
    if info == 26:
        return struct.unpack(">I", r.take(4))[0]
    if info == 27:
        return struct.unpack(">Q", r.take(8))[0]
    raise ValueError(f"CBOR: unsupported additional info {info}")


def _decode(r):
    ib = r.byte()
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _read_uint(r, info)
    if major == 1:
        return -1 - _read_uint(r, info)
    if major == 2:
        return bytes(r.take(_read_uint(r, info)))
    if major == 3:
        return bytes(r.take(_read_uint(r, info))).decode("utf-8")
    if major == 4:
        n = _read_uint(r, info)
        if n >= _FAST_DECODE_MIN:
            # byte-narrow first: arrays whose values all fit u8 (the big
            # variant matrix) decode straight to uint8. A failed attempt
            # stops at the first wide value and the u64 path redoes it;
            # peeking the first head byte skips the attempt for key-sized
            # arrays.
            if r.buf[r.pos] <= 0x18:
                cnt8, consumed8, out8 = native.cbor_decode_u8(r.buf, r.pos, n)
                if cnt8 == n:
                    r.pos += consumed8
                    return UIntArray(None, out8)
            cnt, consumed, hi, lo = native.cbor_decode_uints(r.buf, r.pos, n)
            if cnt == n:
                r.pos += consumed
                return UIntArray(hi, lo)
            if cnt:  # mixed content: bulk prefix + element-wise tail
                r.pos += consumed
                head = UIntArray(hi, lo).tolist()
                return head + [_decode(r) for _ in range(n - cnt)]
        return [_decode(r) for _ in range(n)]
    if major == 5:
        n = _read_uint(r, info)
        return {_decode(r): _decode(r) for _ in range(n)}
    if major == 6:
        tag = _read_uint(r, info)
        val = _decode(r)
        if tag == 2:  # positive bignum
            return int.from_bytes(val, "big")
        if tag == 3:  # negative bignum
            return -1 - int.from_bytes(val, "big")
        return Tagged(tag, val)
    if major == 7:
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 26:
            return struct.unpack(">f", r.take(4))[0]
        if info == 27:
            return struct.unpack(">d", r.take(8))[0]
        raise ValueError(f"CBOR: unsupported simple value {info}")
    raise ValueError("CBOR: unreachable")


def loads(buf):
    return _decode(_Reader(memoryview(buf)))
