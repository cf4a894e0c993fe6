"""A reader of `.skf` files for judging the program's output, apart from
the program's own loader.

An `.skf` is ska.rust's MergeSkaArray serialised by serde into CBOR
(RFC 8949) and framed by snappy (merge_ska_array.rs:191-204): a map of
``k``, ``rc``, ``names``, ``split_kmers`` (u64 keys, or bignums above
u64), ``variants`` ({"v", "dim": [rows, samples], "data": row-major
ASCII}), ``variant_count``, ``ska_version`` and ``k_bits``. The snappy
frame is undone by unframe.cpp, built by g++ at first use into
``build/skabench/`` at the root of the checkout; the CBOR is read here,
long arrays of one encoding width at a time with numpy.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unframe.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "skabench")
_lib = None


def _unframer():
    """The unframer's library, compiled unless it is newer than its
    source; a concurrent build writes its own file and renames it."""
    global _lib
    if _lib is None:
        so = os.path.join(BUILD_DIR, "libunframe.so")
        if not (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(_SRC)):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the .skf reader cannot be built")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o",
                            tmp, _SRC], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.skb_unframe.restype = ctypes.c_int64
        lib.skb_unframe.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
    return _lib


def unframe(raw: bytes) -> np.ndarray:
    """The bytes a snappy frame holds; raises ValueError on a malformed
    frame or a checksum mismatch."""
    if raw[:10] != b"\xff\x06\x00\x00sNaPpY":
        raise ValueError("not a snappy framed stream")
    lib = _unframer()
    n = lib.skb_unframe(raw, len(raw), None, 0)
    if n < 0:
        raise ValueError("malformed snappy frame")
    out = np.empty(n, np.uint8)
    got = lib.skb_unframe(raw, len(raw), out.ctypes.data, n)
    if got != n:
        raise ValueError({-2: "snappy chunk checksum mismatch"}.get(
            got, "malformed snappy frame"))
    return out


class _Cbor:
    def __init__(self, buf: np.ndarray):
        self.a = buf
        self.b = buf.tobytes() if len(buf) < (1 << 16) else memoryview(buf)
        self.pos = 0

    def _uint(self, info):
        p = self.pos
        if info < 24:
            return info
        width = {24: 1, 25: 2, 26: 4, 27: 8}.get(info)
        if width is None:
            raise ValueError(f"CBOR: additional info {info} not read here")
        self.pos = p + width
        return int.from_bytes(self.b[p : p + width], "big")

    def item(self):
        ib = self.a[self.pos]
        self.pos += 1
        major, info = int(ib) >> 5, int(ib) & 31
        if major == 0:
            return self._uint(info)
        if major in (2, 3):
            n = self._uint(info)
            raw = bytes(self.b[self.pos : self.pos + n])
            self.pos += n
            return raw if major == 2 else raw.decode()
        if major == 4:
            return self.array(self._uint(info))
        if major == 5:
            n = self._uint(info)
            return {self.item(): self.item() for _ in range(n)}
        if major == 6:
            tag, val = self._uint(info), self.item()
            if tag != 2:
                raise ValueError(f"CBOR: tag {tag} not read here")
            return int.from_bytes(val, "big")
        if major == 7 and info in (20, 21, 22):
            return (False, True, None)[info - 20]
        raise ValueError(f"CBOR: major type {major} not read here")

    def array(self, n: int):
        """A list, or for a long array of unsigned integers a numpy
        array (uint8 when every value fits a byte): each run of one
        encoded width (sorted keys start with their short ones) is read
        at once, the rest item by item."""
        if n < 64:
            return [self.item() for _ in range(n)]
        out = None
        i = 0
        tried = set()
        while i < n:
            p = self.pos
            head = int(self.a[p])
            width = {24: 2, 25: 3, 26: 5, 27: 9}.get(head, 1 if head < 24 else 0)
            run = self.a[p : p + width * (n - i)]
            if width and head not in tried and len(run) == width * (n - i):
                rows = run.reshape(-1, width)
                if (rows[:, 0] < 24).all() if width == 1 else (rows[:, 0] == head).all():
                    self.pos = p + width * (n - i)
                    if i == 0 and width <= 2:
                        return rows[:, -1].copy()
                    if out is None:
                        out = np.empty(n, np.uint64)
                    if width == 1:
                        out[i:] = rows[:, 0]
                    else:
                        be = np.zeros((n - i, 8), np.uint8)
                        be[:, 9 - width :] = rows[:, 1:]
                        out[i:] = be.view(">u8")[:, 0]
                    return out
                tried.add(head)
            v = self.item()
            if not isinstance(v, int) or v >= 1 << 64:
                done = [] if out is None else [int(x) for x in out[:i]]
                return done + [v] + [self.item() for _ in range(n - i - 1)]
            if out is None:
                out = np.empty(n, np.uint64)
            out[i] = v
            i += 1
        return out


def read(path: str) -> dict:
    """k, rc, names, keys ((rows, W) uint64, high limb first), variants
    ((rows, samples) uint8) and counts of an `.skf` file."""
    with open(path, "rb") as f:
        raw = f.read()
    r = _Cbor(unframe(raw))
    obj = r.item()
    if r.pos != len(r.a):
        raise ValueError("trailing bytes after the CBOR map")
    W = max(1, int(obj.get("k_bits", 64)) // 64)
    sk = obj["split_kmers"]
    if isinstance(sk, np.ndarray):
        keys = np.zeros((len(sk), W), np.uint64)
        keys[:, W - 1] = sk
    else:
        keys = np.array([[(int(v) >> (64 * (W - 1 - w))) & (2**64 - 1)
                          for w in range(W)] for v in sk],
                        np.uint64).reshape(-1, W)
    v = obj["variants"]
    rows, cols = v["dim"]
    data = np.asarray(v["data"])
    if len(data) != rows * cols or (data.dtype != np.uint8 and (data > 255).any()):
        raise ValueError("variants: not a (rows, samples) matrix of bytes")
    variants = data.astype(np.uint8).reshape(rows, cols)
    return {"k": obj["k"], "rc": obj["rc"], "names": list(obj["names"]),
            "keys": keys, "variants": variants,
            "counts": np.asarray(obj["variant_count"], np.int64)}

