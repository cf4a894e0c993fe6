"""Python-int k-mer helpers for skalo (2-bit codes A=0 C=1 T=2 G=3); the
port's copy of what the C++ route of ska_tpu/skalo/kmer_utils.py uses.
The degenerate-base table and the numpy bulk helpers there serve only
the JAX package's pure-Python graph, which the port does not have."""

import numpy as np

_DECODE = "ACTG"
_DECB = np.frombuffer(b"ACTG", dtype=np.uint8)


def encode_str(s: str) -> int:
    v = 0
    for c in s:
        v = (v << 2) | ((ord(c) >> 1) & 3)
    return v


def decode_int(v: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append(_DECODE[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def rev_comp_int(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((v & 3) ^ 2)
        v >>= 2
    return out


def popcount(mask: int) -> int:
    return bin(mask).count("1")


class LazySeq:
    """A bubble path's DNA string, materialized on demand.

    A path sequence = decode(entry k-mer) + last base of each later node
    (read_graph.rs:197-213). Most variant groups only ever read small
    windows of it, so the full string (often kilobases, hundreds of
    thousands of paths) is built only when needed. The tail is kept as
    2-bit codes (1 byte per node).
    """

    __slots__ = ("head", "_tail", "_parts", "_n", "_s")

    def __init__(self, head: str, parts, n: int):
        """parts: a zero-arg callable (core._SegParts) returning the code
        arrays of all n nodes; the first element is dropped when the tail
        materializes."""
        self.head = head
        self._tail = None
        self._parts = parts
        self._n = n
        self._s = None

    @property
    def tail(self):
        if self._tail is None:
            self._tail = np.concatenate(self._parts())[1:]
            self._parts = None
        return self._tail

    def __len__(self):
        return len(self.head) + self._n - 1

    def __str__(self):
        if self._s is None:
            self._s = self.head + _DECB[self.tail].tobytes().decode()
        return self._s

    def __getitem__(self, i):
        if self._s is not None:
            return self._s[i]
        kg = len(self.head)
        n = kg + len(self.tail)
        if isinstance(i, slice):
            a, b, step = i.indices(n)
            if step != 1:
                return str(self)[i]
            if b <= kg:
                return self.head[a:b]
            if a >= kg:
                return _DECB[self.tail[a - kg : b - kg]].tobytes().decode()
            return self.head[a:] + _DECB[self.tail[: b - kg]].tobytes().decode()
        if i < 0:
            i += n
        if i < kg:
            return self.head[i]
        return _DECODE[self.tail[i - kg]]
