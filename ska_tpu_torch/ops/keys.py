"""Packed split k-mer key limbs as torch tensors (port of ska_tpu/ops/keys.py).

A key array is a (..., W) tensor with W = 1 (k <= 31) or 2 (hi, lo limbs,
k <= 63), as in the JAX package. torch cannot shift, compare, cummax or
index_put_ on torch.uint64, so every limb is an int64 tensor that carries
the raw uint64 bits. Two consequences shape every function here:

- ``>>`` on int64 sign-extends, so each right shift masks its result
  (``_lsr``); a missing mask shows only on limbs with the top bit set;
- unsigned order is taken on ``x ^ SIGN`` (the top bit flipped), without
  which the all-ones sentinel would sort first instead of last.
"""

import numpy as np
import torch

from . import lookup

SIGN = -(1 << 63)  # int64 with only the top bit set
MASK64 = (1 << 64) - 1


def to_i64(v: int) -> int:
    """The int64 value whose bits are the uint64 value ``v``."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def _lsr(x, s: int):
    """Logical right shift of int64 limbs by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def shl(limbs, s: int):
    """Static left shift of (..., W) limbs, limbs[..., 0] is hi."""
    W = limbs.shape[-1]
    if s == 0:
        return limbs
    if W == 1:
        return (limbs << s) if s < 64 else torch.zeros_like(limbs)
    hi, lo = limbs[..., 0], limbs[..., 1]
    if s < 64:
        nhi = (hi << s) | _lsr(lo, 64 - s)
        nlo = lo << s
    elif s < 128:
        nhi = lo << (s - 64) if s > 64 else lo
        nlo = torch.zeros_like(lo)
    else:
        nhi = nlo = torch.zeros_like(lo)
    return torch.stack([nhi, nlo], dim=-1)


def shr(limbs, s: int):
    """Static logical right shift of (..., W) limbs."""
    W = limbs.shape[-1]
    if s == 0:
        return limbs
    if W == 1:
        return _lsr(limbs, s) if s < 64 else torch.zeros_like(limbs)
    hi, lo = limbs[..., 0], limbs[..., 1]
    if s < 64:
        nlo = _lsr(lo, s) | (hi << (64 - s))
        nhi = _lsr(hi, s)
    elif s < 128:
        nlo = _lsr(hi, s - 64) if s > 64 else hi
        nhi = torch.zeros_like(hi)
    else:
        nhi = nlo = torch.zeros_like(hi)
    return torch.stack([nhi, nlo], dim=-1)


def from_scalar(x: int, W: int, device=None):
    """Broadcastable (W,) key from a python int."""
    limbs = [x] if W == 1 else [x >> 64, x]
    return torch.tensor([to_i64(v) for v in limbs], dtype=torch.int64,
                        device=device)


_M2 = to_i64(0x3333333333333333)
_M4 = to_i64(0x0F0F0F0F0F0F0F0F)
_M8 = to_i64(0x00FF00FF00FF00FF)
_M16 = to_i64(0x0000FFFF0000FFFF)
_COMP = to_i64(0xAAAAAAAAAAAAAAAA)


def _rev64(x):
    """Reverse the 32 2-bit groups within each 64-bit limb (reference
    rev_comp shuffle, bit_encoding.rs:182-195). The masks applied after
    each ``>>`` have their top bits clear, so they also undo the sign
    extension; the last step masks explicitly."""
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    return _lsr(x, 32) | (x << 32)


def rev_comp(limbs, n_bases: int):
    """Reverse complement of 2-bit packed bases (W limbs), value in the
    low 2*n_bases bits."""
    W = limbs.shape[-1]
    if W == 1:
        return shr(_rev64(limbs) ^ _COMP, 64 - 2 * n_bases)
    hi, lo = limbs[..., 0], limbs[..., 1]
    r = torch.stack([_rev64(lo) ^ _COMP, _rev64(hi) ^ _COMP], dim=-1)
    return shr(r, 128 - 2 * n_bases)


def greater(a, b):
    """Lexicographic a > b over limbs, unsigned."""
    a, b = a ^ SIGN, b ^ SIGN
    gt = a[..., 0] > b[..., 0]
    if a.shape[-1] == 1:
        return gt
    return gt | ((a[..., 0] == b[..., 0]) & (a[..., 1] > b[..., 1]))


def equal(a, b):
    return (a == b).all(dim=-1)


def sort_with(keys, payloads, extra_keys=()):
    """Sort rows by key limbs (then extra_keys) carrying payloads.

    keys: (N, W); extra_keys and payloads: tuples of (N,) tensors.
    Returns (sorted_keys, sorted_extras, sorted_payloads), as the JAX
    package's. On a card the operands must be a layout the radix kernel
    takes: W limbs, then an int32 and a uint8 (an extra key or
    payloads).

    The JAX package's lax_sort_fast sorts by the first key alone and
    re-sorts with the full comparator under a lax.cond only when a tie
    hides an order: a TPU cost trick, because there the comparator's
    keys, not the data moved, set the price. The radix sort compares all
    keys in one go (one pass per digit that varies), so the port has no
    such layer and calls sort_ops itself."""
    from .sort import sort_ops

    W = keys.shape[-1]
    ops = (tuple(keys[:, i].contiguous() for i in range(W))
           + tuple(extra_keys) + tuple(payloads))
    res = sort_ops(ops, num_keys=W + len(extra_keys))
    nex = len(extra_keys)
    return torch.stack(res[:W], dim=-1), res[W : W + nex], res[W + nex :]


def lower_bound(sorted_keys, queries):
    """Lower bound of (M, W) queries in (N, W) keys sorted unsigned
    lexicographically (first limb most significant): int64 answers in
    [0, N], np.searchsorted(side="left"). The port's lookup, counterpart
    of ska_tpu/ops/keys.py::searchsorted_via_sort, which sorts [queries;
    table] because gathers are the TPU's weak spot; a card does the
    search itself.

    Tensors on the CPU take the plain version, ``searchsorted``; CUDA
    tensors launch the hand-written kernel (csrc/lower_bound.cu through
    ops/lookup.py), which raises on operands it does not take."""
    if sorted_keys.is_cpu and queries.is_cpu:
        return searchsorted(sorted_keys, queries)
    return lookup.lower_bound(sorted_keys, queries)


def searchsorted(sorted_keys, queries):
    """Branchless lower-bound binary search of (M, W) queries in (N, W)
    sorted keys: int64 indices in [0, N], O(M log N) gathers. The plain
    version of lower_bound's kernel."""
    N = sorted_keys.shape[0]
    M = queries.shape[0]
    lo = torch.zeros(M, dtype=torch.int64, device=queries.device)
    if N == 0:
        return lo
    hi = torch.full_like(lo, N)
    for _ in range(max(1, int(np.ceil(np.log2(N + 1)))) + 1):
        mid = (lo + hi) >> 1
        # lower bound: key[mid] < query -> go right
        lt = greater(queries, sorted_keys[mid.clamp(0, N - 1)])
        live = lo < hi
        lo = torch.where(lt & live, mid + 1, lo)
        hi = torch.where(~lt & live, mid, hi)
    return lo


def from_numpy_keys(keys: np.ndarray, device=None):
    """(n, W) uint64 numpy keys -> int64 tensor with the same bits (a
    zero-copy view when it stays on the CPU)."""
    arr = np.ascontiguousarray(keys, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(arr).to(device)


def to_numpy_keys(limbs) -> np.ndarray:
    """int64 limb tensor -> uint64 numpy array with the same bits."""
    return limbs.detach().cpu().numpy().view(np.uint64)
