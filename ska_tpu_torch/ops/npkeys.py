"""Numpy-only packed-key helpers for (N, W) uint64 key limbs on the host
(the port's copy of what it uses of ska_tpu/ops/npkeys.py)."""

import numpy as np


def width_for_k(k: int) -> int:
    """Limb count for split k-mer keys: 2*(k-1) bits."""
    return 1 if k <= 31 else 2


def from_python_ints(vals, W) -> np.ndarray:
    """Python ints -> (N, W) numpy uint64 limbs (hi, lo)."""
    n = len(vals)
    out = np.zeros((n, W), dtype=np.uint64)
    if W == 1:
        for i, v in enumerate(vals):
            out[i, 0] = v
    else:
        for i, v in enumerate(vals):
            out[i, 0] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
            out[i, 1] = v & 0xFFFFFFFFFFFFFFFF
    return out


def np_lex_argsort(keys_np):
    """Host lexicographic argsort of (N, W) uint64 keys."""
    keys_np = np.asarray(keys_np)
    if keys_np.ndim == 1:
        keys_np = keys_np[:, None]
    cols = [keys_np[:, i] for i in range(keys_np.shape[1] - 1, -1, -1)]
    return np.lexsort(cols)


def np_lex_is_sorted(keys_np) -> bool:
    """True iff (N, W) uint64 keys are lexicographically non-decreasing:
    one vectorized pass that lets SkaArray.sorted_view skip its argsort
    (the .skf files of both packages store keys sorted; the reference's
    files and weeded arrays may not)."""
    keys_np = np.asarray(keys_np)
    if keys_np.ndim == 1:
        keys_np = keys_np[:, None]
    if keys_np.shape[0] <= 1:
        return True
    a, b = keys_np[:-1], keys_np[1:]
    if keys_np.shape[1] == 1:
        return bool(np.all(a[:, 0] <= b[:, 0]))
    # rows compare <= iff at the first differing limb a < b
    lt = a[:, 0] < b[:, 0]
    eq = a[:, 0] == b[:, 0]
    for w in range(1, keys_np.shape[1] - 1):
        lt |= eq & (a[:, w] < b[:, w])
        eq &= a[:, w] == b[:, w]
    last = keys_np.shape[1] - 1
    return bool(np.all(lt | (eq & (a[:, last] <= b[:, last]))))
