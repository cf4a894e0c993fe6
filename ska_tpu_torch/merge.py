"""Union of key-sorted split k-mer arrays (the port's copy of
``extend_arrays`` of ska_tpu/merge.py).

The reference merges per-sample hashmaps (src/merge_ska_dict.rs:160-193).
Arrays built here are key-sorted, so the union of the batches of a
build is a linear B-way merge in the host library
(csrc/host/merge_batches.cpp); no host sort touches the full union.
"""

from typing import List

import numpy as np

from .array import SkaArray, _combine128
from .io import native
from .ops import npkeys as K


def _sorted_rows(a: SkaArray):
    """(keys, variants) with rows in lexicographic key order; no copy when
    already sorted (the common case for arrays built by this package)."""
    keys = a.keys
    if keys.shape[0] > 1:
        if keys.shape[1] == 1:
            flat = keys[:, 0]
            is_sorted = bool(np.all(flat[1:] >= flat[:-1]))
        else:
            comb = _combine128(keys)
            is_sorted = bool(np.all(comb[1:] >= comb[:-1]))
        if not is_sorted:
            order = K.np_lex_argsort(keys)
            return keys[order], a.variants[order]
    return keys, a.variants


def extend_arrays(arrays: List[SkaArray]) -> SkaArray:
    """`ska merge`: union of k-mers, concatenated sample columns
    (reference MergeSkaDict::extend, merge_ska_dict.rs:160-193).
    Unsorted inputs (reference-written .skf files keep hashmap row
    order) are sorted per array first."""
    if not arrays:
        raise ValueError("No .skf files to merge")
    k = arrays[0].k
    rc = arrays[0].rc
    for a in arrays[1:]:
        if a.k != k:
            raise ValueError(f"K-mer lengths do not match: {a.k} {k}")
        if a.rc != rc:
            raise ValueError("Strand use inconsistent")
    names = [n for a in arrays for n in a.names]
    pairs = [_sorted_rows(a) for a in arrays]
    ukeys, variants, counts = native.merge_batches(
        [p[0] for p in pairs], [p[1] for p in pairs]
    )
    return SkaArray(k=k, rc=rc, names=names, keys=ukeys, variants=variants,
                    counts=counts)
