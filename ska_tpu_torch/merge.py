"""Merging on the host (the port's copy of ska_tpu/merge.py):
``merge_samples`` of per-sample dictionaries into an array, and
``extend_arrays``, the union of key-sorted split k-mer arrays.

The reference merges per-sample hashmaps (src/merge_ska_dict.rs:160-193).
Arrays built here are key-sorted, so the union of the batches of a
build is a linear B-way merge in the host library
(csrc/host/merge_batches.cpp); no host sort touches the full union.
"""

from typing import List

import numpy as np

from .array import SkaArray, _combine128
from .encoding import SET_TO_ASCII
from .io import native
from .ops import npkeys as K
from .sampletypes import SampleDict


def merge_samples(samples: List[SampleDict]) -> SkaArray:
    """Merge per-sample dictionaries into an array (rows sorted by key).

    Equivalent to MergeSkaDict::append/merge + MergeSkaArray::new
    (merge_ska_dict.rs:77-151, merge_ska_array.rs:166-186); missing
    entries become b'-'.
    """
    if not samples:
        raise ValueError("No samples to merge")
    k = samples[0].k
    rc = samples[0].rc
    for s in samples[1:]:
        if s.k != k:
            raise ValueError(f"K-mer lengths do not match: {s.k} {k}")
        if s.rc != rc:
            raise ValueError("Strand use inconsistent")
    all_keys = np.concatenate([s.keys for s in samples], axis=0)
    all_sets = np.concatenate([s.sets for s in samples], axis=0)
    all_sidx = np.concatenate(
        [np.full(s.ksize, i, dtype=np.int32) for i, s in enumerate(samples)]
    )
    order = K.np_lex_argsort(all_keys)
    skeys = all_keys[order]
    if len(skeys) == 0:
        raise ValueError("No split k-mers found")
    first = np.ones(len(skeys), dtype=bool)
    first[1:] = np.any(skeys[1:] != skeys[:-1], axis=-1)
    ids = np.cumsum(first) - 1
    n_rows = int(ids[-1]) + 1

    variants = np.full((n_rows, len(samples)), ord("-"), dtype=np.uint8)
    variants[ids, all_sidx[order]] = SET_TO_ASCII[all_sets[order]]
    counts = np.bincount(ids, minlength=n_rows).astype(np.int64)
    return SkaArray(k=k, rc=rc, names=[s.name for s in samples],
                    keys=skeys[first], variants=variants, counts=counts)


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
