"""Static multi-sample split k-mer array (the `.skf` content); the port's
copy of what `build`, `load`, `align`, `map`, `distance`, `weed`,
`delete` and `nk` use of ska_tpu/array.py.

Counterpart of reference MergeSkaArray (src/merge_ska_array.rs:108-126):
rows are split k-mers (sorted by packed key), columns are samples,
values are ASCII IUPAC middle bases with b'-' for missing. The row
filters run in the host library (csrc/host/filters.cpp).
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from .constants import SKA_VERSION
from .encoding import IS_AMBIGUOUS, LETTER_CODE
from .io import native
from .io.fastx import write_fasta
from .ops import npkeys as K

_GAP = ord("-")


@dataclass
class SkaArray:
    k: int
    rc: bool
    names: List[str]
    keys: np.ndarray  # (n, W) uint64 sorted lexicographically
    variants: np.ndarray  # (n, s) uint8 ASCII
    counts: np.ndarray  # (n,) non-missing count per row; any integer
    # dtype whose range covers n_samples (loads keep the byte-narrow
    # decode's uint8)
    ska_version: str = SKA_VERSION

    @property
    def ksize(self) -> int:
        return self.variants.shape[0]

    @property
    def nsamples(self) -> int:
        return self.variants.shape[1]

    @property
    def kbits(self) -> int:
        return 64 * self.keys.shape[1]

    def n_sample_kmers(self):
        return (self.variants != _GAP).sum(axis=0)

    def sorted_view(self):
        """(sorted_keys, row_permutation) for lookups; perm None means
        the identity.

        Row storage order is user-visible (alignment column order), so
        the array itself is not reordered. The .skf files of both
        packages store keys sorted, so one sortedness check usually
        replaces the argsort; reference-written or weeded arrays take
        the lexsort. The fast path returns self.keys itself, the other
        a fresh copy: treat either as read-only.
        """
        if K.np_lex_is_sorted(self.keys):
            return self.keys, None
        perm = K.np_lex_argsort(self.keys)
        return self.keys[perm], perm

    # --- row maintenance (merge_ska_array.rs:139-163) ---------------------

    def _take_rows(self, mask):
        self.keys = self.keys[mask]
        self.variants = self.variants[mask]
        self.counts = self.counts[mask]

    def update_counts(self, filter_ambig_as_missing: bool):
        """Recount non-missing per row, dropping empty rows
        (merge_ska_array.rs:139-163)."""
        counts = native.update_counts(
            self.variants, filter_ambig_as_missing, IS_AMBIGUOUS.view(np.uint8))
        self.counts = counts
        self._take_rows(counts > 0)

    def delete_samples(self, del_names):
        """Remove named samples, update counts, drop empty rows
        (merge_ska_array.rs:231-271)."""
        if len(del_names) == 0 or len(del_names) == self.nsamples:
            raise ValueError("Invalid number of samples to remove")
        del_set = set(del_names)
        keep_cols = []
        new_names = []
        for idx, name in enumerate(self.names):
            if name in del_set:
                del_set.discard(name)
            else:
                keep_cols.append(idx)
                new_names.append(name)
        if del_set:
            raise ValueError(f"Could not find sample(s): {sorted(del_set)}")
        self.variants = self.variants[:, keep_cols]
        self.names = new_names
        self.update_counts(False)

    # --- site filters (merge_ska_array.rs:289-402) ------------------------

    def filter(
        self,
        min_count: int,
        filter_ambig_as_missing: bool,
        filter_type: str,
        mask_ambig: bool,
        ignore_const_gaps: bool,
    ) -> int:
        """Row filters, the count threshold and the filter_type predicate
        fused in one matrix pass; returns the number of removed sites."""
        if filter_ambig_as_missing:
            self.update_counts(True)
        n = self.ksize
        keep = native.filter_keep(
            self.variants, self.counts, min_count, filter_type,
            ignore_const_gaps, IS_AMBIGUOUS.view(np.uint8))
        removed = int(n - keep.sum())
        self._take_rows(keep)
        if mask_ambig:
            amb = IS_AMBIGUOUS[self.variants]
            self.variants = np.where(amb, np.uint8(ord("N")), self.variants)
        return removed

    # --- weed (merge_ska_array.rs:452-487) --------------------------------

    def weed(self, weed_keys: np.ndarray, reverse: bool):
        """Remove rows whose key is in weed_keys (or keep only those)."""
        if len(weed_keys):
            wk = np.unique(np.asarray(weed_keys, dtype=np.uint64), axis=0)
            found = _np_member(self.keys, wk)
        else:
            found = np.zeros(self.ksize, dtype=bool)
        self._take_rows(found if reverse else ~found)

    # --- alignment output (merge_ska_array.rs:499-517) ---------------------

    def write_fasta(self, fh):
        vt = np.ascontiguousarray(self.variants.T)
        for name, row in zip(self.names, vt):
            write_fasta(name, row.tobytes(), fh)

    # --- nk output (merge_ska_array.rs:649-698) ----------------------------

    def nk_display(self) -> str:
        rc = "true" if self.rc else "false"
        names = ", ".join(f'"{n}"' for n in self.names)
        kmers = ", ".join(str(int(x)) for x in self.n_sample_kmers())
        return (
            f"ska_version={self.ska_version}\n"
            f"k={self.k}\n"
            f"k_bits={self.kbits}\n"
            f"rc={rc}\n"
            f"k-mers={self.ksize}\n"
            f"samples={self.nsamples}\n"
            f"sample_names=[{names}]\n"
            f"sample_kmers=[{kmers}]\n"
        )

    def nk_full_info(self) -> str:
        """One fixed-width line per split k-mer (upper half, tab, lower
        half, tab, comma-joined middle bases), assembled as one uint8
        matrix."""
        half = (self.k - 1) // 2
        kb = self.k - 1
        n = self.ksize
        if n == 0:
            return ""
        W = self.keys.shape[1]
        hi = self.keys[:, 0] if W == 2 else np.zeros(n, np.uint64)
        lo = self.keys[:, W - 1]
        lut = np.frombuffer(bytes(LETTER_CODE[:4]), dtype=np.uint8)
        chars = np.empty((n, kb), np.uint8)
        for j in range(kb):
            bits = 2 * (kb - 1 - j)
            if bits >= 64:
                c = (hi >> np.uint64(bits - 64)) & np.uint64(3)
            elif bits > 0:
                c = ((lo >> np.uint64(bits)) | (hi << np.uint64(64 - bits))) & np.uint64(3)
            else:
                c = lo & np.uint64(3)
            chars[:, j] = lut[c.astype(np.int64)]
        S = self.nsamples
        width = kb + 2 + (2 * S - 1) + 1
        out = np.empty((n, width), np.uint8)
        out[:, :half] = chars[:, :half]
        out[:, half] = 9  # \t
        out[:, half + 1 : kb + 1] = chars[:, half:]
        out[:, kb + 1] = 9
        out[:, kb + 2 : kb + 1 + 2 * S : 2] = self.variants
        if S > 1:
            out[:, kb + 3 : kb + 1 + 2 * S : 2] = ord(",")
        out[:, -1] = 10  # \n
        return out.tobytes().decode()

    # --- distances (merge_ska_array.rs:416-438, 587-632) -------------------

    def distance(self, constant: float, filt_ambig: bool, device=None):
        """Pairwise distances from the 16-class co-occurrence Gram on
        `device` (distance.py)."""
        from .distance import pairwise_stats

        return pairwise_stats(self.variants, constant, filt_ambig, device)


def _np_member(keys: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """Membership of (n, W) keys in the sorted unique (m, W) set."""
    if sorted_set.ndim == 1:
        sorted_set = sorted_set[:, None]
    n, W = keys.shape
    if len(sorted_set) == 0:
        return np.zeros(n, dtype=bool)
    if W == 1:
        idx = np.searchsorted(sorted_set[:, 0], keys[:, 0])
        idx = np.clip(idx, 0, len(sorted_set) - 1)
        return sorted_set[idx, 0] == keys[:, 0]
    comb_set = _combine128(sorted_set)
    comb_q = _combine128(keys)
    idx = np.clip(np.searchsorted(comb_set, comb_q), 0, len(comb_set) - 1)
    return comb_set[idx] == comb_q


def _combine128(arr):
    """(n, 2) uint64 -> sortable void/structured scalar preserving lex order."""
    a = np.ascontiguousarray(arr.astype(">u8"))
    return a.view([("v", "S16")])["v"].ravel()
