"""Static multi-sample split k-mer array (the `.skf` content); the port's
copy of what `build`, `load` and `align` use of ska_tpu/array.py.

Counterpart of reference MergeSkaArray (src/merge_ska_array.rs:108-126):
rows are split k-mers (sorted by packed key), columns are samples,
values are ASCII IUPAC middle bases with b'-' for missing. The row
filters run in the host library (csrc/host/filters.cpp).
"""

from dataclasses import dataclass
from typing import List

import numpy as np

from .constants import SKA_VERSION
from .encoding import IS_AMBIGUOUS
from .io import native
from .io.fastx import write_fasta


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

    # --- alignment output (merge_ska_array.rs:499-517) ---------------------

    def write_fasta(self, fh):
        vt = np.ascontiguousarray(self.variants.T)
        for name, row in zip(self.names, vt):
            write_fasta(name, row.tobytes(), fh)


def _combine128(arr):
    """(n, 2) uint64 -> sortable void/structured scalar preserving lex order."""
    a = np.ascontiguousarray(arr.astype(">u8"))
    return a.view([("v", "S16")])["v"].ravel()
