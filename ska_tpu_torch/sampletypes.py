"""Options of a build and one sample's dictionary (the port's copy of
ska_tpu/sampletypes.py)."""

from dataclasses import dataclass

import numpy as np

from .constants import QUAL_STRICT


@dataclass
class QualOpts:
    """FASTQ filtering options (reference src/lib.rs:533-540)."""

    min_count: int = 0
    min_qual: int = 0
    qual_filter: int = QUAL_STRICT


@dataclass
class SampleDict:
    """One sample's sorted key array + middle-base sets."""

    name: str
    k: int
    rc: bool
    keys: np.ndarray  # (n, W) uint64, sorted ascending
    sets: np.ndarray  # (n,) uint8 4-bit base sets

    @property
    def ksize(self) -> int:
        return len(self.sets)
