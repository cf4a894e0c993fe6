"""Options of a build (the port's copy of ska_tpu/sampletypes.py's
``QualOpts``)."""

from dataclasses import dataclass

from .constants import QUAL_STRICT


@dataclass
class QualOpts:
    """FASTQ filtering options (reference src/lib.rs:533-540)."""

    min_count: int = 0
    min_qual: int = 0
    qual_filter: int = QUAL_STRICT
