"""Mode orchestration of the port (counterpart of ska_tpu/api.py).

``build`` runs the port's device build; ``align`` is the JAX package's own
host-numpy function, re-exported unchanged.
"""

from typing import List, Optional, Tuple

import numpy as np
from ska_tpu.api import align  # noqa: F401 - re-exported host numpy mode
from ska_tpu.array import SkaArray
from ska_tpu.constants import (
    DEFAULT_KMER,
    DEFAULT_MINCOUNT,
    DEFAULT_MINQUAL,
    QUAL_STRICT,
)
from ska_tpu.io import fastx, skf
from ska_tpu.merge import extend_arrays
from ska_tpu.sampletypes import QualOpts
from torch.profiler import record_function

from .sample import build_samples_merged


def build(
    input_files: List[Tuple[str, str, Optional[str]]],
    k: int,
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
    device=None,
) -> SkaArray:
    """`ska build` of a FASTA cohort: one device pass per batch, a host
    union across batches, then the input column order restored (batch
    grouping by length may permute samples), as ska_tpu.api.build."""
    batches = build_samples_merged(
        input_files, k, rc, qual, proportion_reads, device=device
    )
    arrays = [
        SkaArray(k=k, rc=rc, names=names, keys=keys, variants=var, counts=counts)
        for (_, names, keys, var, counts) in batches
    ]
    with record_function("ska::union"):
        merged = arrays[0] if len(arrays) == 1 else extend_arrays(arrays)
        order_idx = [i for (chunk, *_rest) in batches for i in chunk]
        if order_idx != sorted(order_idx):
            perm = np.argsort(np.asarray(order_idx))
            merged.variants = merged.variants[:, perm]
            merged.names = [merged.names[p] for p in perm]
    return merged


def load_array(inputs: List[str], device=None) -> SkaArray:
    """Load an .skf, or build from several FASTA files with the default
    settings (reference io_utils.rs:60-93), as ska_tpu.api.load_array."""
    if len(inputs) == 1:
        return skf.load(inputs[0])
    qual = QualOpts(
        min_count=DEFAULT_MINCOUNT, min_qual=DEFAULT_MINQUAL, qual_filter=QUAL_STRICT
    )
    return build(fastx.read_input_fastas(inputs), DEFAULT_KMER, True, qual,
                 device=device)
