"""Mode orchestration of the port (counterpart of ska_tpu/api.py).

``build`` runs the port's device build; ``align`` is host numpy and the
host library's row filters, a copy of the JAX package's; ``map_mode``
(reference scan and lookup), ``distance_mode`` (the class Gram) and
``weed_mode`` (the weed FASTA's scan) run their device parts on
``device``. ``merge_mode`` and ``delete_mode`` are host code, as in the
JAX package.
"""

import math
from typing import List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from .array import SkaArray
from .constants import (
    DEFAULT_KMER,
    DEFAULT_MINCOUNT,
    DEFAULT_MINQUAL,
    FILTER_NOCONST,
    FILTER_NOFILTER,
    QUAL_STRICT,
)
from .io import fastx, skf
from .merge import extend_arrays
from .sample import build_samples_distributed, build_samples_merged
from .sampletypes import QualOpts


def build(
    input_files: List[Tuple[str, str, Optional[str]]],
    k: int,
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
    device=None,
) -> SkaArray:
    """`ska build` of FASTA and/or FASTQ samples: one device pass per
    batch (chunked passes for a sample over the dispatch cap), a host
    union across batches, then the input column order restored (batch
    grouping may permute samples), as ska_tpu.api.build. In a process
    group (parallel.use_distributed) every rank runs it: the samples are
    cut over the ranks and merge by key range (sample.py
    build_samples_distributed), and every rank gets the array."""
    from .parallel import use_distributed

    if use_distributed(device):
        batches = build_samples_distributed(
            input_files, k, rc, qual, proportion_reads, device=device)
    else:
        batches = build_samples_merged(
            input_files, k, rc, qual, proportion_reads, device=device)
    return assemble(batches, k, rc)


def assemble(batches, k: int, rc: bool) -> SkaArray:
    """The SkaArray of build_samples_merged's (or _distributed's) batch
    results: their host union, in the input column order. `build` and
    the browser aligner (webapi.py AlignData, whose batches of several
    calls carry indices counted over the session) call it."""
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


def apply_filters(
    arr: SkaArray,
    min_freq: float,
    filter_ambig_as_missing: bool,
    filter_type: str,
    ambig_mask: bool,
    ignore_const_gaps: bool,
) -> int:
    """min_freq threshold = ceil(n * f) (generic_modes.rs:112-131)."""
    threshold = math.ceil(arr.nsamples * min_freq)
    return arr.filter(
        threshold, filter_ambig_as_missing, filter_type, ambig_mask, ignore_const_gaps
    )


def align(
    arr: SkaArray,
    out_fh,
    filter_type: str = FILTER_NOCONST,
    ambig_mask: bool = False,
    ignore_const_gaps: bool = False,
    min_freq: float = 0.9,
    filter_ambig_as_missing: bool = False,
):
    """`ska align` (generic_modes.rs:22-50)."""
    apply_filters(
        arr, min_freq, filter_ambig_as_missing, filter_type, ambig_mask, ignore_const_gaps
    )
    arr.write_fasta(out_fh)


def map_mode(
    arr: SkaArray,
    reference: str,
    out_fh,
    fmt: str = "aln",
    ambig_mask: bool = False,
    repeat_mask: bool = False,
    device=None,
):
    """`ska map` (generic_modes.rs:56-84)."""
    from .ref import RefSka

    ska_ref = RefSka(arr.k, reference, arr.rc, ambig_mask, repeat_mask,
                     device=device)
    ska_ref.map(arr)
    if fmt == "aln":
        ska_ref.write_aln(out_fh)
    elif fmt == "vcf":
        ska_ref.write_vcf(out_fh)
    else:
        raise ValueError(f"Unknown format {fmt}")


def distance_mode(arr: SkaArray, out_fh, min_freq: float, filt_ambig: bool,
                  device=None):
    """`ska distance` (generic_modes.rs:136-189): population min-freq
    filter, then constant-site removal feeds the match denominator."""
    if min_freq * arr.nsamples >= 1.0:
        apply_filters(arr, min_freq, False, FILTER_NOFILTER, False, False)
    constant = apply_filters(arr, 0.0, False, FILTER_NOCONST, False, False)

    dists = arr.distance(float(constant), filt_ambig, device)
    out_fh.write(
        "Sample1\tSample2\tDistance\tMismatches (proportion)\tMatch count\tMismatch count\n"
    )
    names = arr.names
    for i, row in enumerate(dists):
        for d, j in zip(row, range(i + 1, len(names))):
            out_fh.write(f"{names[i]}\t{names[j]}\t{d}\n")


def merge_mode(skf_files: List[str], output: str):
    """`ska merge` (generic_modes.rs:90-106)."""
    arrays = [skf.load(f) for f in skf_files]
    merged = extend_arrays(arrays)
    skf.save(merged, output)


def delete_mode(arr: SkaArray, names: List[str], output: str):
    """`ska delete` (generic_modes.rs:192-210)."""
    arr.delete_samples(names)
    skf.save(arr, output)


def weed_mode(
    arr: SkaArray,
    weed_file: Optional[str],
    reverse: bool,
    min_freq: float,
    filter_ambig_as_missing: bool,
    filter_type: str,
    ambig_mask: bool,
    ignore_const_gaps: bool,
    output: str,
    device=None,
):
    """`ska weed` (generic_modes.rs:214-267): the weed k-mers come from a
    RefSka scan of the weed FASTA on `device`; threshold =
    floor(n * f)."""
    if weed_file is not None:
        from .ref import RefSka

        weed_ref = RefSka(arr.k, weed_file, arr.rc, ambig_mask=False,
                          repeat_mask=False, device=device)
        arr.weed(weed_ref.kmers, reverse)

    threshold = math.floor(arr.nsamples * min_freq)
    if threshold > 0 or filter_type != FILTER_NOFILTER or ambig_mask or ignore_const_gaps:
        arr.filter(
            threshold, filter_ambig_as_missing, filter_type, ambig_mask, ignore_const_gaps
        )
    skf.save(arr, output, add_suffix=False)
