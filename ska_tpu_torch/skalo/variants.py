"""SNP calling over variant groups (reference
src/skalo/process_variants.rs); the port's copy of the C++ route of
ska_tpu/skalo/variants.py. The path filter stays in Python, as there;
the SNP stage runs in the host library (csrc/host/skalo_snps.cpp)."""

import ctypes
import logging
from typing import Dict, List, Tuple

import numpy as np

from ..io.native import _lib
from .indels import process_indels
from .kmer_utils import encode_str, rev_comp_int
from .output import create_fasta_and_vcf
from .positioning import extract_genomic_kmers

log = logging.getLogger("ska_tpu_torch.skalo")

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def find_internal_indels(variant, entries_indels, k_graph):
    """process_variants.rs:227-245 (rolling 2-bit encode; re-encoding every
    window costs O(len * k) and dominated whole runs at genome scale)."""
    if not entries_indels:
        return 0
    seq = variant.sequence
    n = len(seq)
    if n <= k_graph:  # reference iterates windows 0 .. n-k_graph-1
        return 0
    nb = 0
    mask = (1 << (2 * k_graph)) - 1
    enc = encode_str(seq[:k_graph])
    if enc in entries_indels:
        nb += 1
    for i in range(k_graph, n - 1):
        enc = ((enc << 2) | ((ord(seq[i]) >> 1) & 3)) & mask
        if enc in entries_indels:
            nb += 1
    return nb


def _snps_lib():
    lib = _lib()
    if not hasattr(lib, "_snps_bound"):
        lib.skalo_snps_new.restype = ctypes.c_void_p
        lib.skalo_snps_new.argtypes = [
            _u64p, _u64p, _u64p, ctypes.c_int64, ctypes.c_int64,
            _u64p, _u64p, _u8p, _i64p, _i64p, _i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]
        lib.skalo_snps_count.restype = ctypes.c_int64
        lib.skalo_snps_count.argtypes = [ctypes.c_void_p]
        lib.skalo_snps_not_positioned.restype = ctypes.c_int64
        lib.skalo_snps_not_positioned.argtypes = [ctypes.c_void_p]
        lib.skalo_snps_fill.restype = None
        lib.skalo_snps_fill.argtypes = [ctypes.c_void_p, _i64p, _u8p]
        lib.skalo_snps_free.restype = None
        lib.skalo_snps_free.argtypes = [ctypes.c_void_p]
        lib.skalo_snps_run_paths.restype = ctypes.c_int64
        lib.skalo_snps_run_paths.argtypes = [
            ctypes.c_void_p, _i32p, _i64p, _i64p, _u8p, _u64p, _u64p,
            _i64p, _i64p, _i64p, _i64p, ctypes.c_int64,
        ]
        lib._snps_bound = True
    return lib


def _native_snps(
    sorted_keys, variant_groups, entries_indels, kmer_samples, kmer_map,
    do_positioning, config, k_graph, sample_names, path_store,
):
    """C++ SNP stage (csrc/host/skalo_snps.cpp), any k_graph <= 62
    (two-limb window encodes and a two-limb genome map for 32 < k_graph).
    Every path is a row of the traversal core's master buffers
    (core.PathStore), so one call walks the groups in order. Returns
    (final_snps dict, not_positioned)."""
    lib = _snps_lib()
    if do_positioning:
        gm_lo = np.ascontiguousarray(kmer_map._lo)
        gm_hi = (
            np.ascontiguousarray(kmer_map._hi)
            if kmer_map._hi is not None
            else np.zeros(0, np.uint64)
        )
        gm_keep = np.ascontiguousarray(kmer_map._keep.astype(np.uint8))
        gm_starts = np.ascontiguousarray(kmer_map._starts.astype(np.int64))
        gm_counts = np.ascontiguousarray(kmer_map._counts.astype(np.int64))
        gm_pos = np.ascontiguousarray(kmer_map._pos.astype(np.int64))
    else:
        gm_lo = gm_hi = np.zeros(0, np.uint64)
        gm_keep = np.zeros(0, np.uint8)
        gm_starts = gm_counts = gm_pos = np.zeros(0, np.int64)

    ks_hi = kmer_samples.hi_or_none()
    h = lib.skalo_snps_new(
        # narrow export: hi limbs all zero, pass NULL (ks_find treats it as 0)
        ks_hi.ctypes.data_as(_u64p) if ks_hi is not None else None,
        kmer_samples.lo.ctypes.data_as(_u64p),
        kmer_samples.masks.ctypes.data_as(_u64p),
        len(kmer_samples.lo), kmer_samples.masks.shape[1],
        gm_hi.ctypes.data_as(_u64p),
        gm_lo.ctypes.data_as(_u64p), gm_keep.ctypes.data_as(_u8p),
        gm_starts.ctypes.data_as(_i64p), gm_counts.ctypes.data_as(_i64p),
        gm_pos.ctypes.data_as(_i64p), len(gm_lo),
        1 if do_positioning else 0, k_graph, len(sample_names),
        float(config.max_missing),
    )
    pidx: List[int] = []
    grp_off: List[int] = [0]
    for key, _ratio in sorted_keys:
        if (
            key[0] in entries_indels
            or rev_comp_int(key[1], k_graph) in entries_indels
        ):
            continue
        vec_variants = variant_groups[key]
        if len(vec_variants) < 2:
            continue
        pidx.extend(vec_variants.path_indices())
        grp_off.append(len(pidx))

    try:
        log.info("bulk SNP stage: %d groups", len(grp_off) - 1)
        pidx_a = np.asarray(pidx, np.int64)
        grp_a = np.asarray(grp_off, np.int64)
        rcode = lib.skalo_snps_run_paths(
            h,
            np.ascontiguousarray(path_store.segs).ctypes.data_as(_i32p),
            np.ascontiguousarray(path_store.segs_off).ctypes.data_as(_i64p),
            np.ascontiguousarray(path_store.chain_off).ctypes.data_as(_i64p),
            np.ascontiguousarray(path_store.chain_codes).ctypes.data_as(_u8p),
            np.ascontiguousarray(path_store.ent_hi).ctypes.data_as(_u64p),
            np.ascontiguousarray(path_store.ent_lo).ctypes.data_as(_u64p),
            np.ascontiguousarray(path_store.snps).ctypes.data_as(_i64p),
            np.ascontiguousarray(path_store.soff).ctypes.data_as(_i64p),
            pidx_a.ctypes.data_as(_i64p),
            grp_a.ctypes.data_as(_i64p),
            len(grp_off) - 1,
        )
        if rcode == -2:
            raise MemoryError("ska lo: SNP stage exceeded available memory")
        if rcode != 0:
            raise KeyError("full k-mer missing from kmer_samples")
        n = lib.skalo_snps_count(h)
        not_positioned = lib.skalo_snps_not_positioned(h)
        pos = np.empty(n, np.int64)
        cols = np.empty(n * len(sample_names), np.uint8)
        lib.skalo_snps_fill(h, pos.ctypes.data_as(_i64p), cols.ctypes.data_as(_u8p))
    finally:
        lib.skalo_snps_free(h)

    cols = cols.reshape(n, len(sample_names))
    final_snps: Dict[int, List[str]] = {}
    pos_l = pos.tolist()
    for i in range(n):
        final_snps[pos_l[i]] = [chr(b) for b in cols[i]]
    return final_snps, int(not_positioned)


def analyse_variant_groups(
    variant_groups: Dict[Tuple[int, int], List],
    indel_groups: Dict[Tuple[int, int], List],
    kmer_samples,
    config,
    k_graph: int,
    sample_names: List[str],
    path_store,
):
    """process_variants.rs:20-225."""
    if config.reference_genome is not None:
        log.info("Reading reference genome")
        kmer_map, genome_seq, genome_name = extract_genomic_kmers(
            config.reference_genome, k_graph
        )
        do_positioning = True
    else:
        do_positioning = False
        kmer_map, genome_seq, genome_name = None, b"", ""

    entries_indels = process_indels(
        indel_groups, kmer_samples, config, k_graph, sample_names
    )

    log.info("Filtering paths")
    if entries_indels:  # find_internal_indels is identically 0 otherwise
        for vec_variant in variant_groups.values():
            i = 0
            while i < len(vec_variant):
                if find_internal_indels(vec_variant[i], entries_indels, k_graph) > config.max_indel_kmers:
                    vec_variant.pop(i)
                else:
                    i += 1

    log.info("Sorting variant groups")
    sorted_keys = []
    for key, value in variant_groups.items():
        if len(value):
            ratio = len(value) / value.first_seq_len
            sorted_keys.append((key, ratio))
    # Descending ratio; ties broken on (entry, exit), as in the JAX
    # package, so the order (and the order-dependent entries_done dedup
    # of the SNP stage) is fixed (reference order among ties is HashMap
    # iteration, i.e. unspecified; process_variants.rs:66-77).
    sorted_keys.sort(key=lambda kv: (-kv[1], kv[0]))

    log.info("Processing SNPs")
    final_snps, not_positioned = _native_snps(
        sorted_keys, variant_groups, entries_indels, kmer_samples, kmer_map,
        do_positioning, config, k_graph, sample_names, path_store,
    )
    if do_positioning:
        log.info("%d SNPs (+ %d w/o position)", len(final_snps), not_positioned)
    else:
        log.info("%d SNPs", len(final_snps))
    create_fasta_and_vcf(genome_name, genome_seq, sample_names, final_snps, config)
