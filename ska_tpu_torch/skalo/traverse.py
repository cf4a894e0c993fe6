"""Variant paths and the indel split (reference src/skalo/read_graph.rs);
the port's copy of what the C++ route of ska_tpu/skalo/traverse.py
uses. The bubble walk itself is csrc/host/skalo_core.cpp (core.py)."""

import logging
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .variants import analyse_variant_groups

log = logging.getLogger("ska_tpu_torch.skalo")


@dataclass(slots=True)
class VariantInfo:
    """utils.rs:57-70: a path's sequence plus candidate SNP positions.

    `idx` is the path's row in the traversal core's master buffers
    (core.PathStore), from which the C++ SNP stage reads it."""

    sequence: str
    vec_snps: List[int]
    idx: int = -1


def split_and_analyse(
    built_groups, kmer_samples, config, k_graph, sample_names, path_store
):
    """Indel split (read_graph.rs:236-262) + SNP/indel analysis."""
    log.info("Identifying indels")

    min_indel = 2 * k_graph
    final_groups: Dict[Tuple[int, int], List[VariantInfo]] = {}
    final_indels: Dict[Tuple[int, int], List[VariantInfo]] = {}

    for ext, vec_variant in built_groups.items():
        if len(vec_variant) < 2:
            continue
        # GroupPaths gives the lengths without materializing VariantInfos
        lens = vec_variant.lengths
        if len(vec_variant) == 2 and lens[0] != lens[1]:
            if lens[0] <= min_indel or lens[1] <= min_indel:
                final_indels[ext] = vec_variant
        else:
            final_groups[ext] = vec_variant

    analyse_variant_groups(
        final_groups, final_indels, kmer_samples, config, k_graph, sample_names,
        path_store,
    )
