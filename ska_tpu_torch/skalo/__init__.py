"""`ska lo` (skalo): colored De Bruijn graph SNP/indel recovery; the
port's copy of the C++ route of ska_tpu/skalo/.

Counterpart of reference src/skalo/ (8 files): the graph core in the
host library (csrc/host/skalo_core.cpp, via core.py) expands the split
k-mer array into a (k-1)-mer graph with per-full-k-mer sample sets,
finds bubble entry and exit nodes, compacts unbranched chains and walks
the bubbles to bounded depth; traverse.py splits off the indels and
variants.py filters the paths in Python, then calls SNPs in the host
library (csrc/host/skalo_snps.cpp) with optional positioning on a
reference genome. All of it runs on the host, as in the JAX package,
whatever --device says. The JAX package's pure-Python graph route
(SKA_SKALO_CORE=python) is not copied.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass
class SkaloConfig:
    """Reference skalo::utils::Config (utils.rs:8-27)."""

    output_name: str
    max_missing: float = 0.1
    max_depth: int = 4
    max_indel_kmers: int = 2
    reference_genome: Optional[str] = None


def run_skalo(ska_array, config: SkaloConfig):
    """Orchestration, mirroring generic_modes.rs:286-306: the C++ graph
    core, then the indel split and the SNP stage."""
    from .core import run_core
    from .traverse import split_and_analyse

    len_kmer, sample_names, built_groups, kmer_samples, paths = run_core(
        ska_array, config
    )
    split_and_analyse(
        built_groups, kmer_samples, config, len_kmer - 1, sample_names, paths,
    )
