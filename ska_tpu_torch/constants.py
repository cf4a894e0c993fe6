"""CLI defaults, mirroring the reference's `pub const` block (src/cli.rs:8-35).

The port's copy of ska_tpu/constants.py: the defaults, the quality and
site filter modes and ``check_k``.
"""

# the ska_version field of every .skf written; the JAX package's
# __version__ (capability parity with reference v0.5.2), so that both
# packages write the same bytes
SKA_VERSION = "0.5.2"

DEFAULT_KMER = 31
DEFAULT_PROPORTION_READS = None
DEFAULT_STRAND = False  # single_strand default; rc = not single_strand
DEFAULT_MINFREQ = 0.9
DEFAULT_AMBIGMISSING = False
DEFAULT_REPEATMASK = False
DEFAULT_AMBIGMASK = False
DEFAULT_CONSTGAPS = False
DEFAULT_MINCOUNT = 5
DEFAULT_MINQUAL = 20
DEFAULT_QUALFILTER = "strict"
DEFAULT_MISSING_SKALO = 0.1
DEFAULT_MAX_PATHDEPTH = 4
DEFAULT_MAX_INDEL_KMERS = 2

# Quality filter modes (reference src/lib.rs:512-520)
QUAL_NOFILTER = 0
QUAL_MIDDLE = 1
QUAL_STRICT = 2

QUAL_FILTER_NAMES = {
    "no-filter": QUAL_NOFILTER,
    "middle": QUAL_MIDDLE,
    "strict": QUAL_STRICT,
}

# Site filter modes (reference src/cli.rs:128-138)
FILTER_NOFILTER = "no-filter"
FILTER_NOCONST = "no-const"
FILTER_NOAMBIG = "no-ambig"
FILTER_NOAMBIGORCONST = "no-ambig-or-const"


def check_k(k: int) -> int:
    """k must be odd and 5..=63 (reference src/cli.rs:38-47)."""
    if not (5 <= k <= 63) or k % 2 == 0:
        raise ValueError("K-mer must be an odd number between 5 and 63 (inclusive)")
    return k
