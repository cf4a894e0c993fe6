"""The reference genome's k-mer map for positioning variant groups
(reference src/skalo/positioning.rs:16-95); the port's copy of
extract_genomic_kmers of ska_tpu/skalo/positioning.py. The C++ SNP
stage (csrc/host/skalo_snps.cpp) does the vote over this map
(positioning.rs:129-255)."""

import gzip

import numpy as np


def extract_genomic_kmers(file_path, k: int):
    """positioning.rs:16-95: k-mers with <= 3 positions; single-sequence
    reference only; positions stored as (start + k). Returns (kmer_map,
    genome_seq, genome_name)."""
    opener = gzip.open if str(file_path).endswith(".gz") else open
    with opener(file_path, "rt") as f:
        text = f.read()

    genome_seq = b""
    genome_name = ""
    count = 0
    for block in text.split(">"):
        if not block.strip():
            continue
        count += 1
        if count > 1:
            raise SystemExit(
                "\nError: more than one sequence detected in the reference genome file.\n"
            )
        lines = block.split("\n")
        genome_name = lines[0].split()[0]
        genome_seq = "".join(lines[1:]).replace(" ", "").upper().encode()

    # positioning.rs:16-95 keeps the first <=3 positions of every k-mer
    # (its overflow-delete branch is dead code: the push is guarded by
    # len<3), so the map is {kmer: first <=3 positions}, built with one
    # bulk encode and a stable sort. A genome shorter than k gives an
    # empty map, where no group finds a position.
    if len(genome_seq) < k:
        empty = np.zeros(0, np.uint64)
        return (_KmerMap(empty, None, np.zeros(0, np.int64),
                         np.zeros(0, np.int64), np.zeros(0, bool),
                         np.zeros(0, np.int64)),
                genome_seq, genome_name)
    s = np.frombuffer(genome_seq, dtype=np.uint8)
    L = len(s)
    n_win = L - k + 1
    codes = ((s >> 1) & 3).astype(np.uint64)
    invalid = ((s & 0xF) == 14).astype(np.int32)
    bad = np.cumsum(invalid)
    ok = (bad[k - 1 :] - np.concatenate([[0], bad[: n_win - 1]])) == 0

    hi = np.zeros(n_win, np.uint64) if k > 32 else None
    lo = np.zeros(n_win, np.uint64)
    for i in range(k):
        c = codes[i : i + n_win]
        if hi is not None:
            hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | c
    pos = np.arange(n_win, dtype=np.int64)[ok] + k  # stored as n + k
    if hi is None:
        enc = lo[ok]
        order = np.argsort(enc, kind="stable")
        enc_s, pos_s = enc[order], pos[order]
        first = np.ones(len(enc_s), bool)
        first[1:] = enc_s[1:] != enc_s[:-1]
    else:
        hi, lo = hi[ok], lo[ok]
        order = np.lexsort((lo, hi))
        hi_s, lo_s, pos_s = hi[order], lo[order], pos[order]
        first = np.ones(len(lo_s), bool)
        first[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    starts = np.flatnonzero(first)
    counts = np.empty(len(starts), np.int64)
    if len(starts):
        counts[:-1] = np.diff(starts)
        counts[-1] = len(pos_s) - starts[-1]
    # every k-mer keeps its first <=3 positions (genome order: the sorts
    # are stable)
    counts = np.minimum(counts, 3)
    keep_grp = np.ones(len(starts), bool)
    if hi is None:
        kmer_map = _KmerMap(enc_s[first], None, starts, counts, keep_grp, pos_s)
    else:
        kmer_map = _KmerMap(lo_s[first], hi_s[first], starts, counts, keep_grp, pos_s)
    return kmer_map, genome_seq, genome_name


class _KmerMap:
    """{kmer: [positions]} as sorted unique-k-mer arrays (lo, and hi for
    k > 32), each k-mer's run of positions in pos_s at starts[i] of
    length counts[i]; the C++ SNP stage searches them."""

    def __init__(self, lo, hi, starts, counts, keep, pos_s):
        self._lo = lo
        self._hi = hi
        self._starts = starts
        self._counts = counts
        self._keep = keep
        self._pos = pos_s
