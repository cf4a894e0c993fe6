"""Split k-mers of any odd k from 5 to 63 in plain NumPy, with 128-bit
keys: the rules of kmers.py's docstring (ska.rust's split_kmer.rs,
bit_encoding.rs, ska_dict.rs), worked out again for two 64-bit limbs,
independent of the program under test.

- A key is an (n, 2) uint64 array of limbs, (hi, lo): the split k-mer's
  2(k-1) bits, first base highest, right-aligned in 128 bits, so that at
  k <= 31 the high limb is 0 and the low limb is kmers.py's key. Keys are
  compared lexicographically, hi first, which is upstream's u128 order.
- A whole k-mer of 2k bits (126 at k = 63) is packed by kmers._pack's
  shift-doubling in two parts: its first k - 32 bases in the high limb
  and its last 32 (all k bases when k <= 32) in the low one. Its reverse
  complement packs the complemented codes with the last base highest in
  the same two parts.
- The reverse complement of a split key complements and reverses the 64
  codes of both limbs, swaps the limbs, and shifts right by 128 - 2(k-1)
  bits; the canonical key is the smaller of the two, and a palindrome
  (the key equal to its reverse complement) carries both the middle base
  and its complement.
- Reads, qualities, the count filter over whole k-mers canonical over
  strands, ``group_or`` (the union of a key's base sets) and the merge of
  samples follow kmers.py with these keys.

Departures from upstream, none of which moves a key, a set or a row:
keys are sorted (by lo, then stably by hi), not held in a hash map;
a FASTA sample's windows are not made unique as whole k-mers before they
are split (``group_or`` unites them after); the merge sorts all samples'
(key, sample) pairs once instead of inserting sample by sample.

``fingerprint`` is the control's shortcut: a 32-bit fingerprint of both
limbs, as a hash table keyed by 32 bits would tell keys apart.
"""

import numpy as np

from . import kmers as R

_U64 = np.uint64
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX = np.uint64(0xC2B2AE3D27D4EB4F)


def check_k(k: int):
    if not 5 <= k <= 63 or k % 2 == 0:
        raise ValueError(f"the wide reference handles odd k in 5..63, not {k}")


def _shr(hi, lo, s: int):
    """(hi, lo) >> s for 0 <= s < 128."""
    if s == 0:
        return hi, lo
    if s >= 64:
        return np.zeros_like(hi), hi >> _U64(s - 64)
    return hi >> _U64(s), (lo >> _U64(s)) | (hi << _U64(64 - s))


def _shl(hi, lo, s: int):
    """(hi, lo) << s for 0 <= s < 128, bits past 128 dropped."""
    if s == 0:
        return hi, lo
    if s >= 64:
        return lo << _U64(s - 64), np.zeros_like(lo)
    return (hi << _U64(s)) | (lo >> _U64(64 - s)), lo << _U64(s)


def _low(hi, lo, bits: int):
    """The low `bits` bits of (hi, lo), 0 <= bits < 128."""
    if bits >= 64:
        return hi & _U64((1 << (bits - 64)) - 1), lo
    return np.zeros_like(hi), lo & _U64((1 << bits) - 1)


def greater(ahi, alo, bhi, blo):
    return (ahi > bhi) | ((ahi == bhi) & (alo > blo))


def stack(hi, lo):
    """(n, 2) uint64 keys of two limb arrays."""
    return np.stack([hi, lo], axis=1) if len(hi) else np.zeros((0, 2), np.uint64)


def order(hi, lo):
    """The permutation that sorts keys (hi, lo) lexicographically: by lo,
    then stably by hi (numpy's lexsort takes about 1.7 times as long)."""
    o = np.argsort(lo)
    return o[np.argsort(hi[o], kind="stable")]


def windows(bases, rec_last, valid, k: int):
    """(emitted, forward whole k-mer (hi, lo), reverse-complement whole
    k-mer (hi, lo)) of every window start of the flat bases."""
    check_k(k)
    n = len(bases) - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return np.zeros(0, bool), (z, z), (z, z)
    bad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int64)])
    all_valid = bad[k : k + n] == bad[:n]
    prev_valid = np.zeros(n, bool)
    prev_valid[1:] = valid[: n - 1]
    emit = all_valid & (~rec_last[k - 1 : k - 1 + n] | prev_valid)
    c = ((bases >> 1) & 3).astype(np.uint64)
    cc = c ^ _U64(2)
    nl = min(k, 32)
    nh = k - nl
    f_lo = R._pack(c, nl, False)[nh : nh + n]
    r_lo = R._pack(cc, nl, True)[:n]
    if nh:
        f_hi = R._pack(c, nh, False)[:n]
        r_hi = R._pack(cc, nh, True)[k - nh : k - nh + n]
    else:
        f_hi = r_hi = np.zeros(n, np.uint64)
    return emit, (f_hi, f_lo), (r_hi, r_lo)


def rc_bits(hi, lo, n: int):
    """Reverse complement of n 2-bit codes packed in (hi, lo)."""
    return _shr(R.rc_bits(lo, 32), R.rc_bits(hi, 32), 128 - 2 * n)


def split_of_whole(hi, lo, k: int, rc: bool):
    """((split key hi, lo), base set, reverse strand) of whole k-mers."""
    h = (k - 1) // 2
    left = _shr(hi, lo, 2 * (h + 1))
    mid = (_shr(hi, lo, 2 * h)[1] & _U64(3)).astype(np.uint8)
    right = _low(hi, lo, 2 * h)
    up = _shl(*left, 2 * h)
    fh, fl = up[0] | right[0], up[1] | right[1]
    if not rc:
        return (fh, fl), (np.uint8(1) << mid), np.zeros(len(hi), bool)
    rh, rl = rc_bits(fh, fl, k - 1)
    swap = greater(fh, fl, rh, rl)
    pal = (fh == rh) & (fl == rl)
    mid = np.where(swap, mid ^ 2, mid).astype(np.uint8)
    sets = (np.uint8(1) << mid) | np.where(pal, np.uint8(1) << (mid ^ 2), 0)
    return ((np.where(swap, rh, fh), np.where(swap, rl, fl)),
            sets.astype(np.uint8), swap)


def unique(hi, lo, counts: bool = False):
    """Sorted unique keys (and how often each occurs)."""
    o = order(hi, lo)
    hi, lo = hi[o], lo[o]
    first = np.ones(len(hi), bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    if not counts:
        return hi[first], lo[first]
    starts = np.flatnonzero(first)
    return hi[first], lo[first], np.diff(np.append(starts, len(hi)))


def fingerprint(keys):
    """The control's 32-bit fingerprint of each (n, 2) key."""
    return (((keys[:, 0] * _MIX) ^ keys[:, 1]) * _GOLDEN) >> _U64(32)


def group_or(hi, lo, sets):
    """Sorted unique keys as (n, 2), each with the union of its sets."""
    if len(hi) == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint8)
    o = order(hi, lo)
    hi, lo, sets = hi[o], lo[o], sets[o]
    first = np.ones(len(hi), bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = np.flatnonzero(first)
    return stack(hi[starts], lo[starts]), np.bitwise_or.reduceat(sets, starts)


def sample_dict(seqs, k: int, rc: bool = True, quals=None, min_qual: int = 0,
                qual_filter: str = "strict", min_count: int = 1):
    """((n, 2) sorted keys, base sets) of one sample, as
    kmers.sample_dict."""
    bases, rec_last, _ = R.flat(seqs)
    valid = R.base_ok(bases)
    h = (k - 1) // 2
    reads = quals is not None
    if reads:
        qual = np.frombuffer(b"\x00".join(bytes(q) for q in quals), np.uint8)
        qual_ok = (qual.astype(np.int16) - 33) > min_qual
        if qual_filter == "strict":
            valid &= qual_ok
    emit, (fh, fl), (rh, rl) = windows(bases, rec_last, valid, k)
    if reads and qual_filter in ("middle", "strict"):
        emit &= qual_ok[h : h + len(emit)]
    if rc:
        swap = greater(fh, fl, rh, rl)
        hi, lo = np.where(swap, rh, fh)[emit], np.where(swap, rl, fl)[emit]
    else:
        hi, lo = fh[emit], fl[emit]
    del fh, fl, rh, rl
    if reads and min_count > 1:
        hi, lo, counts = unique(hi, lo, counts=True)
        hi, lo = hi[counts >= min_count], lo[counts >= min_count]
    (kh, kl), sets, _ = split_of_whole(hi, lo, k, rc)
    return group_or(kh, kl, sets)


def merge(samples, control: bool = False):
    """The merged array of [((n, 2) keys, sets)] samples: sorted unique
    keys (rows, 2), the (rows, samples) letters with '-' where a sample
    lacks the key, and each row's count of samples present. The control
    merges by fingerprint: keys with one fingerprint share a row, which
    holds one of their keys."""
    S = len(samples)
    keys = (np.concatenate([k for k, _ in samples]) if samples
            else np.zeros((0, 2), np.uint64))
    sets = (np.concatenate([s for _, s in samples]) if samples
            else np.zeros(0, np.uint8))
    sid = np.repeat(np.arange(S), [len(k) for k, _ in samples])
    if control:
        fp = fingerprint(keys)
        o = np.argsort(fp, kind="stable")
        first = np.ones(len(o), bool)
        first[1:] = fp[o][1:] != fp[o][:-1]
    else:
        o = order(keys[:, 0], keys[:, 1])
        sk = keys[o]
        first = np.ones(len(o), bool)
        first[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    row = np.cumsum(first) - 1
    variants = np.full((int(first.sum()), S), ord("-"), np.uint8)
    variants[row, sid[o]] = R.LETTER[sets[o]]
    counts = (variants != ord("-")).sum(axis=1).astype(np.int64)
    return keys[o[first]], variants, counts

