"""Split k-mers in plain NumPy, worked out from ska.rust's rules
(src/ska_dict/split_kmer.rs, bit_encoding.rs, ska_dict.rs,
bloom_filter.rs), independent of the program under test.

- A base is valid unless its low nibble is 14 (N, n); the separator
  byte 0 between records is invalid too. A base's 2-bit code is
  ``(ascii >> 1) & 3``: A 0, C 1, T 2, G 3, so its complement is code ^ 2.
- A window of k bases is emitted when all k are valid; the last window
  of a record only when the base before it is valid as well (upstream
  reaches that window by rolling, never by a fresh start).
- The split k-mer is the window without its middle base: 2(k-1) bits,
  first base highest. With both strands it is the smaller of the
  forward and the reverse-complement key, the middle base complemented
  with it; a key equal to its own reverse complement (a palindrome)
  carries both the middle base and its complement.
- Middle bases are kept as 4-bit sets (bit 1 A, 2 C, 4 T, 8 G) and
  united per key; the IUPAC letter of a set is its upstream letter.
- Reads: with qualities under the strict filter a base counts as valid
  only above min_qual, and under the middle or strict filter the middle
  base must pass too; with min_count > 1 a key's middle base is kept
  when its whole k-mer (middle base included, canonical over strands)
  occurs at least min_count times.

Keys here are numpy uint64 (k <= 31). ``fingerprint`` is the control's
shortcut: split k-mers compared by a 32-bit fingerprint, as a hash
table keyed by 32 bits would compare them.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the IUPAC letter of each 4-bit base set; 0 (no base) is the gap '-'
_SETS = {"A": 1, "C": 2, "T": 4, "G": 8}
_IUPAC = {"-": "", "A": "A", "C": "C", "G": "G", "T": "T", "M": "AC",
          "R": "AG", "W": "AT", "S": "CG", "Y": "CT", "K": "GT", "V": "ACG",
          "H": "ACT", "D": "AGT", "B": "CGT", "N": "ACGT"}
LETTER = np.zeros(16, np.uint8)
for _letter, _bases in _IUPAC.items():
    LETTER[sum(_SETS[b] for b in _bases)] = ord(_letter)
# the complement of each letter (A<->T, C<->G); '-' stays '-'
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _letter, _bases in _IUPAC.items():
    _comp = sum(_SETS[{"A": "T", "T": "A", "C": "G", "G": "C"}[b]] for b in _bases)
    COMPLEMENT[ord(_letter)] = LETTER[_comp]

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_FLIP = np.uint64(0xAAAAAAAAAAAAAAAA)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def read_fasta(path: str):
    """[(first word of the header, uint8 bases)] of every record."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for block in data.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        out.append((head.split()[0].decode() if head.split() else "",
                    np.frombuffer(seq, np.uint8)))
    return out


def read_fastq(path: str):
    """(sequences, qualities) of a FASTQ file of 4-line records."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    n = len(lines) // 4
    return ([x.rstrip(b"\r") for x in lines[1 : 4 * n : 4]],
            [x.rstrip(b"\r") for x in lines[3 : 4 * n : 4]])


def flat(seqs):
    """Records joined by one 0 byte: (bases, last base of each record,
    start offset of each record)."""
    seqs = [bytes(s) for s in seqs]
    bases = np.frombuffer(b"\x00".join(seqs), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]]).astype(np.int64)
    rec_last = np.zeros(len(bases), bool)
    rec_last[(starts + lens - 1)[lens > 0]] = True
    return bases, rec_last, starts


def base_ok(bases):
    return ((bases & 0xF) != 14) & (bases != 0)


def _pack(c, n: int, reverse: bool):
    """For every start i, the n codes c[i..i+n) packed 2 bits each, the
    first highest (reverse: the last highest), by doubling."""
    acc, acc_len = None, 0
    cur, cur_len = c, 1
    m = n
    while m:
        if m & 1:
            if acc is None:
                acc, acc_len = cur, cur_len
            else:
                L = len(c) - acc_len - cur_len + 1
                if reverse:
                    acc = (cur[acc_len : acc_len + L] << np.uint64(2 * acc_len)) | acc[:L]
                else:
                    acc = (acc[:L] << np.uint64(2 * cur_len)) | cur[acc_len : acc_len + L]
                acc_len += cur_len
        m >>= 1
        if m:
            L = len(c) - 2 * cur_len + 1
            if reverse:
                cur = (cur[cur_len : cur_len + L] << np.uint64(2 * cur_len)) | cur[:L]
            else:
                cur = (cur[:L] << np.uint64(2 * cur_len)) | cur[cur_len : cur_len + L]
            cur_len *= 2
    return acc


def windows(bases, rec_last, valid, k: int):
    """(emitted, forward whole k-mer, reverse-complement whole k-mer) of
    every window start of the flat bases."""
    if not 5 <= k <= 31 or k % 2 == 0:
        raise ValueError(f"the reference handles odd k in 5..31, not {k}")
    T = len(bases)
    n = T - k + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return np.zeros(0, bool), z, z
    bad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int64)])
    all_valid = bad[k : k + n] == bad[:n]
    prev_valid = np.zeros(n, bool)
    prev_valid[1:] = valid[: n - 1]
    emit = all_valid & (~rec_last[k - 1 : k - 1 + n] | prev_valid)
    c = ((bases >> 1) & 3).astype(np.uint64)
    return emit, _pack(c, k, False), _pack(c ^ np.uint64(2), k, True)


def rc_bits(x, n: int):
    """Reverse complement of n 2-bit codes packed in uint64 x."""
    x = x ^ _FLIP
    x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
    return x.byteswap() >> np.uint64(64 - 2 * n)


def split_of_whole(w, k: int, rc: bool):
    """(split key, base set, reverse strand) of whole k-mers w."""
    h = (k - 1) // 2
    left = w >> np.uint64(2 * (h + 1))
    mid = ((w >> np.uint64(2 * h)) & np.uint64(3)).astype(np.uint8)
    right = w & np.uint64((1 << (2 * h)) - 1)
    fwd = (left << np.uint64(2 * h)) | right
    if not rc:
        return fwd, (np.uint8(1) << mid), np.zeros(len(w), bool)
    r = rc_bits(fwd, k - 1)
    swap = fwd > r
    mid = np.where(swap, mid ^ 2, mid).astype(np.uint8)
    sets = (np.uint8(1) << mid) | np.where(fwd == r, np.uint8(1) << (mid ^ 2), 0)
    return np.where(swap, r, fwd), sets.astype(np.uint8), swap


def unique(a, counts: bool = False):
    """Sorted unique values of a (and how often each occurs), by a sort:
    numpy's own unique hashes large arrays, which is slow."""
    s = np.sort(a)
    first = np.ones(len(s), bool)
    first[1:] = s[1:] != s[:-1]
    if not counts:
        return s[first]
    starts = np.flatnonzero(first)
    return s[first], np.diff(np.append(starts, len(s)))


def fingerprint(keys):
    """The control's 32-bit fingerprint of each key."""
    return (keys * _GOLDEN) >> np.uint64(32)


def group_or(keys, sets):
    """Sorted unique keys, each with the union of its sets."""
    comb = unique((keys << np.uint64(4)) | sets.astype(np.uint64))
    ukeys = comb >> np.uint64(4)
    first = np.ones(len(comb), bool)
    first[1:] = ukeys[1:] != ukeys[:-1]
    starts = np.flatnonzero(first)
    if len(comb) == 0:
        return ukeys, np.zeros(0, np.uint8)
    return ukeys[starts], np.bitwise_or.reduceat(
        (comb & np.uint64(15)).astype(np.uint8), starts)


def sample_dict(seqs, k: int, rc: bool = True, quals=None, min_qual: int = 0,
                qual_filter: str = "strict", min_count: int = 1):
    """(sorted keys, base sets) of one sample: the records of a FASTA
    sample, or the reads of a FASTQ sample (forward file, then reverse
    file) with their qualities."""
    bases, rec_last, _ = flat(seqs)
    valid = base_ok(bases)
    h = (k - 1) // 2
    reads = quals is not None
    if reads:
        qual = np.frombuffer(b"\x00".join(bytes(q) for q in quals), np.uint8)
        qual_ok = (qual.astype(np.int16) - 33) > min_qual
        if qual_filter == "strict":
            valid &= qual_ok
    emit, wf, wr = windows(bases, rec_last, valid, k)
    if reads and qual_filter in ("middle", "strict"):
        emit &= qual_ok[h : h + len(emit)]
    whole = (np.minimum(wf, wr) if rc else wf)[emit]
    del wf, wr
    if reads and min_count > 1:
        u, counts = unique(whole, counts=True)
        whole = u[counts >= min_count]
    else:
        whole = unique(whole)
    keys, sets, _ = split_of_whole(whole, k, rc)
    return group_or(keys, sets)


def merge(samples, control: bool = False):
    """The merged array of [(keys, sets)] samples: sorted unique keys,
    the (rows, samples) letters with '-' where a sample lacks the key,
    and each row's count of samples present. The control merges by
    fingerprint: keys with one fingerprint share a row."""
    views = [fingerprint(k) if control else k for k, _ in samples]
    rows = unique(np.concatenate(views))
    variants = np.full((len(rows), len(samples)), ord("-"), np.uint8)
    keys = rows.copy()

    def place(s):
        k, sets = samples[s]
        idx = np.searchsorted(rows, views[s])
        variants[idx, s] = LETTER[sets]
        if control:
            keys[idx] = k

    with ThreadPoolExecutor(8) as pool:  # numpy drops the GIL
        list(pool.map(place, range(len(samples))))
    counts = (variants != ord("-")).sum(axis=1).astype(np.int64)
    return keys, variants, counts


def ref_windows(seqs, k: int, rc: bool = True):
    """The reference's split k-mers in positional order: (keys, reverse
    strand, record index, position of the middle base in its record)."""
    bases, rec_last, starts = flat(seqs)
    emit, wf, _ = windows(bases, rec_last, base_ok(bases), k)
    s = np.flatnonzero(emit)
    keys, _, is_rc = split_of_whole(wf[s], k, rc)
    rec = np.searchsorted(starts, s, side="right") - 1
    return keys, is_rc, rec, s - starts[rec] + (k - 1) // 2


def lookup(table, queries, control: bool = False):
    """(found, row) of each query in the sorted table keys; the queries
    are searched in sorted order, which keeps the search in cache."""
    if control:
        fp = fingerprint(table)
        order = np.argsort(fp, kind="stable")
        table, queries = fp[order], fingerprint(queries)
    q_order = np.argsort(queries)
    idx = np.empty(len(queries), np.int64)
    idx[q_order] = np.searchsorted(table, queries[q_order])
    idx = np.minimum(idx, max(len(table) - 1, 0))
    found = (table[idx] == queries) if len(table) else np.zeros(len(queries), bool)
    return found, (order[idx] if control else idx)
