"""Plain reference of ``ska map`` and of the browser mapper: the
reference's split k-mers looked up in a table of keys, each sample's
pseudoalignment, and the VCF and JSON written from them.

Upstream's alignment writer (src/ska_ref/aln_writer.rs) fills, for every
split k-mer of the reference that a sample has, the k-1 flanking bases
from the reference and the middle base from the sample (complemented
for a reverse-strand match); bases no match covers are '-'. So a base is
covered when it lies within (k-1)/2 of a matched middle base.
"""

import json

import numpy as np

from . import kmers as R

_GAP = ord("-")
# VCF allele of a byte: A, C, G or T, else N
_ALLELE = [chr(b) if chr(b) in "ACGT" else "N" for b in range(256)]
_CODE = np.array(["ACGTN".index(a) for a in _ALLELE], np.uint8)


class Reference:
    """A reference FASTA and its split k-mers in positional order."""

    def __init__(self, path: str, k: int, rc: bool = True):
        recs = R.read_fasta(path)
        self.k, self.h = k, (k - 1) // 2
        self.names = [n for n, _ in recs]
        self.lens = np.array([len(s) for _, s in recs], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lens)[:-1]]).astype(np.int64)
        self.seq = np.concatenate([s for _, s in recs]) if recs else np.zeros(0, np.uint8)
        keys, self.is_rc, rec, pos = R.ref_windows([s for _, s in recs], k, rc)
        self.keys = keys
        self.where = self.offsets[rec] + pos  # middle base in self.seq

    def match(self, table, control: bool = False):
        """(found, row) of each of the reference's split k-mers."""
        return R.lookup(table, self.keys, control)

    def alignment(self, found, letters):
        """One sample's pseudoalignment: letters (one per found k-mer,
        '-' where the sample lacks it), reverse-strand ones complemented."""
        letters = np.where(self.is_rc[found], R.COMPLEMENT[letters], letters)
        g = self.where[found]
        keep = letters != _GAP
        g, letters = g[keep], letters[keep]
        T = len(self.seq)
        edge = (np.bincount(g - self.h, minlength=T + 1)[: T + 1]
                - np.bincount(g + self.h + 1, minlength=T + 2)[: T + 1])
        out = np.where(np.cumsum(edge)[:T] > 0, self.seq, _GAP).astype(np.uint8)
        out[g] = letters
        return out


def vcf(ref: Reference, names, table, variants, control: bool = False) -> str:
    """The VCF of `ska map -f vcf` of a merged array against ref."""
    found, rows = ref.match(table, control)
    aln = np.stack([ref.alignment(found, variants[rows[found], s])
                    for s in range(variants.shape[1])])
    out = ["##fileformat=VCFv4.4\n"]
    out += [f"##contig=<ID={c}>\n" for c in ref.names]
    out.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(names) + "\n")
    cols = np.flatnonzero((aln != ref.seq[None, :]).any(axis=0))
    rec = np.searchsorted(ref.offsets, cols, side="right") - 1
    for line in _records(ref, cols, rec, aln[:, cols].T):
        out.append(line)
    return "".join(out)


def _records(ref: Reference, cols, rec, A):
    """The VCF records of variant columns cols, A (columns, samples) the
    samples' bases there. A sample's genotype is 0 where its base is the
    reference's byte, '.' for a gap, else the 1-based index of its allele
    (A, C, G, T, or N for any other letter) among the column's alleles in
    order of first appearance across the samples."""
    n, S = A.shape
    rb = ref.seq[cols]
    allele = _CODE[A]  # 0-4: A C G T N
    alt = (A != rb[:, None]) & (A != _GAP)
    first = np.full((n, 5), S, np.int64)
    for a in range(5):
        hit = alt & (allele == a)
        first[:, a] = np.where(hit.any(axis=1), hit.argmax(axis=1), S)
    order = np.argsort(first, axis=1, kind="stable")
    rank = np.empty_like(order)
    rank[np.arange(n)[:, None], order] = np.arange(5)
    gt = np.where(alt, np.take_along_axis(rank, allele.astype(np.int64), axis=1)
                  + ord("1"), np.where(A == _GAP, ord("."), ord("0")))
    fields = np.full((n, 2 * S), ord("\t"), np.uint8)
    fields[:, 0::2] = gt
    fields[:, -1] = ord("\n")
    gts = fields.tobytes().decode("ascii")
    width = 2 * S
    n_alt = (first < S).sum(axis=1)
    for j in range(n):
        alts = ",".join("ACGTN"[a] for a in order[j, : n_alt[j]]) or "."
        r = rec[j]
        yield (f"{ref.names[r]}\t{cols[j] - ref.offsets[r] + 1}\t.\t"
               f"{_ALLELE[rb[j]]}\t{alts}\t.\t.\t.\tGT\t"
               + gts[j * width : (j + 1) * width])


def query_json(ref: Reference, keys, sets, control: bool = False) -> str:
    """The JSON document of one browser-mapper call (upstream
    lib.rs:1041-1098) for a sample of (keys, sets)."""
    found, rows = ref.match(keys, control)
    aln = ref.alignment(found, R.LETTER[sets[rows[found]]]).tobytes().decode("latin-1")
    chunks = [aln[o : o + n] for o, n in zip(ref.offsets.tolist(), ref.lens.tolist())]
    return json.dumps({"Mapped sequences": chunks,
                       "Number of variants": int(np.count_nonzero(found)),
                       "Coverage": (len(aln) - aln.count("-")) / len(aln)
                       if aln else 0.0})


def lines_differing(want: str, got: str) -> int:
    """Lines of got that differ from want, position by position, plus
    the lines one has beyond the other."""
    a, b = want.splitlines(True), got.splitlines(True)
    return max(len(a), len(b)) - sum(x == y for x, y in zip(a, b))
