"""Seeded bacterial genomes and MiSeq read pairs, written as FASTA and
FASTQ files.

A frozen copy of chip_smoke.py's ``make_cohort`` and ``make_reads`` with
their sizes taken from a configuration's ``inputs`` block, so that a
change to the program cannot move the benchmark's inputs. Every array is
drawn in bulk from one numpy generator per genome or read set; the same
seed gives the same bytes.
"""

import numpy as np

_COMP = bytes.maketrans(b"ACGTNRYKMSW", b"TGCANYRMKSW")


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for (seed, stream...): any whole seed, negative or
    wider than 64 bits included, maps to its own stream."""
    s = abs(int(seed))
    return np.random.default_rng([s & (2**64 - 1), s >> 64, int(seed) < 0,
                                  *stream])


def make_genomes(p: dict, n: int, seed: int):
    """n related genomes of p["genome_bases"] bases: one random base
    genome, then per genome SNPs at p["snp_rate"], p["indels"] short
    indels of 1..p["indel_max"] bases, one N run of p["n_run"] bases and
    p["iupac"] ambiguity letters. Records are a chromosome (the first
    p["chromosome_bases"] bases) and a plasmid (the rest). Returns a list
    of [chromosome, plasmid] uint8 arrays."""
    r = rng(seed, 0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(b"RYKMSW", np.uint8)
    base = r.choice(acgt, size=int(p["genome_bases"]))
    n_lo, n_hi = p["n_run"]
    out = []
    for _ in range(n):
        g = base.copy()
        snp = np.flatnonzero(r.random(len(g)) < p["snp_rate"])
        g[snp] = r.choice(acgt, size=len(snp))
        a = int(r.integers(0, len(g) - n_hi))
        g[a : a + int(r.integers(n_lo, n_hi))] = ord("N")
        g[r.integers(0, len(g), p["iupac"])] = r.choice(iupac, size=p["iupac"])
        for pos in np.sort(r.integers(0, len(g) - 20, p["indels"]))[::-1]:
            m = int(r.integers(1, p["indel_max"] + 1))
            if r.random() < 0.5:
                g = np.delete(g, np.arange(pos, pos + m))
            else:
                g = np.insert(g, pos, r.choice(acgt, size=m))
        cut = int(p["chromosome_bases"])
        out.append([g[:cut], g[cut:]])
    return out


def write_fasta(path: str, records, names=("chromosome", "plasmid")):
    with open(path, "wb") as f:
        for name, rec in zip(names, records):
            f.write(b">" + name.encode() + b"\n" + rec.tobytes() + b"\n")


def make_reads(records, p: dict, seed: int, index: int, prefix: str):
    """Paired-end reads of one genome, written as prefix_1.fastq and
    prefix_2.fastq: 2 x p["read_len"] from fragments of p["insert"]
    bases placed uniformly over the records at depth p["depth"], either
    strand first; substitutions at p["sub_rate"], N at p["n_rate"],
    PHRED+33 qualities 30-40 with p["low_qual_rate"] of bases at 2-19.
    index numbers the read set of one seed. Returns (fwd path, rev path)."""
    r = rng(seed, 1, index)
    read_len = int(p["read_len"])
    ins_lo, ins_hi = p["insert"]
    comp = np.frombuffer(bytes(range(256)).translate(_COMP), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = np.array([len(x) for x in records])
    genome = np.concatenate(records)
    n = int(p["depth"]) * int(lens.sum()) // (2 * read_len)
    rec = r.choice(len(records), size=n, p=lens / lens.sum())
    ins = r.integers(ins_lo, ins_hi + 1, size=n)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])[rec] + (
        r.random(n) * (lens[rec] - ins + 1)).astype(np.int64)
    cols = np.arange(read_len)
    r1 = genome[start[:, None] + cols]
    r2 = comp[genome[(start + ins - read_len)[:, None] + cols][:, ::-1]]
    swap = r.random(n) < 0.5
    r1, r2 = np.where(swap[:, None], r2, r1), np.where(swap[:, None], r1, r2)
    digits = ((np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10
              + ord("0")).astype(np.uint8)
    paths = []
    for mate, x in ((1, r1), (2, r2)):
        sub = r.random(x.shape) < p["sub_rate"]
        x[sub] = acgt[r.integers(0, 4, size=int(sub.sum()))]
        x[r.random(x.shape) < p["n_rate"]] = ord("N")
        q = r.integers(33 + 30, 33 + 41, size=x.shape, dtype=np.uint8)
        low = r.random(x.shape) < p["low_qual_rate"]
        q[low] = r.integers(33 + 2, 33 + 20, size=int(low.sum()), dtype=np.uint8)

        def const(b):
            return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

        rows = np.concatenate([const(b"@r"), digits, const(b"/%d\n" % mate), x,
                               const(b"\n+\n"), q, const(b"\n")], axis=1)
        path = f"{prefix}_{mate}.fastq"
        with open(path, "wb") as f:
            f.write(rows.tobytes())
        paths.append(path)
    return paths[0], paths[1]

