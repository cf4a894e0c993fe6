"""Input kind ``reads``: one MiSeq read pair per genome of the
assemblies generator, and the samples.tsv that ``ska build -f`` reads."""

import os

from skabench.gen import genomes


def make(cfg: dict, workdir: str, seed: int) -> dict:
    p = cfg["inputs"]
    n = int(cfg["samples"])
    k = int(cfg["build"]["k"])
    read_len = int(p["read_len"])
    samples, windows, bases = [], 0, 0
    for i, records in enumerate(genomes.make_genomes(p, n, seed)):
        name = f"genome{i:02d}"
        fwd, rev = genomes.make_reads(records, p, seed, i,
                                      os.path.join(workdir, name))
        samples.append((name, fwd, rev))
        pairs = int(p["depth"]) * sum(len(r) for r in records) // (2 * read_len)
        windows += 2 * pairs * max(0, read_len - k + 1)
        bases += 2 * pairs * read_len
    tsv = os.path.join(workdir, "samples.tsv")
    with open(tsv, "w") as f:
        f.writelines(f"{a}\t{b}\t{c}\n" for a, b, c in samples)
    return {"samples": samples, "file_list": tsv, "map_reference": None,
            "windows": windows, "bases": bases}
