"""Input kind ``assemblies``: a cohort of FASTA assemblies and, where the
configuration asks for one, one more genome of the same generator as a
map reference outside the cohort."""

import os

from skabench.gen import genomes


def make(cfg: dict, workdir: str, seed: int) -> dict:
    p = cfg["inputs"]
    n = int(cfg["samples"])
    extra = 1 if p.get("map_reference") else 0
    gs = genomes.make_genomes(p, n + extra, seed)
    samples = []
    for i, records in enumerate(gs):
        path = os.path.join(workdir, f"genome{i:02d}.fa")
        genomes.write_fasta(path, records)
        samples.append((f"genome{i:02d}", path, None))
    k = int(cfg["build"]["k"])
    cohort = gs[:n]
    return {
        "samples": samples[:n],
        "file_list": None,
        "map_reference": samples[n][1] if extra else None,
        "windows": sum(max(0, len(r) - k + 1) for g in cohort for r in g),
        "bases": sum(len(r) for g in cohort for r in g),
    }
