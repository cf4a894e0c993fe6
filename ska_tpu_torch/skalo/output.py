"""skalo output files (reference src/skalo/output_snps.rs), the port's
copy of ska_tpu/skalo/output.py: {out}_snps.fas, and with a reference
genome also {out}_pseudo_genomes.fas and {out}_snps.vcf."""

from typing import Dict, List

import numpy as np

_KEEP = b"ATGCN"


def create_fasta_and_vcf(
    genome_name: str,
    genome_seq: bytes,
    sample_names: List[str],
    variant_map: Dict[int, List[str]],
    config,
):
    # non-ATGCN -> N (output_snps.rs:18-23), via a 256-entry table
    if genome_seq:
        tbl = np.full(256, ord("N"), dtype=np.uint8)
        for b in _KEEP:
            tbl[b] = b
        garr = tbl[np.frombuffer(genome_seq, dtype=np.uint8)]
    else:
        garr = None

    sorted_map = sorted(variant_map.items())
    # with a genome, positions past its end are never reached by the
    # reference's position scan and drop out of every output (the vote
    # arithmetic wraps mod 2^32, so huge positions can occur)
    if garr is not None:
        sorted_map = [(p, ch) for p, ch in sorted_map if p < len(garr)]

    n_samples = len(sample_names)
    if sorted_map:
        positions = np.array([p for p, _ in sorted_map], dtype=np.int64)
        chars = np.frombuffer(
            "".join("".join(ch) for _, ch in sorted_map).encode(), dtype=np.uint8
        ).reshape(len(sorted_map), n_samples)
    else:
        positions = np.empty(0, dtype=np.int64)
        chars = np.empty((0, n_samples), dtype=np.uint8)

    with open(f"{config.output_name}_snps.fas", "w") as f:
        for i, name in enumerate(sample_names):
            f.write(f">{name}\n{chars[:, i].tobytes().decode()}\n")

    if genome_seq:
        # pseudo-genome per sample: the sanitized genome with each SNP
        # position overwritten by that sample's base
        with open(f"{config.output_name}_pseudo_genomes.fas", "w") as f:
            for i, name in enumerate(sample_names):
                g2 = garr.copy()
                g2[positions] = chars[:, i]
                f.write(f">{name}\n{g2.tobytes().decode()}\n")

        with open(f"{config.output_name}_snps.vcf", "w") as f:
            f.write("##fileformat=VCFv4.2\n")
            f.write(
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(sample_names)
                + "\n"
            )
            for pos, ch in sorted_map:
                ref_base = chr(garr[pos])
                alt_bases = []
                for c in ch:  # first-occurrence order (dedup)
                    if c != ref_base and c not in "-N" and c not in alt_bases:
                        alt_bases.append(c)
                gts = []
                for c in ch:
                    if c == ref_base:
                        gts.append("0")
                    elif c in "-N":
                        gts.append(".")
                    elif c in alt_bases:
                        gts.append(str(alt_bases.index(c) + 1))
                    else:
                        gts.append(".")
                f.write(
                    f"{genome_name}\t{pos + 1}\t.\t{ref_base}\t"
                    + ",".join(alt_bases)
                    + "\t.\t.\t.\tGT\t"
                    + "\t".join(gts)
                    + "\n"
                )
