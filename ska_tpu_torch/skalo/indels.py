"""Indel dereplication, extraction and VCF output
(reference src/skalo/process_indels.rs); the port's copy of
ska_tpu/skalo/indels.py."""

import logging
from typing import Dict, List, Set, Tuple

from .kmer_utils import encode_str, popcount, rev_comp_int

log = logging.getLogger("ska_tpu_torch.skalo")


def dereplicate_indels(indel_groups, k_graph):
    """process_indels.rs:142-184: shortest total length first, stable
    tie-break on the entry k-mer int; skip groups whose entry k-mer was
    already claimed."""
    entries_indels: Set[int] = set()
    final_indels: Dict[Tuple[int, int], List] = {}

    sorted_ext = sorted(
        (
            (key, sum(len(v.sequence) for v in variants))
            for key, variants in indel_groups.items()
        ),
        key=lambda kv: (kv[1], kv[0][0]),
    )

    for (combined_ext, _total) in sorted_ext:
        vec_variants = indel_groups[combined_ext]
        if combined_ext[0] not in entries_indels:
            rc1 = rev_comp_int(combined_ext[0], k_graph)
            rc2 = rev_comp_int(combined_ext[1], k_graph)
            entries_indels.add(combined_ext[0])
            entries_indels.add(rc1)
            entries_indels.add(combined_ext[1])
            entries_indels.add(rc2)
            final_indels[combined_ext] = vec_variants

    return final_indels, entries_indels


def extract_middle_bases(vec_variants, k_graph):
    """process_indels.rs:187-246: trim the longest common suffix to find
    the last k-mer; the remainder after the first k-mer is the insert."""
    reduced_seq = [v.sequence[k_graph:] for v in vec_variants]

    identical = True
    n_nucl = 0
    while identical:
        n_nucl += 1
        all_ends = set()
        for seq in reduced_seq:
            if n_nucl > len(seq):
                identical = False
            else:
                all_ends.add(seq[len(seq) - n_nucl :])
        if len(all_ends) > 1:
            identical = False
    n_nucl -= 1

    pos_end = len(reduced_seq[0]) - n_nucl
    last_kmer = reduced_seq[0][pos_end:]
    if len(last_kmer) > k_graph:
        last_kmer = last_kmer[:k_graph]

    vec_middles = []
    for seq in reduced_seq:
        middle = seq[: len(seq) - n_nucl]
        vec_middles.append(middle if middle else "-")
    return vec_middles, last_kmer


def process_indels(indel_groups, kmer_samples, config, k_graph, sample_names):
    """process_indels.rs:15-138: write {out}_indels.vcf, return indel entry
    k-mers for SNP dedup."""
    log.info("Processing indels")
    final_indels, entries_indels = dereplicate_indels(indel_groups, k_graph)

    vcf_filename = f"{config.output_name}_indels.vcf"
    nb_indels = 0
    with open(vcf_filename, "w") as w:
        w.write("##fileformat=VCFv4.2\n")
        w.write("# REF corresponds to the most frequent variant among samples\n")
        w.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(sample_names)
            + "\n"
        )

        for vec_variants in final_indels.values():
            bitset_vec = []
            for variant in vec_variants:
                enc = encode_str(variant.sequence[: k_graph + 1])
                if enc in kmer_samples:
                    bitset_vec.append(kmer_samples[enc])

            missing_samples = 0
            ref_present = False
            alt_present = False
            for i in range(len(sample_names)):
                in_ref = bool(bitset_vec[0] >> i & 1)
                in_alt = bool(bitset_vec[1] >> i & 1)
                if not in_ref and not in_alt:
                    missing_samples += 1
                elif in_ref and in_alt:
                    missing_samples += 1  # heterozygous calls count as missing
                elif in_ref:
                    ref_present = True
                else:
                    alt_present = True

            proportion_missing = missing_samples / len(sample_names)
            if proportion_missing <= config.max_missing and ref_present and alt_present:
                nb_indels += 1
                vec_inserts, last_kmer = extract_middle_bases(vec_variants, k_graph)
                first_kmer = vec_variants[0].sequence[:k_graph]

                variants = sorted(
                    (
                        (seq, popcount(bs), bs)
                        for seq, bs in zip(vec_inserts, bitset_vec)
                    ),
                    key=lambda t: -t[1],
                )
                ref_allele, _rc, ref_bitset = variants[0]
                alt_allele, _ac, alt_bitset = variants[1]

                calls = []
                for i in range(len(sample_names)):
                    in_ref = bool(ref_bitset >> i & 1)
                    in_alt = bool(alt_bitset >> i & 1)
                    if in_ref and in_alt:
                        calls.append("0/1")
                    elif in_ref:
                        calls.append("0")
                    elif in_alt:
                        calls.append("1")
                    else:
                        calls.append(".")

                w.write(
                    f".\t.\t.\t{ref_allele}\t{alt_allele}\t.\t"
                    f"before={first_kmer};after={last_kmer}\t.\tGT\t"
                    + "\t".join(calls)
                    + "\n"
                )

    log.info("%d indels", nb_indels)
    return entries_indels
