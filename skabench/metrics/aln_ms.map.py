"""aln_ms.map: map's aln writer (ref.py write_aln, the FASTA records of
the pseudoalignment): self time of the span ska::aln, ms per job."""


def read(trace, run):
    names = ('ska::aln',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
