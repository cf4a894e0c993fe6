"""vcf_ms.map: map's VCF writer (ref.py write_vcf): self time of the span
ska::vcf, ms per job."""


def read(trace, run):
    names = ('ska::vcf',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
