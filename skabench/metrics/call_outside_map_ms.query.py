"""call_outside_map_ms.query: the part of a browser-mapper call outside
map's spans, ms per call: each call's span (skabench::job) less the
spans ska::lookup, ska::gather and ska::pseudoalign in it. That is the
per-sample build (webapi.py: sample.build_sample, merge.merge_samples)
with the FASTA read, the JSON document and the card's last wait around
it; the program has no span around the per-sample build itself."""

MAP_SPANS = ("ska::lookup", "ska::gather", "ska::pseudoalign")


def read(trace, run):
    if not run["jobs"] or not trace.named(MAP_SPANS):
        return None
    return 1e3 * trace.self_s(("skabench::job",), MAP_SPANS) / run["jobs"]
