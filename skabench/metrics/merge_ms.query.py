"""merge_ms.query: the host merge of a browser call's sample into an
array (merge.py merge_samples): self time of the span ska::merge, ms
per call."""


def read(trace, run):
    names = ('ska::merge',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
