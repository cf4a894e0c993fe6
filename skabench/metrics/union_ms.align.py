"""union_ms.align: the host union of a browser align call's merged
batches, and of earlier calls' batches in a session (api.py assemble:
merge.py extend_arrays over the host library, the input column order
restored): self time of the span ska::union, ms per call. A program
whose aligner merges without the span reads nothing."""


def read(trace, run):
    names = ('ska::union',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
