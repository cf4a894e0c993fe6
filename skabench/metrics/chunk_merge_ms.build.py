"""chunk_merge_ms.build: chunked count merge (sample.py,
dict_from_batch_chunked): self time of the span ska::chunk_merge, the
host merge of a chunked sample's parts after its last chunk (whole-k-mer
totals, the min-count threshold, the sort by split key and the union of
middle bases), ms per job. A program without the span reads nothing."""


def read(trace, run):
    names = ('ska::chunk_merge',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
