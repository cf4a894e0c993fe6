"""gram_ms.align: the class Gram of a browser align call's SNP distances
(distance.py class_gram: the class compaction on the host, the chunk
copies, the int8 one-hot products and the copy back): the whole span
ska::gram, ms per call. A program without the span reads nothing."""


def read(trace, run):
    names = ('ska::gram',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names, ()) / run["jobs"]
