"""doc_ms.align: a browser align call's document (webapi.py AlignData:
the unfiltered alignment's FASTA records, array.py write_fasta, and the
JSON text): the whole span ska::doc, ms per call. A program without the
span reads nothing."""


def read(trace, run):
    names = ('ska::doc',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names, ()) / run["jobs"]
