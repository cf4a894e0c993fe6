"""call_self_ms.query: the browser front end's own work in a call
(webapi.py SkaData.map: the JSON document, the chunks of the
pseudoalignment, checks): self time of the span ska::call, that is the
call outside the build's, the merge's and map's spans, ms per call."""


def read(trace, run):
    names = ('ska::call',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
