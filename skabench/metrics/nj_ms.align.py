"""nj_ms.align: neighbour joining of a browser align call's distance
matrix (webapi.py neighbor_joining): the whole span ska::nj, ms per
call. A program without the span reads nothing."""


def read(trace, run):
    names = ('ska::nj',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names, ()) / run["jobs"]
