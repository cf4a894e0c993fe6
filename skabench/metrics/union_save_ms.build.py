"""union_save_ms.build: host union and save (merge.py, io/skf.py, cli.py):
self time of the spans ska::union and ska::save, ms per job."""


def read(trace, run):
    names = ('ska::union', 'ska::save')
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
