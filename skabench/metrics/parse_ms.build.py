"""parse_ms.build: host parse and staging (sample.py, io/fastx.py): self
time of the spans ska::parse and ska::stage, ms per job."""


def read(trace, run):
    names = ('ska::parse', 'ska::stage')
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
