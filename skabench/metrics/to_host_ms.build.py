"""to_host_ms.build: copies: self time of the spans ska::to_host and
ska::to_device, ms per job."""


def read(trace, run):
    names = ('ska::to_host', 'ska::to_device')
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
