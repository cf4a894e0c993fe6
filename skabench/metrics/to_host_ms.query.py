"""to_host_ms.query: copies of a browser call's sample build (sample.py
_run_batch: to(dev), .cpu() and unpack_host): self time of the spans
ska::to_host and ska::to_device, ms per call."""


def read(trace, run):
    names = ('ska::to_host', 'ska::to_device')
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
