"""parse_ms.query: host parse and staging of a browser call's sample
(sample.py build_sample, _run_batch; io/fastx.py): self time of the
spans ska::parse and ska::stage, ms per call."""


def read(trace, run):
    names = ('ska::parse', 'ska::stage')
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
