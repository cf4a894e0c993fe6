"""device_pass_ms.query: the device pass of a browser call's sample
(ops/pipeline.py batched_from_raw over B1, ops/sort.py): self time of
the span ska::device_pass, ms per call."""


def read(trace, run):
    names = ('ska::device_pass',)
    if not trace.named(names) or not run["jobs"]:
        return None
    return 1e3 * trace.self_s(names) / run["jobs"]
