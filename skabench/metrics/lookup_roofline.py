"""lookup_roofline: map's lookup at its bound (peaks.lookup_bound: the
table's N keys and the reference's M split k-mers, both counted by the
reference) over the device time of the kernels launched in the span
ska::lookup, in %."""

from skabench.peaks import lookup_bound


def read(trace, run):
    kernels = trace.kernels_in(("ska::lookup",))
    st = run["stats"]
    if not kernels or not run["jobs"] or "table_keys" not in st:
        return None
    device_ms = sum(b - a for _, _, a, b, _ in kernels) / 1e3
    bound_ms, _ = lookup_bound(st["W"], st["table_keys"], st["queries"])
    return 100.0 * run["jobs"] * bound_ms / device_ms
