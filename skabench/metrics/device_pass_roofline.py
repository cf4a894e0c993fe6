"""device_pass_roofline: the least bytes of a build's device pass at the
card's memory rate, over the device time of the kernels launched in the
span ska::device_pass, in %. The least bytes are every input base read
once and every merged row written once (peaks.build_pass_bytes), from
the generated inputs and the reference's row count, not from the
program's padding."""

from skabench.peaks import HBM_BYTES_PER_S, build_pass_bytes


def read(trace, run):
    kernels = trace.kernels_in(("ska::device_pass",))
    st = run["stats"]
    if not kernels or not run["jobs"] or "rows" not in st:
        return None
    device_s = sum(b - a for _, _, a, b, _ in kernels) / 1e6
    least_s = run["jobs"] * build_pass_bytes(
        run["inputs"]["bases"], st["rows"], st["W"], st["samples"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
