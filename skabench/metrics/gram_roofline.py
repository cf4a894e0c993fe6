"""gram_roofline: the least bytes of a call's class Gram at the card's
memory rate, over the device time of the kernels launched in the span
ska::gram, in %. The least bytes (gram_bytes) are the (rows x samples)
class matrix read once, a byte a cell, and the (16 samples)^2 int64
Gram written once, from the reference's row and sample counts: the
same work whatever computes the Gram, not the program's one-hot or its
padding. A program without the span, or a run without the reference's
counts, reads nothing."""

from skabench.peaks import HBM_BYTES_PER_S


def gram_bytes(rows, samples):
    """Least bytes of one class Gram of a (rows, samples) matrix: every
    class read once and every int64 count of the 16-class Gram written
    once."""
    return rows * samples + 8 * (16 * samples) ** 2


def read(trace, run):
    kernels = trace.kernels_in(("ska::gram",))
    st = run["stats"]
    if not kernels or not run["jobs"] or "rows" not in st:
        return None
    device_s = sum(b - a for _, _, a, b, _ in kernels) / 1e6
    least_s = run["jobs"] * gram_bytes(st["rows"], st["samples"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
