"""The card's peaks and the least work of the measured kernels: a
frozen copy of chip_smoke.py's constants and its ``lookup_bound``."""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def lookup_bound(W, N, M):
    """Least time for one lookup: each key and query read once and each
    int64 answer written once at the card's memory rate, against the
    M * ceil(log2(N + 1)) comparisons of W words a search makes at the
    card's non-tensor rate; the larger wins."""
    t_bytes = (8 * W * (N + M) + 8 * M) / HBM_BYTES_PER_S
    t_ops = M * max(1, N.bit_length()) * W / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def key_words(k):
    """64-bit words of a split k-mer's key, as upstream types it: u64 to
    k = 31, u128 to k = 63."""
    return 1 if k <= 31 else 2


def build_pass_bytes(bases, rows, W, samples):
    """Least bytes of one build's device pass: every input base read
    once (one byte each) and every merged row written once (W key words
    and one byte a sample)."""
    return bases + rows * (8 * W + samples)
