"""`ska distance`: pairwise SNP distances from one class Gram on the
device (the port of ska_tpu/distance.py).

The reference walks every site per sample pair (merge_ska_array.rs:587-632,
rayon over columns :416-438). Per-site contributions depend only on the
pair of 16 base-set classes (gap, A, C, ..., N), so all pair statistics
are linear functionals of the class co-occurrence counts
G[i*16+a, j*16+b] = #sites(sample i class a, sample j class b), computed
exactly as a one-hot Gram matrix.

The JAX package computes that Gram with ``jax.lax.dot_general`` outside
any Pallas kernel; here it is a plain matrix product, ``torch._int_mm``
of the int8 one-hot (int32 sums, exact at any scale). ``class_gram`` is
the JAX package's accelerator branch on an explicit device without its
row dedupe (see class_gram); its CPU route is the same torch functions
on CPU tensors.

``class_gram`` runs in the span ``ska::gram`` (the class compaction,
the chunk copies, the int8 products and the copy back), in ``ska
distance`` and in the browser aligner (webapi.py AlignData) alike. Its
counters (``torchinit.gram_counts``, zeroed with the launch counters):
``gram_calls``, the calls; ``gram_chunks``, the int8 products;
``gram_row_count``, the site rows they took, tail padding included;
``gram_onehot_width``, the widest one-hot's columns; and
``gram_onehot_bytes``, the one-hot bytes made, chunk rows x columns
summed over the chunks.
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from .encoding import ASCII_TO_SET, BASE_PROB, SET_TO_ASCII
from .torchinit import get_device

# One-hot scratch budget per Gram chunk (bytes); module-level so tests
# can shrink it to drive several chunks with small data.
GRAM_SCRATCH_BYTES = 1 << 28

gram_calls = 0
gram_chunks = 0
gram_row_count = 0
gram_onehot_width = 0
gram_onehot_bytes = 0


def _onehot_cols(n: int, width: int) -> int:
    """The one-hot's columns: n * width rounded up to a multiple of 8 and
    at least 24 (torch._int_mm on CUDA takes more than 16 rows and sizes
    that are multiples of 8)."""
    return max(24, -(-(n * width) // 8) * 8)


@dataclass
class VariantDist:
    distance: float
    mismatch_prop: float
    match_count: int
    mismatch_count: int

    def __str__(self):
        # reference Display: "{:.2}\t{:.5}\t{}\t{}" (merge_ska_array.rs:57-65)
        return (
            f"{self.distance:.2f}\t{self.mismatch_prop:.5f}"
            f"\t{self.match_count}\t{self.mismatch_count}"
        )


def _class_tables(filt_ambig: bool):
    """16x16 f64 coefficient tables for distance / match / mismatch."""
    probs = BASE_PROB[SET_TO_ASCII]  # (16, 4), class 0 = '-' (zero vector)
    overlap = probs @ probs.T  # (16, 16)
    nz = np.arange(16) > 0
    both = np.outer(nz, nz)
    one_gap = np.outer(~nz, nz) | np.outer(nz, ~nz)

    if filt_ambig:
        unamb = np.isin(np.arange(16), [1, 2, 4, 8])
        bu = np.outer(unamb, unamb)
        dist = (bu & (np.arange(16)[:, None] != np.arange(16)[None, :])).astype(np.float64)
        match = bu.astype(np.float64)
    else:
        dist = np.where(both, 1.0 - overlap, 0.0)
        match = (both & (overlap > 0.0)).astype(np.float64)
    mism = one_gap.astype(np.float64)
    return dist, match, mism


def gram_chunk(classes_chunk, n: int, width: int = 16):
    """classes_chunk: (C, n) int8 tensor in [0, width), C a multiple of
    8. Returns the (n*width, n*width) int32 Gram of the int8 one-hot
    (torch._int_mm: int32 sums, exact). The one-hot has P = n * width
    columns rounded up to a multiple of 8 and at least 24 (torch._int_mm
    on CUDA takes more than 16 rows and sizes that are multiples of 8);
    the extra columns are zero and sliced off."""
    C = classes_chunk.shape[0]
    P = _onehot_cols(n, width)
    X = torch.zeros((C, P), dtype=torch.int8, device=classes_chunk.device)
    cols = (torch.arange(n, device=classes_chunk.device) * width
            + classes_chunk.to(torch.int64))
    X.scatter_(1, cols, 1)
    G = torch._int_mm(X.t().contiguous(), X)
    return G[: n * width, : n * width]


def compact_classes(variants: np.ndarray):
    """Map the 16 IUPAC classes to the ones present (typically 5-6),
    pick the one-hot width bucket, and choose the tail-pad class.

    Returns (compact (S, n) int8, present int8[K], K, width, pad_class).
    """
    classes = ASCII_TO_SET[variants].astype(np.int8)
    # one linear pass (np.unique would sort all S*n elements)
    present = np.flatnonzero(
        np.bincount(classes.ravel().astype(np.int64), minlength=16)
    ).astype(np.int8)
    K = len(present)
    # keep one slot > K free for tail padding unless class 0 ('-', zero
    # weight in every coefficient table) exists
    width = next(w for w in (4, 8, 16) if w >= K)
    if K == width and 0 not in present:
        width = 16 if width == 8 else 8
    lut = np.zeros(16, np.int8)
    lut[present] = np.arange(K, dtype=np.int8)
    compact = lut[classes].astype(np.int8)
    # tail padding: a discarded slot, or class 0 when K == width
    pad_class = K if K < width else int(lut[0])
    return compact, present, K, width, pad_class


def scatter_gram_16(Gc: np.ndarray, present: np.ndarray, K: int, width: int,
                    n: int) -> np.ndarray:
    """Scatter compact-class Gram counts back to 16-class coordinates."""
    G = np.zeros((n, 16, n, 16), dtype=np.int64)
    Gc4 = Gc.reshape(n, width, n, width)[:, :K, :, :K]
    pres = present.astype(np.int64)
    G[np.ix_(np.arange(n), pres, np.arange(n), pres)] = Gc4
    return G.reshape(n * 16, n * 16)


def class_gram(variants: np.ndarray, device=None) -> np.ndarray:
    """Exact int64 co-occurrence Gram over 16 classes. variants: (S, n)
    uint8; the products run on `device`.

    The one-hot width is compacted to the classes present, as in the JAX
    package, and gram_rows sums the int8 chunk Grams; one copy brings the
    total back. The JAX package dedupes rows on the host first and runs
    a weighted f32 product below 2^24 sites, to shrink its transfers to
    the TPU; on the card that host dedupe costs more than the whole int8
    Gram (chip_smoke.py phase 8 times both), so every size takes this
    route. In a process group (parallel.use_distributed) the sites are
    cut over the ranks (parallel/postbuild.py). All of it runs in the
    span ``ska::gram``.
    """
    global gram_calls
    from .parallel import use_distributed

    dev = get_device(device)
    with record_function("ska::gram"):
        gram_calls += 1
        if use_distributed(dev):
            from .parallel.postbuild import distributed_class_gram

            return distributed_class_gram(variants, dev)
        n = variants.shape[1]
        compact, present, K, width, pad_class = compact_classes(variants)
        Gc = gram_rows(compact, n, width, pad_class, K == width, dev)
        return scatter_gram_16(Gc.cpu().numpy(), present, K, width, n)


def gram_rows(compact: np.ndarray, n: int, width: int, pad_class: int,
              pad_is_class: bool, dev) -> torch.Tensor:
    """The (n*width, n*width) int64 Gram of compact (S, n) class rows on
    `dev`: chunks of powers of two rows, at least 1024 and at most 2^24,
    the tail padded by pad_class; each chunk is one int8 product
    (gram_chunk) and the chunk Grams sum on the device in int64. When the
    pad is a real class (pad_is_class: class 0, '-', when no slot is
    free), its counts are taken back out."""
    global gram_chunks, gram_row_count, gram_onehot_width, gram_onehot_bytes
    S = compact.shape[0]
    # bound the one-hot scratch and keep chunks powers of two, at least
    # 1024 rows and no larger than the bucket that holds the data
    chunk = max(1 << 10, min(1 << 24, GRAM_SCRATCH_BYTES // max(width * n, 1)))
    chunk = min(chunk, max(1 << 10, 1 << int(np.ceil(np.log2(max(S, 1))))))
    chunk = 1 << int(np.floor(np.log2(chunk)))
    Gc = torch.zeros((n * width, n * width), dtype=torch.int64, device=dev)
    n_chunks = -(-S // chunk)
    P = _onehot_cols(n, width)
    gram_chunks += n_chunks
    gram_row_count += n_chunks * chunk
    gram_onehot_width = max(gram_onehot_width, P)
    gram_onehot_bytes += n_chunks * chunk * P
    bar = None
    if n_chunks > 1:  # merge_ska_array.rs:421 distance progress analog
        from .progress import Bar

        bar = Bar(n_chunks, "site chunks")
    for s0 in range(0, S, chunk):
        c = compact[s0 : s0 + chunk]
        npad = chunk - len(c)
        if npad:
            c = np.concatenate([c, np.full((npad, n), pad_class, np.int8)])
        Gc += gram_chunk(torch.from_numpy(c).to(dev), n, width)
        if bar:
            bar.update()
    if bar:
        bar.finish()
    if pad_is_class:
        # each padding row added 1 to [i, pad, j, pad] for every sample
        # pair: subtract it
        Gc.view(n, width, n, width)[:, pad_class, :, pad_class] -= (
            n_chunks * chunk - S)
    return Gc


def pairwise_stats(variants: np.ndarray, constant: float, filt_ambig: bool,
                   device=None):
    """Upper-triangle list-of-lists of VariantDist, same layout as the
    reference distance() (merge_ska_array.rs:416-438)."""
    n = variants.shape[1]
    G = class_gram(variants, device).reshape(n, 16, n, 16).astype(np.float64)
    dist_c, match_c, mism_c = _class_tables(filt_ambig)

    D = np.einsum("iajb,ab->ij", G, dist_c)
    M = np.einsum("iajb,ab->ij", G, match_c)
    X = np.einsum("iajb,ab->ij", G, mism_c)

    out = []
    for i in range(n):
        row = []
        for j in range(i + 1, n):
            matches = constant + M[i, j]
            mism = X[i, j]
            denom = matches + mism
            prop = (mism / denom) if denom != 0.0 else 0.0
            row.append(
                VariantDist(
                    distance=float(D[i, j]),
                    mismatch_prop=float(prop),
                    match_count=int(matches),
                    mismatch_count=int(mism),
                )
            )
        out.append(row)
    return out
