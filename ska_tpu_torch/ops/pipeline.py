"""Whole-batch merged FASTA build on the device (port of the merged path
of ska_tpu/ops/pipeline.py).

One batch of S samples becomes the merged split k-mer array in one pass:
extraction, then ONE global sort by (key, sample id) carrying the IUPAC
set (the port's radix kernel on a card), then segment starts by
cummax, the per-(key, sample) IUPAC OR by masked doubling, row ids by
cumsum, and three scatters into the keys, the 4-bit-packed variants
matrix and the counts. Only the FASTA branch is ported; FASTQ input
(count filter, quality gates) is ROADMAP A8.
"""

import numpy as np
import torch

from ..encoding import SET_TO_ASCII
from . import extract as X
from . import sort as SO

_SENT = -1  # all-ones uint64 limb


def _seg_start_idx(first):
    i32 = torch.arange(first.shape[0], dtype=torch.int32, device=first.device)
    return torch.cummax(torch.where(first, i32, -1), dim=0).values


def _seg_union(vals, ssi):
    """OR within each sorted segment via masked doubling (log2 L passes)."""
    L = vals.shape[0]
    i32 = torch.arange(L, dtype=torch.int32, device=vals.device)
    v = vals
    d = 1
    while d < L:
        shifted = torch.zeros_like(v)
        shifted[d:] = v[:-d]
        v = torch.where((i32 - d) >= ssi, v | shifted, v)
        d <<= 1
    return v


def _merged_impl(codes, valid, rec_last, k: int, rc: bool, W: int):
    """Whole-batch build + merge of (S, L) 2-bit codes (FASTA only).

    Returns
      ukeys     (S*L, W) int64 merged keys, rows [0, n_rows) valid
      variants4 (S*L, ceil(S/2)) uint8, two 4-bit IUPAC set codes per byte
                (gap = 0)
      counts    (S*L,) int32 samples present per row
      n_rows    int32 scalar tensor
    """
    S, L = codes.shape
    N = S * L
    if N * S + 1 > 0x7FFFFFFF:
        # the JAX package's guard (its variants scatter uses int32
        # indices); kept so that batch limits and outputs stay the same
        raise ValueError(
            f"merged build batch too large: {S} samples x {L} padded "
            f"bases needs a {N}x{S} variants scatter (> int32 index "
            f"space); lower SKA_MAX_BATCH so that S*S*L <= 2^31"
        )
    dev = codes.device
    res = X.extract_windows(codes, valid, rec_last, k, rc, W, from_codes=True)
    emit = res["emit"].reshape(N)
    mid = res["mid"]
    sets = (1 << mid) | torch.where(res["pal"], 1 << (mid ^ 2), 0)  # uint8

    # ---- global merge across samples: one sort by (key, sample id) ----
    sid = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(L)
    kf = res["key"].reshape(N, W)
    kf = torch.where(emit[:, None], kf, _SENT)
    sf = torch.where(emit, sets.reshape(N), 0)
    # the sort is stable, though nothing here needs it: rows with equal
    # (key, sid) differ only in their set, and the sets of a group are ORed
    ops = tuple(kf[:, i].contiguous() for i in range(W)) + (sid, sf)
    gres = SO.sort_ops(ops, num_keys=W + 1)
    gk = torch.stack(gres[:W], dim=-1)
    gsid, gsets = gres[W], gres[W + 1]

    live = (gk != _SENT).any(dim=-1)
    diff_key = torch.ones(N, dtype=torch.bool, device=dev)
    diff_key[1:] = (gk[1:] != gk[:-1]).any(dim=-1)
    first_pair = diff_key.clone()
    first_pair[1:] |= gsid[1:] != gsid[:-1]

    # IUPAC union within each (key, sample) group
    union = _seg_union(gsets, _seg_start_idx(first_pair))
    pair_end = torch.ones_like(first_pair)
    pair_end[:-1] = first_pair[1:]

    newrow = diff_key & live
    rowcum = torch.cumsum(newrow, dim=0)  # int64
    rows = rowcum - 1
    n_rows = rowcum[-1].to(torch.int32)

    # scatters: every non-selected row writes to the dump slot (N*S or
    # N), which is cut off; selected indices are unique, so index_put_'s
    # order among repeated indices only ever touches the dump slot
    sel = pair_end & live
    pos = torch.where(sel, rows * S + gsid, N * S)
    variants = torch.zeros(N * S + 1, dtype=torch.uint8, device=dev)
    variants.index_put_((pos,), torch.where(sel, union, 0))
    variants = variants[: N * S].reshape(N, S)
    if S % 2:
        variants = torch.nn.functional.pad(variants, (0, 1))
    variants4 = (variants[:, 0::2] << 4) | variants[:, 1::2]

    krows = torch.where(newrow, rows, N)
    ukeys = torch.zeros((N + 1, W), dtype=torch.int64, device=dev)
    ukeys.index_put_((krows,), torch.where(newrow[:, None], gk, 0))
    counts = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(sel, rows, N), sel.to(torch.int32))
    return ukeys[:N], variants4, counts[:N], n_rows


def unpack_codes(seq2):
    """(S, ceil(L/4)) uint8 of 2-bit codes (4/byte, first base in bits
    7-6) -> (S, 4*ceil(L/4)) uint8 code array; the inverse of
    ska_tpu.sample._stage_packed's packing."""
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.uint8, device=seq2.device)
    return ((seq2[:, :, None] >> shifts) & 3).reshape(seq2.shape[0], -1)


def _unpack_bits(bits, L):
    """(S, ceil(L/8)) packed bools (np.packbits order) -> (S, L) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> shifts) & 1
    return b.reshape(bits.shape[0], -1)[:, :L].bool()


def merged_build_from_packed(
    seq2, valid_bits, qual_bits, rec_ends,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int, strict_valid: bool, has_qual: bool,
):
    """The merged build fed by the packed staging arrays of
    ska_tpu.sample._stage_packed (as tensors on the build's device):
    seq2 (S, Lp/4) uint8 2-bit codes, valid_bits (S, Lp/8) uint8 base
    validity, qual_bits quality-pass bits, rec_ends (S, E) int32
    record-final positions (>= Lp = padding). The quality arguments
    keep the JAX signature; they matter only for FASTQ (ROADMAP A8).

    Returns (ukeys, variants4, counts, n_rows) as _merged_impl."""
    if is_reads:
        raise NotImplementedError(
            "FASTQ builds (count filter, quality gates) are not ported yet: "
            "ROADMAP A8"
        )
    codes = unpack_codes(seq2)
    S, L = codes.shape
    valid = _unpack_bits(valid_bits, L)  # FASTA: base validity alone
    rec_last = torch.zeros((S, L + 1), dtype=torch.bool, device=codes.device)
    row = torch.arange(S, device=codes.device)[:, None].expand(rec_ends.shape)
    rec_last[row, rec_ends.clamp(max=L).long()] = True
    return _merged_impl(codes, valid, rec_last[:, :L], k, rc, W)


def unpack_variants4(vp: np.ndarray, n_cols: int) -> np.ndarray:
    """Host-side inverse of the packed variants layout:
    (n, ceil(S/2)) two 4-bit codes per byte -> (n, n_cols) ASCII."""
    v = np.empty((vp.shape[0], vp.shape[1] * 2), np.uint8)
    v[:, 0::2] = vp >> 4
    v[:, 1::2] = vp & 15
    return np.asarray(SET_TO_ASCII)[v[:, :n_cols]]
