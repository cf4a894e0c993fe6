"""Split k-mer window extraction over a batch of samples (port of
ska_tpu/ops/extract.py).

The JAX function takes one sample and is vmapped by its callers; here the
(S, L) sample axis is written out and every window-axis shift runs along
dim 1. The emission rules are the JAX package's (split_kmer.rs:78-217):

- a window is emitted iff all k bases are valid;
- the final window of a record is reachable only by rolling, so it is
  also conditioned on the previous base being valid.
"""

import torch

from . import keys as K


def _shift_left_arr(a, s: int):
    """a[:, i] <- a[:, i+s] along the window axis, zero-filled at the end."""
    if s == 0:
        return a
    out = torch.zeros_like(a)
    if s < a.shape[1]:
        out[:, : a.shape[1] - s] = a[:, s:]
    return out


def window_all(valid, n: int):
    """out[:, i] = AND of valid[:, i..i+n) (False out of range), via
    O(log n) shift-doubling passes."""
    cur, cur_len = valid, 1
    acc, acc_len = None, 0
    nn = n
    while nn:
        if nn & 1:
            if acc is None:
                acc, acc_len = cur, cur_len
            else:
                acc = acc & _shift_left_arr(cur, acc_len)
                acc_len += cur_len
        nn >>= 1
        if nn:
            cur = cur & _shift_left_arr(cur, cur_len)
            cur_len *= 2
    return acc if acc is not None else torch.ones_like(valid)


def pack_n(codes_limbs, n: int):
    """codes_limbs: (S, L, W) int64 with the 2-bit code in the low bits.

    Returns P: (S, L, W) where P[:, i] = bases i..i+n packed with the
    first base in the highest 2-bit group, zero-filled out of range.
    O(log n) doubling passes.
    """
    cur, cur_len = codes_limbs, 1
    acc, acc_len = None, 0
    nn = n
    while nn:
        if nn & 1:
            if acc is None:
                acc, acc_len = cur, cur_len
            else:
                acc = K.shl(acc, 2 * cur_len) | _shift_left_arr(cur, acc_len)
                acc_len += cur_len
        nn >>= 1
        if nn:
            cur = K.shl(cur, 2 * cur_len) | _shift_left_arr(cur, cur_len)
            cur_len *= 2
    return acc if acc is not None else torch.zeros_like(codes_limbs)


def extract_windows(seq, valid, rec_last, k: int, rc: bool, W: int,
                    want_whole: bool = False):
    """All split k-mer windows of an (S, L) batch of flat record batches.

    seq: uint8 (S, L) ASCII; valid: bool (S, L) base validity; rec_last:
    bool (S, L) marks each record's final base. Returns a dict of
    per-window-start tensors:
      key   (S, L, W) int64 canonical packed split k-mer
      mid   uint8 (S, L) 2-bit middle base code (canonical orientation)
      is_rc bool (S, L) canonical is the reverse complement
      pal   bool (S, L) key is its own reverse complement
      emit  bool (S, L) window emitted
      whole (S, L, W) canonical packed whole k-mer (if want_whole)
    """
    S, L = seq.shape
    h = (k - 1) // 2
    codes = ((seq >> 1) & 3).to(torch.int64)
    codes_limbs = torch.zeros((S, L, W), dtype=torch.int64, device=seq.device)
    codes_limbs[..., W - 1] = codes

    in_range = torch.arange(L, device=seq.device) + k <= L
    # last-window-of-record rule: emitted only if the previous base is valid
    is_final_window = _shift_left_arr(rec_last, k - 1)
    prev_valid = torch.zeros_like(valid)
    prev_valid[:, 1:] = valid[:, :-1]
    emit = window_all(valid, k) & in_range & (~is_final_window | prev_valid)

    ph = pack_n(codes_limbs, h)
    lower = _shift_left_arr(ph, h + 1)
    key = K.shl(ph, 2 * h) | lower
    mid = _shift_left_arr(codes, h).to(torch.uint8)

    if rc:
        rkey = K.rev_comp(key, k - 1)
        swap = K.greater(key, rkey)
        pal = K.equal(key, rkey)
        ckey = torch.where(swap[..., None], rkey, key)
        cmid = torch.where(swap, mid ^ 2, mid)
    else:
        ckey, cmid = key, mid
        swap = torch.zeros_like(emit)
        pal = torch.zeros_like(emit)

    out = {"key": ckey, "mid": cmid, "is_rc": swap, "pal": pal, "emit": emit}
    if want_whole:
        mid_limbs = torch.zeros_like(codes_limbs)
        mid_limbs[..., W - 1] = _shift_left_arr(codes, h)
        whole = K.shl(ph, 2 * (h + 1)) | K.shl(mid_limbs, 2 * h) | lower
        if rc:
            rwhole = K.rev_comp(whole, k)
            whole = torch.where(K.greater(whole, rwhole)[..., None], rwhole, whole)
        out["whole"] = whole
    return out
