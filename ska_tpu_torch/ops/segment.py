"""Sort + segment counting for `ska cov` (port of what the port uses of
ska_tpu/ops/segment.py): the reference's counting hashmap
(coverage.rs:104-135) becomes a sort of the split k-mer keys and
segment lengths. Invalid rows carry an all-ones sentinel key, which
sorts last."""

import torch

from .pipeline import _SENT, _sort_limbs, _starts


def count_histogram(wkeys, emit, max_count: int):
    """Histogram of per-key occurrence counts: bin[c-1] = number of
    distinct emitted keys seen exactly c times, for c-1 < max_count
    (coverage.rs:156-174). wkeys (L, W) int64 limbs, emit (L,) bool."""
    L = wkeys.shape[0]
    skeys = _sort_limbs(torch.where(emit[:, None], wkeys, _SENT)[None])[0][0]
    first = _starts(skeys[None])[0]
    ids = torch.cumsum(first, dim=0) - 1
    counts = torch.bincount(ids, minlength=L)
    # emitted keys are never all-ones, so they are the segments before
    # the sentinels'
    n_unique = int((first & (skeys != _SENT).any(dim=-1)).sum())
    kc = (counts[:n_unique] - 1).clamp(0, max_count)  # overflow bin dropped
    return torch.bincount(kc, minlength=max_count + 1)[:max_count]
