"""Sharded `ska map` lookup and `ska distance` Gram (port of
ska_tpu/parallel/postbuild.py).

* distributed_lookup: the merged array's sorted keys are cut into D
  consecutive row blocks (key ranges); each rank routes its block of
  queries to the rank that owns their key range with one
  all_to_all_single, looks them up in its own block
  (keys.lower_bound, the lookup kernel on a card), and sends the
  answers home by the inverse exchange.
* distributed_class_gram: the sites are cut into D blocks; each rank
  sums the int8 chunk Grams of its block in int64 (distance.gram_rows)
  and one int64 all_reduce adds the ranks up. The JAX package's host row
  dedupe and weighted f32 psum have no counterpart (ROADMAP C2): no
  float product is on this path.
"""

import numpy as np
import torch

from .. import distance as DIST
from ..ops import keys as K
from ..torchinit import get_device
from . import comm

_SENT = -1  # all-ones key limb


def _block(x, rank, n):
    return x[rank * n : (rank + 1) * n]


def distributed_lookup(sorted_keys, queries, device=None):
    """Lower-bound lookup of queries in a globally sorted key array, cut
    into key ranges over the ranks. Every rank passes the same arrays
    ((R, W) and (Q, W) uint64, or 1-D at W=1). Returns (found bool (Q,),
    global rows int64 (Q,), -1 at a miss) on every rank, as the serial
    keys.lower_bound plus the equality check of RefSka.map."""
    dev = get_device(device)
    D, rank = comm.world()
    sorted_keys = np.asarray(sorted_keys, dtype=np.uint64)
    queries = np.asarray(queries, dtype=np.uint64)
    if sorted_keys.ndim == 1:
        sorted_keys = sorted_keys[:, None]
    if queries.ndim == 1:
        queries = queries[:, None]
    R, W = sorted_keys.shape
    Q = queries.shape[0]
    Rb, Qb = -(-R // D), -(-Q // D)
    keys_blk = K.from_numpy_keys(_block(sorted_keys, rank, Rb), dev)
    q = K.from_numpy_keys(_block(queries, rank, Qb), dev)
    n_keys = keys_blk.shape[0]

    # 1. every rank's block-start key; an empty block starts at all-ones
    start = keys_blk[:1] if n_keys else torch.full((1, W), _SENT, device=dev)
    starts = comm.all_gather(start)  # (D, W), ascending
    # 2. destination: the last block that starts at or below the query
    #    (D is small: a dense limb compare)
    le = ~K.greater(starts[None, :, :], q[:, None, :])
    dest = (le.sum(dim=1) - 1).clamp(min=0)
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=D).tolist()
    recv = comm.exchange_counts(send, dev)
    rq = comm.exchange(q[order], send, recv)

    # 3. the local lookup, global rows or -1
    grow = torch.full((rq.shape[0],), -1, dtype=torch.int64, device=dev)
    if n_keys and rq.shape[0]:
        idx = K.lower_bound(keys_blk, rq).clamp_(0, n_keys - 1)
        grow = torch.where(K.equal(keys_blk[idx], rq), rank * Rb + idx, grow)

    # 4. answers home by the inverse exchange, back into query order; the
    #    query blocks are consecutive, so one gather puts them in order
    back = comm.exchange(grow, recv, send)
    rows = torch.empty(q.shape[0], dtype=torch.int64, device=dev)
    rows[order] = back
    sizes = [len(_block(queries, r, Qb)) for r in range(D)]
    rows = comm.all_gather_rows(rows, sizes).cpu().numpy()
    return rows >= 0, rows


def distributed_class_gram(variants: np.ndarray, device=None) -> np.ndarray:
    """Exact int64 16-class co-occurrence Gram, the sites cut over the
    ranks; equal to distance.class_gram. Every rank passes the same
    (S, n) variants and gets the Gram."""
    dev = get_device(device)
    D, rank = comm.world()
    S, n = variants.shape
    compact, present, Kp, width, pad_class = DIST.compact_classes(variants)
    Gc = DIST.gram_rows(_block(compact, rank, -(-S // D)), n, width,
                        pad_class, Kp == width, dev)
    Gc = comm.all_reduce_sum(Gc)
    return DIST.scatter_gram_16(Gc.cpu().numpy(), present, Kp, width, n)
