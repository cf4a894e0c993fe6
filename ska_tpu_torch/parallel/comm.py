"""The collectives of the sharded paths, over the default process group.

Without a joined group every function acts as a group of one rank (the
identity), so the sharded functions also run in a single process. With
a group, even of one rank, the real collective runs: on NCCL its
tensors must lie on this rank's card, on gloo on the CPU.
"""

import warnings

import torch
import torch.distributed as dist


def joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def world():
    """(world size, rank); (1, 0) without a group."""
    if joined():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def all_gather(x):
    """Every rank's (n, ...) x, concatenated in rank order: (D * n, ...).
    All ranks pass the same shape."""
    if not joined():
        return x
    out = x.new_empty((dist.get_world_size() * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # torch 2.13 renames it all_gather_single; the card's torch has
        # only this name
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous())
    return out


def all_gather_rows(x, sizes):
    """Every rank's (sizes[rank], ...) x, concatenated in rank order: the
    blocks are padded to the largest for one all_gather and cut back."""
    m = max(sizes)
    pad = x.new_zeros((m,) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    g = all_gather(pad)
    return torch.cat([g[r * m : r * m + n] for r, n in enumerate(sizes)])


def exchange_counts(send, device):
    """The all_to_all of the split sizes: send[j] rows go to rank j;
    returns recv, recv[j] rows come from rank j."""
    if not joined():
        return list(send)
    s = torch.tensor(send, dtype=torch.int64, device=device)
    r = torch.empty_like(s)
    dist.all_to_all_single(r, s)
    return r.tolist()


def exchange(x, send, recv):
    """all_to_all of the rows of x, grouped by destination rank (send[j]
    rows for rank j); returns the received rows grouped by source rank.
    NCCL has no bool: send bool data as uint8."""
    if not joined():
        return x
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), recv, send)
    return out


def all_reduce_sum(x):
    if joined():
        dist.all_reduce(x)
    return x


def all_gather_object(obj):
    """[every rank's obj] in rank order (host objects, pickled)."""
    if not joined():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
