"""Sharded build and merge over the process group (port of
ska_tpu/parallel/build.py): a parallel sample sort (PSRS, parallel
sorting by regular sampling) by key range.

LOCAL stage, per (padded-length bucket, FASTQ config) group of samples:
each rank runs every sample pipeline of its consecutive block of rows
(ops.pipeline.batched_pipeline: extraction, the quality gates, the
min-count rank filter, each sample's row sort and IUPAC union) and keeps
(key, global sample id, set) triples; dead positions carry the all-ones
sentinel, which sorts last.

MERGE stage, one for the whole cohort:

1. each rank sorts its triples of every group by key (the radix kernel
   on a card);
2. 128 regular samples of each rank's sorted keys are all-gathered and
   sorted, and D-1 pivots taken at the D-quantiles;
3. the lower bounds of the pivots (then a cummax) cut each rank's keys
   into D consecutive ranges; one all_to_all_single sends the D counts,
   then three send the keys, the sample ids and the sets with those
   uneven splits: rank j receives exactly the triples of key range j;
4. each rank merges its own range: a sort by key, row ids by cumsum,
   then scatters into the keys, the variants matrix and the counts.

Rank order is key-range order, so the blocks of all ranks, gathered in
rank order, are the globally sorted array (the JAX package's host
assembly). all_to_all_single takes each pair's count, so the JAX
package's static per-pair capacity, its overflow flag and its retry loop
(SKA_MESH_CPAIR_INIT) have no counterpart here, nor its int32/int64
scatter switch: every index is int64.

The steps run in ``ska::`` profiler spans, as the serial build's do:
to_device, device_pass (the local stage), exchange (the merge stage)
and to_host (the gather of the blocks).
"""

import numpy as np
import torch
from torch.profiler import record_function

from ..encoding import SET_TO_ASCII
from ..ops import keys as K
from ..ops import pipeline as P
from ..ops.npkeys import width_for_k
from ..torchinit import get_device
from . import comm

_R_SAMP = 128  # splitter samples per rank
_SENT = -1  # all-ones key limb


def _local_triples(seqs, valid, qual_ok, rec_last, sids, k, rc, W, is_reads,
                   use_mq, min_count):
    """Each sample's pipeline over this rank's (s_loc, L) rows. Returns
    (keys (N, W) int64, sample ids (N,) int32, sets (N,) uint8) with
    N = s_loc * L; dead positions carry all-ones keys. sids maps the rows
    to GLOBAL cohort columns, so that triples of several groups merge in
    one exchange."""
    s_loc, L = seqs.shape
    N = s_loc * L
    sp, union, is_end, _ = P.batched_pipeline(
        seqs, valid, qual_ok, rec_last, k, rc, W, is_reads, use_mq, min_count)
    sp = sp.reshape(N, W)
    live = is_end.reshape(N) & (sp != _SENT).any(dim=-1)
    keyv = torch.where(live[:, None], K.shr(sp, 4), _SENT)  # drop the set bits
    sid = sids.to(torch.int32)[:, None].expand(s_loc, L).reshape(N)
    setv = torch.where(live, union.reshape(N), 0).to(torch.uint8)
    return keyv, sid, setv


def _local_triples_raw(seqs, qual_bits, rec_ends, sids, k, rc, W, is_reads,
                       use_mq, min_count, strict_valid, has_qual):
    """_local_triples fed by raw bytes: the masks derive on the device
    (ops.pipeline.device_masks), so the host ships 1-1.125 bytes a base."""
    valid, qual_ok, rec_last = P.device_masks(seqs, qual_bits, rec_ends,
                                              strict_valid, has_qual)
    return _local_triples(seqs, valid, qual_ok, rec_last, sids, k, rc, W,
                          is_reads, use_mq, min_count)


def _merge_shard(keyv, sid, setv, n_samples):
    """The key-range exchange of this rank's triples and the merge of the
    range it receives. Returns this rank's block: (keys (n, W) int64,
    variants (n, n_samples) uint8 ASCII, counts (n,) int64)."""
    D, _ = comm.world()
    N, W = keyv.shape
    dev = keyv.device
    # 1. local sort by key (sentinels last; real keys have the top 4 bits
    #    of the hi limb clear, so all-ones never collides with a key)
    skeys, _, (ssid, sset) = K.sort_with(keyv, (sid, setv))
    nv = int((skeys != _SENT).any(dim=-1).sum())

    # 2. splitters: regular samples of the live keys, gathered and sorted
    r = torch.arange(_R_SAMP, dtype=torch.int64, device=dev)
    samp = skeys[((r * nv) // _R_SAMP).clamp(0, max(N - 1, 0))]
    gs = comm.all_gather(samp)  # (D * R, W)
    z = torch.zeros(gs.shape[0], dtype=torch.int32, device=dev)
    gss, _, _ = K.sort_with(gs, (z, z.to(torch.uint8)))
    pivots = gss[_R_SAMP::_R_SAMP][: D - 1]

    # 3. lower bounds, so keys equal to a pivot land in one range on every
    #    rank; cummax keeps the cuts monotone for degenerate pivots
    cuts = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        K.lower_bound(skeys, pivots.contiguous()).clamp(max=nv),
        torch.full((1,), nv, dtype=torch.int64, device=dev),
    ])
    cuts = torch.cummax(cuts, dim=0).values
    send = (cuts[1:] - cuts[:-1]).tolist()
    recv = comm.exchange_counts(send, dev)
    mk = comm.exchange(skeys[:nv], send, recv)
    msid = comm.exchange(ssid[:nv], send, recv)
    mset = comm.exchange(sset[:nv], send, recv)

    # 4. merge this rank's range: every received triple is live, and each
    #    (key, sample) pair arrives once (samples were unioned locally)
    mk, _, (msid, mset) = K.sort_with(mk, (msid, mset))
    newrow = P._starts(mk[None])[0]
    rows = torch.cumsum(newrow, dim=0) - 1
    n_rows = int(rows[-1]) + 1 if len(rows) else 0
    variants = torch.full((n_rows * n_samples,), ord("-"), dtype=torch.uint8,
                          device=dev)
    ascii_of = torch.as_tensor(SET_TO_ASCII, dtype=torch.uint8, device=dev)
    variants[rows * n_samples + msid.long()] = ascii_of[mset.long()]
    counts = torch.bincount(rows, minlength=n_rows)
    return mk[newrow], variants.reshape(n_rows, n_samples), counts


def _rank_rows(x, rank, s_loc, fill):
    """Rows [rank * s_loc, (rank + 1) * s_loc) of the host array x,
    padded with `fill` rows (all-invalid samples) to s_loc."""
    x = np.asarray(x)
    part = x[rank * s_loc : (rank + 1) * s_loc]
    if len(part) == s_loc:
        return part
    out = np.full((s_loc,) + x.shape[1:], fill, x.dtype)
    out[: len(part)] = part
    return out


def distributed_build_multi(calls, k, rc, min_count=0, device=None):
    """Sharded build and merge of a mixed-shape cohort in ONE key-range
    exchange, on every rank of the group (or on its own without one).

    calls: one dict per (length bucket, FASTQ config) group, as in the
    JAX package, in one of two staging shapes:
      masks — seqs/valid/qual/rec_last: (S_c, L_c) host arrays;
      raw   — key "quals" present: seqs (S_c, L_c) uint8, quals packed
        quality-pass bits (S_c, ceil(L_c/8)) (or an (S_c, 1) dummy),
        rec_ends (S_c, E) int32, plus strict_valid/has_qual;
    and in both: sids (S_c,) the GLOBAL cohort column of each row, and
    is_reads/use_mq, the group's pipeline config. Every rank passes the
    same calls and stages its consecutive block of ceil(S_c / D) rows
    (the last blocks padded with all-invalid rows); the host arrays are
    consumed (set to None) as each group goes to the device.
    n_samples (the output width) is 1 + max sid across calls.

    Returns (keys (R, W) uint64, variants (R, n_samples) uint8, counts
    (R,) int64, R) on every rank, globally sorted by key.
    """
    dev = get_device(device)
    W = width_for_k(k)
    D, rank = comm.world()
    n_samples = 1 + max(int(np.max(c["sids"])) for c in calls)
    parts = []
    for c in calls:
        S_in, L = np.asarray(c["seqs"]).shape
        s_loc = -(-S_in // D)

        raw = "quals" in c
        names = (("seqs", 0), ("quals", 0), ("rec_ends", L), ("sids", 0)) if raw \
            else (("seqs", 0), ("valid", 0), ("qual", 0), ("rec_last", 0),
                  ("sids", 0))
        with record_function("ska::to_device"):
            args = [torch.from_numpy(_rank_rows(c[n], rank, s_loc, fill)).to(dev)
                    for n, fill in names]
        for n, _ in names:
            c[n] = None  # consumed: peak host memory stays one group
        cfg = (k, rc, W, bool(c["is_reads"]), bool(c["use_mq"]), int(min_count))
        with record_function("ska::device_pass"):
            if raw:
                parts.append(_local_triples_raw(
                    *args, *cfg, bool(c.get("strict_valid", False)),
                    bool(c.get("has_qual", False))))
            else:
                parts.append(_local_triples(*args, *cfg))
        del args
    keyv, sid, setv = (torch.cat(p) for p in zip(*parts))
    del parts
    with record_function("ska::exchange"):
        ukeys, variants, counts = _merge_shard(keyv, sid, setv, n_samples)
    del keyv, sid, setv

    # blocks are consecutive key ranges: rank order is key order
    with record_function("ska::to_host"):
        sizes = comm.all_gather(torch.tensor([len(ukeys)], device=dev)).tolist()
        keys = K.to_numpy_keys(comm.all_gather_rows(ukeys, sizes))
        var = comm.all_gather_rows(variants, sizes).cpu().numpy()
        cnts = comm.all_gather_rows(counts, sizes).cpu().numpy()
    return keys, var, cnts, len(keys)


def distributed_merged_build(seqs_np, valid_np, qual_np, rec_last_np, k, rc,
                             is_reads=False, use_mid_qual=False, min_count=0,
                             device=None):
    """One group of (n_samples, L) uint8 sequences with their masks (the
    one-bucket case of distributed_build_multi)."""
    S_in = np.asarray(seqs_np).shape[0]
    return distributed_build_multi(
        [dict(seqs=seqs_np, valid=valid_np, qual=qual_np, rec_last=rec_last_np,
              sids=np.arange(S_in, dtype=np.int32),
              is_reads=is_reads, use_mq=use_mid_qual)],
        k, rc, min_count=min_count, device=device,
    )


def distributed_build(seqs_np, valid_np, rec_last_np, k, rc, device=None):
    """FASTA-only wrapper (no quality or count filter)."""
    qual = np.ones_like(np.asarray(valid_np), dtype=bool)
    return distributed_merged_build(seqs_np, valid_np, qual, rec_last_np, k,
                                    rc, device=device)


def dryrun_step(n_devices=None, k: int = 17, L: int = 512,
                per_dev_samples: int = 2, device=None):
    """Small sharded build steps on every rank of the group (the JAX
    package's dryrun_step, on the same inputs; graft_entry.py runs it).

    Runs the sharded pipeline in four configurations: FASTA at k=17 with
    a sample count that does NOT divide the world, FASTQ with the
    min-count rank filter, W=2 keys (k=41), and a mixed-length cohort
    (two length buckets through one key-range exchange); then the sharded
    lookup and class Gram of the first array. n_devices, when given, must
    be the world size. Returns the first build's row count.
    """
    from .postbuild import distributed_class_gram, distributed_lookup

    D, _ = comm.world()
    if n_devices is not None and n_devices != D:
        raise ValueError(f"dryrun_step({n_devices}) in a group of {D} ranks")
    n_samples = D * per_dev_samples - 1 if D > 1 else per_dev_samples
    rng = np.random.default_rng(0)
    seqs = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(n_samples, L))
    valid = np.ones((n_samples, L), bool)
    rec_last = np.zeros((n_samples, L), bool)
    rec_last[:, -1] = True
    keys, variants, _, n_rows = distributed_build(seqs, valid, rec_last, k,
                                                  True, device)
    _expect(n_rows > 0 and variants.shape == (n_rows, n_samples), "FASTA build")

    # FASTQ + min-count: two identical reads per sample so every k-mer
    # passes the min_count=2 rank filter
    seqs2 = seqs.copy()
    seqs2[:, L // 2 :] = seqs[:, : L - L // 2]
    rl2 = np.zeros((n_samples, L), bool)
    rl2[:, L // 2 - 1] = True
    rl2[:, -1] = True
    qual = np.ones((n_samples, L), bool)
    *_, n2 = distributed_merged_build(seqs2, valid, qual, rl2, k, True,
                                      is_reads=True, use_mid_qual=True,
                                      min_count=2, device=device)
    _expect(n2 > 0, "FASTQ build")

    # W=2 two-limb keys
    *_, n3 = distributed_build(seqs, valid, rec_last, 41, True, device)
    _expect(n3 > 0, "W=2 build")

    # mixed-length cohort: two buckets, one exchange
    L2 = L // 2
    rl_b = np.zeros((n_samples, L2), bool)
    rl_b[:, -1] = True
    calls = [
        dict(seqs=seqs, valid=valid, qual=qual, rec_last=rec_last,
             sids=np.arange(n_samples, dtype=np.int32),
             is_reads=False, use_mq=False),
        dict(seqs=seqs[:, :L2], valid=valid[:, :L2], qual=qual[:, :L2],
             rec_last=rl_b,
             sids=np.arange(n_samples, 2 * n_samples, dtype=np.int32),
             is_reads=False, use_mq=False),
    ]
    _, var4, _, n4 = distributed_build_multi(calls, k, True, device=device)
    _expect(n4 > 0 and var4.shape == (n4, 2 * n_samples), "mixed-length build")

    # the sharded post-build modes: key-range lookup and site-sharded Gram
    queries = np.concatenate([keys[::3], keys[:4] ^ np.uint64(0x5A5A)])
    found, rows = distributed_lookup(keys, queries, device)
    n_hits = len(keys[::3])
    _expect(found[:n_hits].all()
            and np.array_equal(keys[rows[:n_hits]], keys[::3]), "lookup")
    G = distributed_class_gram(variants, device)
    # every site contributes one class co-occurrence per (i, j) pair
    _expect(int(G.sum()) == variants.shape[0] * variants.shape[1] ** 2,
            "class Gram")
    return n_rows


def _expect(cond, what: str):
    if not cond:
        raise RuntimeError(f"dryrun_step: the {what} failed its check")
