"""Sample builds: the device half of ska_tpu/sample.py's merged cohort
build (build_samples_merged, build_samples_distributed) and of its
per-sample dictionaries (build_sample, build_samples, dict_from_batch:
webapi.py's SkaData maps through build_sample; its AlignData builds on
the merged cohort route), with the port's copies of their host
helpers.

Host parsing, grouping by (padded length, reads, quality gates), the
batch size (``_auto_max_batch``) and the chunking of samples over the
dispatch cap (``_chunk_views``) are copies of the JAX package's
functions, so every batch, every chunk and every output byte lines up
with it. The batches and chunks then run on the port's device pipelines
(ops/pipeline.py).

Every device pass, merged, per-sample, sharded, chunked and ``cov``'s,
takes one staged form, ``_stage_raw``'s: the sequence bytes, packed
quality-pass bits and record-end positions, 1-1.125 bytes a base; the
masks derive on the card (``ops.pipeline.device_masks``). The JAX
package's merged build ships 2-bit codes and validity bits instead and
pads its batch axis to a power of two: the first for the ~25 MB/s relay
between it and its TPU, the second because XLA compiles once a shape.
The port's card has no relay in between and torch compiles nothing per
shape, so neither is copied: a merged batch is its samples' rows alone.

Each step runs inside a ``torch.profiler.record_function`` span named
``ska::<step>`` (parse, stage, to_device, device_pass, to_host; api.py
adds union and cli.py save), in the merged build and the per-sample
builds alike. The spans cost nothing measurable when no profiler runs;
under one they give each step's host wall time beside the device's
kernel time (chip_smoke.py, phase 4). Each device pass ends on a wait
for its row counts, which the copies after it would wait for anyway,
so the spans move no work. The chunked build stages its masks in a
``ska::stage`` span of their own and merges its chunks on the host in
``ska::chunk_merge``.

Counters of the chunked build (``torchinit.chunk_counts``, zeroed with
the launch counters): ``chunked_samples``, the samples built in chunks;
``chunks``, the device passes they took; ``chunk_rows``, the rows those
passes handed to the host merge (whole k-mers under a count filter,
split k-mers without one); ``chunk_copy_bytes``, the bytes those rows
took from the device to the host.

The chunked build compacts each chunk on the card: its pass's padded
outputs (2^26 rows a chunk at SKA_MAX_CHUNK_BASES) stay on the device,
the live segment starts (or dictionary rows) are gathered there, and
only those rows cross, into page-locked host memory
(``ops.pipeline.rows_to_host``): ``chunk_rows`` x (16W + 4) bytes under
a count filter, x (8W + 1) without one.

The merged build finishes each batch on the card in the same way: the
ASCII variants matrix, the per-row sample counts and each sample's
presence are made there, and only those rows cross, pinned
(``ops.pipeline.merged_to_host``); the host makes no pass over the
matrix. Its counters (``torchinit.merged_counts``, zeroed with the
others): ``merged_batches``, the batches copied out; ``merged_rows``,
their rows; ``merged_copy_bytes``, the bytes those rows took,
``merged_rows`` x (8W + S + 8) + S for a batch of S samples.
"""

import concurrent.futures as cf
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .constants import QUAL_MIDDLE, QUAL_STRICT, check_k
from .encoding import SET_TO_ASCII
from .io import fastx
from .ops import keys as K
from .ops import pipeline as P
from .ops.npkeys import np_lex_argsort, width_for_k
from .progress import Bar
from .sampletypes import QualOpts, SampleDict
from .torchinit import get_device

chunked_samples = 0
chunks = 0
chunk_rows = 0
chunk_copy_bytes = 0
merged_batches = 0
merged_rows = 0
merged_copy_bytes = 0


def _bucket(n: int) -> int:
    """Pad lengths to power-of-two buckets (the JAX package's buckets, so
    that batches line up with it)."""
    b = 1024
    while b < n:
        b *= 2
    return b


def _bucket_min(n: int, lo: int) -> int:
    """Power-of-two bucket with a custom floor (record-end arrays are
    tiny for FASTA, read-count sized for FASTQ)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _subsample_reads(ff: fastx.FastxFile, proportion_reads):
    """Keep every step-th record, step = round(1/proportion); the counter
    restarts per file, as the reference resets iter_reads per file
    (src/ska_dict.rs:125-141)."""
    if proportion_reads is None:
        return ff
    # Rust f64::round = half away from zero (ska_dict.rs:128)
    step = int(np.floor(1.0 / proportion_reads + 0.5))
    if step <= 1:
        return ff
    out = fastx.FastxFile(is_fastq=ff.is_fastq)
    for i in range(len(ff.seqs)):
        if i % step == 0:
            out.ids.append(ff.ids[i])
            out.seqs.append(ff.seqs[i])
            out.quals.append(ff.quals[i])
    return out


def _valid_bases(seq):
    """The reference's valid_base rule on the host (bit_encoding.rs:52-54):
    not N and not a separator or padding byte; other IUPAC letters
    2-bit-project (quirk preserved). ops.pipeline.device_masks is its
    device copy."""
    return ((seq & 0xF) != 14) & (seq != 0)


def _qual_pass(qual, min_qual: int):
    """Quality pass of each base: PHRED (byte - 33) over min_qual, or the
    0xFF that marks a record without qualities in a mixed batch
    (fastx.build_batch), which passes like the reference's `qual: None
    => true` (split_kmer.rs:66-71). Compared on the bytes themselves:
    byte - 33 > min_qual is byte > 33 + min_qual."""
    thr = 33 + int(min_qual)
    if thr < 0:
        return np.ones(len(qual), bool)
    return (qual > min(thr, 255)) | (qual == 0xFF)


def _masks(batch: fastx.SeqBatch, qual: QualOpts, is_reads: bool):
    """Base validity of a whole sample on the host, with the quality pass
    under strict validity: the chunked build's boundary oracle."""
    valid = _valid_bases(batch.seq)
    if _gates(is_reads, batch.has_qual, qual)[1]:
        valid &= _qual_pass(batch.qual, int(qual.min_qual))
    return valid


def _gates(is_reads: bool, has_qual: bool, qual: QualOpts):
    """(use_mid_qual, strict_valid): the middle-base quality gate runs
    for reads with qualities under the middle and strict filters; strict
    validity (every base of a window passes) under strict alone."""
    use_mq = bool(is_reads and has_qual
                  and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT))
    return use_mq, bool(is_reads and has_qual and qual.qual_filter == QUAL_STRICT)


def prepare_sample(
    files: Tuple[str, Optional[str]],
    proportion_reads: Optional[float] = None,
) -> Tuple[fastx.SeqBatch, bool]:
    """Host parse: FASTA/FASTQ files -> flat SeqBatch + is_reads flag.

    Mirrors SkaDict::new (ska_dict.rs:333-378): format detected by peeking
    the first record of the first file; both files share the format flag.
    """
    is_reads = fastx.peek_format(files[0]) == "fastq"
    parts = [fastx.read_fastx(files[0])]
    if files[1] is not None:
        parts.append(fastx.read_fastx(files[1]))

    seqs: List[bytes] = []
    quals: List[Optional[bytes]] = []
    for ff in parts:
        ff = _subsample_reads(ff, proportion_reads)
        seqs.extend(ff.seqs)
        quals.extend(ff.quals)
    return fastx.build_batch(seqs, quals), is_reads


def build_sample(name: str, k: int, files: Tuple[str, Optional[str]],
                 rc: bool, qual: QualOpts, proportion_reads=None,
                 device=None) -> SampleDict:
    """Build one sample's dictionary from FASTA or paired FASTQ input."""
    check_k(k)
    dev = get_device(device)
    with record_function("ska::parse"):
        batch, is_reads = prepare_sample(files, proportion_reads)
    keys_np, sets_np = dict_from_batch(batch, k, rc, qual, is_reads, dev)
    if len(keys_np) == 0:
        raise ValueError(f"{files[0]} has no valid sequence")
    return SampleDict(name=name, k=k, rc=rc, keys=keys_np, sets=sets_np)


def build_samples(input_files, k: int, rc: bool, qual: QualOpts,
                  proportion_reads=None, max_batch: int = 8,
                  device=None) -> List[SampleDict]:
    """Each sample's own dictionary, in input order. Samples are parsed
    and grouped as the merged build's (_parse_and_group); each group runs
    in batches of max_batch, one device pass each (batched_from_raw, row
    by row), and a sample over SKA_MAX_CHUNK_BASES builds chunked."""
    check_k(k)
    dev = get_device(device)
    prepared, groups, big, cap = _parse_and_group(input_files, k, qual,
                                                  proportion_reads)
    results: List[Optional[SampleDict]] = [None] * len(prepared)

    def store(i, keys_sets):
        keys_np, sets_np = keys_sets
        if len(keys_np) == 0:
            raise ValueError(f"{input_files[i][1]} has no valid sequence")
        results[i] = SampleDict(name=input_files[i][0], k=k, rc=rc,
                                keys=keys_np, sets=sets_np)

    for i in big:
        batch, is_reads = prepared[i]
        store(i, dict_from_batch_chunked(batch, k, rc, qual, is_reads, cap, dev))
    for (Lp, is_reads, _, _), idxs in groups.items():
        for c0 in range(0, len(idxs), max_batch):
            chunk = idxs[c0 : c0 + max_batch]
            for i, keys_sets in zip(chunk, _run_batch(
                    [prepared[i][0] for i in chunk], Lp, k, rc, qual,
                    is_reads, dev)):
                store(i, keys_sets)
    return results


def _run_batch(batches, Lp, k, rc, qual, is_reads, device):
    """Each batch's (keys, sets) from one device pass over the group's
    rows (batched_from_raw; the JAX package's branch to sample_from_raw
    for one sample is the same computation here)."""
    W = width_for_k(k)
    with record_function("ska::stage"):
        staged = _stage_raw(batches, Lp, int(qual.min_qual))
    use_mq, strict_valid = _gates(is_reads, staged[3], qual)
    cfg = (k, rc, W, is_reads, use_mq, int(qual.min_count), strict_valid,
           staged[3])
    with record_function("ska::to_device"):
        seqs, qual_bits, rec_ends = (torch.from_numpy(x).to(device)
                                     for x in staged[:3])
    with record_function("ska::device_pass"):
        sp, union, is_end, nu = P.batched_from_raw(seqs, qual_bits, rec_ends,
                                                   *cfg)
        nu.cpu()  # the copies below wait for the card anyway
    with record_function("ska::to_host"):
        sp_np = K.to_numpy_keys(sp)
        union_np, end_np = union.cpu().numpy(), is_end.cpu().numpy()
        return [P.unpack_host(sp_np[i], union_np[i], end_np[i], W)
                for i in range(len(batches))]


def dict_from_batch(batch: fastx.SeqBatch, k: int, rc: bool, qual: QualOpts,
                    is_reads: bool, device=None):
    """One sample's (keys, sets): one device pass, or the chunked build
    when it is over SKA_MAX_CHUNK_BASES."""
    dev = get_device(device)
    cap = _max_chunk_bases()
    if len(batch.seq) + k + 1 > cap:
        return dict_from_batch_chunked(batch, k, rc, qual, is_reads, cap, dev)
    return _run_batch([batch], _bucket(len(batch.seq) + k + 1), k, rc, qual,
                      is_reads, dev)[0]


def _auto_max_batch(Lp: int) -> int:
    """Samples per merged dispatch, as the JAX package chooses them:
    scale inversely with the padded length under a ~128M-base budget,
    at most 32. SKA_MAX_BATCH overrides. A batch runs as exactly its
    samples' rows: the JAX package pads it to a power of two so that XLA
    compiles few shapes, and torch compiles nothing per shape."""
    env = os.environ.get("SKA_MAX_BATCH")
    if env:
        return max(1, int(env))
    eff = max(1, min(32, (1 << 27) // max(Lp, 1)))
    # The merged pipeline's variants scatter is an (S*Lp, S) buffer.
    # Cap it at 1 GB, which also keeps the scatter's int32 index space
    # (rows * S + sample < 2^31) safe: 32 x 4 Mb genomes would otherwise
    # demand a 4.3 GB buffer.
    while eff > 1 and Lp * eff * eff > (1 << 30):
        eff //= 2
    return eff


def _present_columns(var_np):
    """Whether each column of a host variants matrix holds a non-gap base."""
    return (var_np != ord("-")).any(axis=0)


def _check_all_present(present, paths):
    """A sample with zero k-mers panics in the reference
    (ska_dict.rs:374-376): column col of the variants matrix must carry
    at least one non-gap base (present[col]); paths[col] names the
    offending input."""
    for col, path in enumerate(paths):
        if not present[col]:
            raise ValueError(f"{path} has no valid sequence")


def _stage_raw(batches, Lp, min_qual=0):
    """The one staged form of every device pass: (seqs (S, Lp) uint8
    sequence bytes, 0 = padding; qual_bits (S, ceil(Lp/8)) uint8,
    np.packbits of the quality pass, or an (S, 1) dummy unless every
    batch has qualities; rec_ends (S, E) int32 record-final positions,
    Lp = padding; has_qual). The masks derive on the device
    (ops.pipeline.device_masks)."""
    S = len(batches)
    has_qual = all(bool(b.has_qual) for b in batches)
    seqs = np.zeros((S, Lp), np.uint8)
    qual_bits = np.zeros((S, (Lp + 7) // 8 if has_qual else 1), np.uint8)
    Eb = _bucket_min(max(int(b.rec_last.sum()) for b in batches), 16)
    rec_ends = np.full((S, Eb), Lp, np.int32)
    for i, b in enumerate(batches):
        L = len(b.seq)
        seqs[i, :L] = b.seq
        if has_qual:
            ok = np.zeros(Lp, bool)  # padding packs to 0
            ok[:L] = _qual_pass(b.qual, min_qual)
            qual_bits[i] = np.packbits(ok)
        ends = np.flatnonzero(b.rec_last).astype(np.int32)
        rec_ends[i, : len(ends)] = ends
    return seqs, qual_bits, rec_ends, has_qual


def _max_chunk_bases() -> int:
    """Device dispatch cap in bases; inputs beyond it build chunked
    (bounded HBM, like the reference's streaming reads)."""
    # default just under a pow2 so the padded chunk bucket stays 2^26
    return int(os.environ.get("SKA_MAX_CHUNK_BASES", str((1 << 26) - 128)))


def _parse_and_group(input_files, k: int, qual, proportion_reads):
    """Parse every sample on the host, then sort them into the chunked
    ones (over SKA_MAX_CHUNK_BASES) and groups by (padded length, reads,
    middle quality gate, qualities). Returns (prepared, {group key:
    [input index]}, [oversized input index], the cap)."""
    with record_function("ska::parse"), cf.ThreadPoolExecutor(8) as pool:
        prepared = list(pool.map(
            lambda t: prepare_sample((t[1], t[2]), proportion_reads),
            input_files,
        ))
    cap = _max_chunk_bases()
    groups = {}
    big = []
    for i, (batch, is_reads) in enumerate(prepared):
        if len(batch.seq) + k + 1 > cap:
            big.append(i)  # oversized sample: chunked per-sample build
            continue
        Lp = _bucket(len(batch.seq) + k + 1)
        use_mq, _ = _gates(is_reads, batch.has_qual, qual)
        key = (Lp, is_reads, use_mq, bool(batch.has_qual))
        groups.setdefault(key, []).append(i)
    return prepared, groups, big, cap


def _big_batch(input_files, i, keys_sets):
    """The batch result of oversized sample i from its chunked build's
    (keys, sets)."""
    keys_np, sets_np = keys_sets
    if len(keys_np) == 0:
        raise ValueError(f"{input_files[i][1]} has no valid sequence")
    var = np.asarray(SET_TO_ASCII)[sets_np][:, None]
    return [i], [input_files[i][0]], keys_np, var, np.ones(len(keys_np), np.int64)


def build_samples_merged(input_files, k: int, rc: bool, qual,
                         proportion_reads=None, device=None):
    """Build and merge a cohort of FASTA and/or FASTQ samples.

    Samples over the dispatch cap (SKA_MAX_CHUNK_BASES) build one by one
    in chunks (dict_from_batch_chunked); the others are grouped by
    (padded length, reads, middle-quality gate, qualities) and run one
    device pass per batch (merged_build_from_raw). Returns the list of
    (input indices, names, keys, variants, counts) batch results that
    ska_tpu.sample.build_samples_merged returns; api.build unions them
    and restores the input column order.
    """
    global merged_batches, merged_rows, merged_copy_bytes
    check_k(k)
    dev = get_device(device)
    prepared, groups, big, cap = _parse_and_group(input_files, k, qual,
                                                  proportion_reads)
    W = width_for_k(k)
    out = []
    bar = Bar(len(prepared), "samples")
    for i in big:
        batch, is_reads = prepared[i]
        out.append(_big_batch(input_files, i, dict_from_batch_chunked(
            batch, k, rc, qual, is_reads, cap, dev)))
        bar.update(1)
    for (Lp, is_reads, use_mq, has_qual), idxs in groups.items():
        _, strict_valid = _gates(is_reads, has_qual, qual)
        eff_batch = _auto_max_batch(Lp)
        for c0 in range(0, len(idxs), eff_batch):
            chunk = idxs[c0 : c0 + eff_batch]
            with record_function("ska::stage"):
                staged = _stage_raw([prepared[i][0] for i in chunk], Lp,
                                    int(qual.min_qual))
            with record_function("ska::to_device"):
                seqs, qual_bits, rec_ends = (torch.from_numpy(x).to(dev)
                                             for x in staged[:3])
            with record_function("ska::device_pass"):
                ukeys, variants4, counts, n_rows = P.merged_build_from_raw(
                    seqs, qual_bits, rec_ends, k, rc, W, is_reads, use_mq,
                    int(qual.min_count), strict_valid, has_qual,
                )
                n = int(n_rows)
            with record_function("ska::to_host"):
                keys_np, var_np, counts_np, present, nbytes = P.merged_to_host(
                    ukeys, variants4, counts, n, len(chunk))
            merged_batches += 1
            merged_rows += n
            merged_copy_bytes += nbytes
            _check_all_present(present, [input_files[i][1] for i in chunk])
            names = [input_files[i][0] for i in chunk]
            out.append((chunk, names, keys_np, var_np, counts_np))
            bar.update(len(chunk))
    bar.finish()
    return out


def build_samples_distributed(input_files, k: int, rc: bool, qual,
                              proportion_reads=None, device=None):
    """Build and merge a cohort over the process group, with the result
    contract of build_samples_merged (ska_tpu.sample's
    build_samples_distributed).

    Every rank parses every sample, so that all agree on the groups and
    the sample ids. Samples are grouped by (padded length, reads, middle
    quality gate, qualities) for the local stage only, and a group over
    SKA_MAX_HOST_BATCH_BYTES is staged in several calls; every group's
    triples then merge in ONE key-range exchange
    (parallel.distributed_build_multi), so api.build gets one batch for
    them. Samples over SKA_MAX_CHUNK_BASES build chunked
    (dict_from_batch_chunked), the j-th of them on rank j % D; the ranks
    swap their results and api.build unions them on the host. Every rank
    returns the same batches.
    """
    from .parallel import comm
    from .parallel.build import distributed_build_multi

    check_k(k)
    dev = get_device(device)
    D, rank = comm.world()
    prepared, groups, big, cap = _parse_and_group(input_files, k, qual,
                                                  proportion_reads)
    out = []
    if big:
        mine = {}
        for j, i in enumerate(big):
            if j % D == rank:
                batch, is_reads = prepared[i]
                mine[i] = dict_from_batch_chunked(batch, k, rc, qual, is_reads,
                                                  cap, dev)
            prepared[i] = None  # consumed; free the raw batch
        built = {i: r for part in comm.all_gather_object(mine)
                 for i, r in part.items()}
        out += [_big_batch(input_files, i, built[i]) for i in big]

    # bound the transient host staging of one local call (1-2 bytes a
    # base); a larger group takes several calls, still one exchange
    cap_bytes = int(os.environ.get("SKA_MAX_HOST_BATCH_BYTES", 4 << 30))
    calls, call_idxs = [], []
    for (Lp, is_reads, use_mq, has_qual), gidxs in groups.items():
        _, strict_valid = _gates(is_reads, has_qual, qual)
        per = max(1, cap_bytes // (Lp * (2 if has_qual else 1)))
        for c0 in range(0, len(gidxs), per):
            idxs = gidxs[c0 : c0 + per]
            with record_function("ska::stage"):
                seqs, qual_bits, rec_ends, _ = _stage_raw(
                    [prepared[i][0] for i in idxs], Lp, int(qual.min_qual))
            for i in idxs:
                prepared[i] = None  # staged; free the raw batch
            calls.append(dict(
                seqs=seqs, quals=qual_bits, rec_ends=rec_ends,
                sids=np.arange(len(call_idxs), len(call_idxs) + len(idxs),
                               dtype=np.int32),
                is_reads=is_reads, use_mq=use_mq, strict_valid=strict_valid,
                has_qual=has_qual,
            ))
            call_idxs.extend(idxs)
    if calls:
        keys_np, var_np, counts_np, _ = distributed_build_multi(
            calls, k, rc, min_count=int(qual.min_count), device=dev)
        _check_all_present(_present_columns(var_np),
                           [input_files[i][1] for i in call_idxs])
        out.append((call_idxs, [input_files[i][0] for i in call_idxs],
                    keys_np, var_np, counts_np))
    return out


def _chunk_views(batch: fastx.SeqBatch, k: int, cap: int, valid=None):
    """Yield (a, b, end) slice windows of the flat batch with k-1 base
    overlap: chunk i covers window starts [a_i, a_{i+1}) exactly (its
    slice is [a_i, a_{i+1}+k-1), so the in-range check emits no start
    twice and drops none).

    A boundary may not land where the next chunk's FIRST window is a
    record-final window whose previous base is valid: that window's
    emission rule (split_kmer.rs roll-only last window) consults
    valid[a-1], which the next slice cannot see — nudge the boundary
    forward past such spots (drift is bounded by the record length;
    separators break the valid[b-1] condition)."""
    L = len(batch.seq)
    rl = batch.rec_last
    step = max(cap - (k - 1), 1)
    a = 0
    while a < L:
        b = min(a + step, L)
        if valid is not None:
            while (
                b < L
                and b + k - 1 < L
                and rl[b + k - 1]
                and b > 0
                and valid[b - 1]
            ):
                b += 1
        end = min(b + k - 1, L)
        yield a, b, end
        a = b


def key_totals(keys, counts):
    """Sum the counts of equal keys. keys (n, W) uint64, counts (n,).
    Returns (order, first, totals): the keys' lexicographic order, the
    first row of each distinct key in that order, and each distinct
    key's summed count (int64), in key order."""
    order = np_lex_argsort(keys)
    skeys = keys[order]
    first = np.ones(len(skeys), bool)
    first[1:] = (skeys[1:] != skeys[:-1]).any(axis=-1)
    gid = np.cumsum(first) - 1
    totals = np.bincount(gid, weights=counts[order]).astype(np.int64)
    return order, first, totals


def dict_from_batch_chunked(batch: fastx.SeqBatch, k: int, rc: bool,
                            qual: QualOpts, is_reads: bool, cap: int,
                            device=None):
    """Chunked per-sample build for inputs larger than one device
    dispatch (the reference streams reads with bounded memory,
    ska_dict.rs:118-180; here bounded = `cap` bases per dispatch).

    Without a count filter, chunks produce per-chunk sorted unique
    (split key, set) pairs which merge by a host sort + segmented OR.
    With min_count > 1, chunks produce per-whole-k-mer counts plus the
    (identical per whole k-mer) split pair; counts sum across chunks
    and the threshold applies globally (see
    ops.pipeline.chunk_count_pipeline).
    """
    global chunked_samples, chunks, chunk_rows, chunk_copy_bytes
    dev = get_device(device)
    W = width_for_k(k)
    with record_function("ska::stage"):
        valid_full = _masks(batch, qual, is_reads)
    use_mq, strict_valid = _gates(is_reads, batch.has_qual, qual)
    want_count = bool(is_reads and qual.min_count > 1)
    Lp = _bucket(cap + k + 1)
    has_qual = bool(batch.has_qual)

    kparts, sparts = [], []
    wparts, cparts, pparts = [], [], []
    for a, b, end in _chunk_views(batch, k, cap, valid_full):
        # the host-side valid_full is only the chunk-boundary oracle
        with record_function("ska::stage"):
            staged = _stage_raw([batch.slice(a, end)], Lp, int(qual.min_qual))
        with record_function("ska::to_device"):
            seqs, qual_bits, rec_ends = (torch.from_numpy(x).to(dev)
                                         for x in staged[:3])
        if want_count:
            with record_function("ska::device_pass"):
                swk, is_start, counts, spacked, nu = P.chunk_count_from_raw(
                    seqs[0], qual_bits[0], rec_ends[0], k, rc, W, use_mq,
                    strict_valid, has_qual,
                )
                int(nu)  # the compaction below waits for the card anyway
            with record_function("ska::to_host"):
                wk, cnt, pk, nbytes = P.chunk_counts_to_host(
                    swk, is_start, counts, spacked)
            wparts.append(wk)
            cparts.append(cnt)
            pparts.append(pk)
        else:
            with record_function("ska::device_pass"):
                sp, union, is_end, nu = P.batched_from_raw(
                    seqs, qual_bits, rec_ends, k, rc, W, is_reads, use_mq, 0,
                    strict_valid, has_qual,
                )
                int(nu[0])
            with record_function("ska::to_host"):
                kk, ss, nbytes = P.dict_to_host(sp[0], union[0], is_end[0])
            kparts.append(kk)
            sparts.append(ss)
        chunk_copy_bytes += nbytes
    chunked_samples += 1
    chunks += len(wparts) + len(kparts)
    chunk_rows += sum(len(x) for x in wparts + kparts)
    with record_function("ska::chunk_merge"):
        if want_count:
            order, first, totals = key_totals(np.concatenate(wparts),
                                              np.concatenate(cparts))
            # contribute iff the total occurrence count reaches min_count
            # (identical split pair for every occurrence of a whole k-mer)
            pk = np.concatenate(pparts)[order][first]
            pk = pk[totals >= qual.min_count]
            keys = P._shr_np(pk)
            sets = (pk[:, W - 1] & np.uint64(15)).astype(np.uint8)
        else:
            keys = (np.concatenate(kparts) if kparts
                    else np.zeros((0, W), np.uint64))
            sets = (np.concatenate(sparts) if sparts
                    else np.zeros(0, np.uint8))

        # merge across chunks / whole-kmer groups: sort by split key +
        # segmented union of the 4-bit sets
        if len(keys):
            order = np_lex_argsort(keys)
            keys, sets = keys[order], sets[order]
            first = np.ones(len(keys), bool)
            first[1:] = (keys[1:] != keys[:-1]).any(axis=-1)
            # segmented OR via reduceat (ufunc.at is unbuffered and ~100x
            # slower at genome scale)
            sets = np.bitwise_or.reduceat(sets, np.flatnonzero(first))
            keys = keys[first]
        return keys.astype(np.uint64), sets.astype(np.uint8)

