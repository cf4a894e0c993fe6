"""Merged cohort build: the device half of
ska_tpu/sample.py::build_samples_merged, with the port's copies of its
host helpers.

Host parsing, grouping by padded length, the batch size
(``_auto_max_batch``), power-of-two batch padding and the packed staging
are copies of the JAX package's functions, so every batch and every
output byte lines up with it. The batch then runs on the port's device
pipeline (ops/pipeline.py).

Each step runs inside a ``torch.profiler.record_function`` span named
``ska::<step>`` (parse, stage, to_device, device_pass, to_host; api.py
adds union and cli.py save). The spans cost nothing measurable when no
profiler runs; under one they give each step's host wall time beside
the device's kernel time (chip_smoke.py, phase 4). Each span ends where
the code already waits for the card, so the spans add no sync.
"""

import concurrent.futures as cf
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .constants import check_k
from .io import fastx
from .ops import keys as K
from .ops import pipeline as P
from .ops.npkeys import width_for_k
from .progress import Bar
from .torchinit import get_device


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


def _auto_max_batch(Lp: int) -> int:
    """Samples per merged dispatch, as the JAX package chooses them:
    scale inversely with the padded length under a ~128M-base budget,
    at most 32. SKA_MAX_BATCH overrides."""
    env = os.environ.get("SKA_MAX_BATCH")
    if env:
        return max(1, int(env))
    eff = max(1, min(32, (1 << 27) // max(Lp, 1)))
    # The dispatch pads the batch axis up to the next power of two, so a
    # non-power-of-two here would silently double the device work (e.g.
    # 17 samples padded to 32 rows). Round down to a power of two.
    eff = 1 << (eff.bit_length() - 1)
    # The merged pipeline's variants scatter is an (S*Lp, S) buffer.
    # Cap it at 1 GB, which also keeps the scatter's int32 index space
    # (rows * S + sample < 2^31) safe: 32 x 4 Mb genomes would otherwise
    # demand a 4.3 GB buffer.
    while eff > 1 and Lp * eff * eff > (1 << 30):
        eff //= 2
    return eff


def _check_all_present(var_np, n_rows, paths):
    """A sample with zero k-mers panics in the reference
    (ska_dict.rs:374-376): column col of the variants matrix must carry
    at least one non-gap base; paths[col] names the offending input."""
    present = (
        (var_np != ord("-")).any(axis=0)
        if n_rows
        else np.zeros(len(paths), bool)
    )
    for col, path in enumerate(paths):
        if not present[col]:
            raise ValueError(f"{path} has no valid sequence")


def _stage_packed(batches, Lp, min_qual=0):
    """Host staging for the packed-transfer device path: 2-bit base
    codes (4 per byte, first base in bits 7-6), packed per-base validity
    bits (not-N and not-padding, the reference's valid_base rule
    bit_encoding.rs:52-54 — other IUPAC letters 2-bit-project, quirk
    preserved), packed quality-pass bits, and record-end indices.
    0.375 bytes/base crosses the link for FASTA (vs 1 raw byte), 0.5
    for FASTQ. Lp must be a multiple of 8 (pow2 buckets are).
    """
    S = len(batches)
    has_qual = all(bool(b.has_qual) for b in batches)
    seq2 = np.zeros((S, Lp // 4), np.uint8)
    valid_bits = np.zeros((S, Lp // 8), np.uint8)
    qual_bits = np.zeros((S, Lp // 8 if has_qual else 1), np.uint8)
    Eb = _bucket_min(max(int(b.rec_last.sum()) for b in batches), 16)
    rec_ends = np.full((S, Eb), Lp, np.int32)
    for i, b in enumerate(batches):
        L = len(b.seq)
        seq = np.zeros(Lp, np.uint8)
        seq[:L] = b.seq
        codes = (seq >> 1) & 3
        seq2[i] = (
            (codes[0::4] << 6) | (codes[1::4] << 4)
            | (codes[2::4] << 2) | codes[3::4]
        )
        valid_bits[i] = np.packbits(((seq & 0xF) != 14) & (seq != 0))
        if has_qual:
            ok = np.zeros(Lp, bool)
            ok[:L] = ((b.qual.astype(np.int16) - 33) > min_qual) | (
                b.qual == 0xFF
            )
            qual_bits[i] = np.packbits(ok)
        ends = np.flatnonzero(b.rec_last).astype(np.int32)
        rec_ends[i, : len(ends)] = ends
    return seq2, valid_bits, qual_bits, rec_ends, has_qual


def _max_chunk_bases() -> int:
    """Device dispatch cap in bases; inputs beyond it build chunked
    (bounded HBM, like the reference's streaming reads)."""
    # default just under a pow2 so the padded chunk bucket stays 2^26
    return int(os.environ.get("SKA_MAX_CHUNK_BASES", str((1 << 26) - 128)))


def build_samples_merged(input_files, k: int, rc: bool, qual,
                         proportion_reads=None, max_batch=None, device=None):
    """Build and merge a FASTA cohort, one device pass per batch.

    Returns the list of (input indices, names, keys, variants, counts)
    batch results that ska_tpu.sample.build_samples_merged returns;
    api.build unions them and restores the input column order.
    """
    check_k(k)
    dev = get_device(device)
    with record_function("ska::parse"), cf.ThreadPoolExecutor(8) as pool:
        prepared = list(pool.map(
            lambda t: prepare_sample((t[1], t[2]), proportion_reads),
            input_files,
        ))

    cap = _max_chunk_bases()
    groups = {}
    for i, (batch, is_reads) in enumerate(prepared):
        path = input_files[i][1]
        if is_reads:
            raise NotImplementedError(
                f"{path}: FASTQ builds are not ported yet (ROADMAP A8)")
        if len(batch.seq) + k + 1 > cap:
            raise NotImplementedError(
                f"{path}: samples over {cap} bases need the chunked "
                "build, which is not ported yet (ROADMAP A8)")
        groups.setdefault(_bucket(len(batch.seq) + k + 1), []).append(i)

    W = width_for_k(k)
    out = []
    bar = Bar(len(prepared), "samples")
    for Lp, idxs in groups.items():
        eff_batch = max_batch or _auto_max_batch(Lp)
        for c0 in range(0, len(idxs), eff_batch):
            chunk = idxs[c0 : c0 + eff_batch]
            # the batch axis is padded to a power of two, as in the JAX
            # package; pad rows are all-zero bytes and produce no k-mers
            S = 1 << (len(chunk) - 1).bit_length()
            with record_function("ska::stage"):
                staged = _stage_packed(
                    [prepared[i][0] for i in chunk], Lp, int(qual.min_qual)
                )
                has_qual = staged[4]
                padded = []
                for a, fill in zip(staged[:4], (0, 0, 0, Lp)):
                    rows = np.full((S, a.shape[1]), fill, a.dtype)
                    rows[: len(chunk)] = a
                    padded.append(torch.from_numpy(rows))
            with record_function("ska::to_device"):
                padded = [x.to(dev) for x in padded]
            with record_function("ska::device_pass"):
                ukeys, variants4, _counts, n_rows = P.merged_build_from_packed(
                    *padded, k, rc, W, False, False, int(qual.min_count),
                    False, has_qual,
                )
                n = int(n_rows)
            with record_function("ska::to_host"):
                keys_np = K.to_numpy_keys(ukeys[:n])
                # 4-bit packed codes -> ASCII, dropping the batch pad columns
                var_np = P.unpack_variants4(variants4[:n].cpu().numpy(),
                                            len(chunk))
                # counted on the host from the matrix, as the JAX package does
                counts_np = (var_np != ord("-")).sum(axis=1).astype(np.int64)
            _check_all_present(var_np, n, [input_files[i][1] for i in chunk])
            names = [input_files[i][0] for i in chunk]
            out.append((chunk, names, keys_np, var_np, counts_np))
            bar.update(len(chunk))
    bar.finish()
    return out
