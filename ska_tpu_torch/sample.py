"""Merged cohort build: the device half of
ska_tpu/sample.py::build_samples_merged.

Host parsing, grouping by padded length, the batch size
(``_auto_max_batch``), power-of-two batch padding and the packed staging
are the JAX package's own functions, imported unchanged, so every batch
and every output byte lines up with it. The batch then runs on the
port's device pipeline (ops/pipeline.py).

Each step runs inside a ``torch.profiler.record_function`` span named
``ska::<step>`` (parse, stage, to_device, device_pass, to_host; api.py
adds union and cli.py save). The spans cost nothing measurable when no
profiler runs; under one they give each step's host wall time beside
the device's kernel time (chip_smoke.py, phase 4). Each span ends where
the code already waits for the card, so the spans add no sync.
"""

import concurrent.futures as cf

import numpy as np
import torch
from ska_tpu.constants import check_k
from ska_tpu.ops.npkeys import width_for_k
from ska_tpu.progress import Bar
from ska_tpu.sample import (
    _auto_max_batch,
    _bucket,
    _check_all_present,
    _max_chunk_bases,
    _stage_packed,
    prepare_sample,
)

from torch.profiler import record_function

from .ops import keys as K
from .ops import pipeline as P
from .torchinit import get_device


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
