#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ska_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--dist-only]
    python3 chip_smoke.py --lookup-only [--lookup-variants SRC]

Run from the root of a checkout; it needs one CUDA card and refuses to
run without one. --dist-only runs phase 1, builds what phase 9 compares
with, phase 9 and graft_entry.dryrun_multichip on every card: for a
machine of several cards. --lookup-only runs phase 1 and phase 2's
lookup (the edge cases, map's shape, the sweep); --lookup-variants SRC
adds an earlier splitter-window lookup kernel, the lower_bound.cu at
SRC, as it is and forced to one block an SM, to the sweep and times all
of them on the real table of phase 7 (a k=31 build of the cohort).
Twelve phases, and any
failure ends the run with a non-zero exit (nothing is caught, nothing
moves to the CPU or to gloo):

1. Build the port's native libraries from the sources in the checkout,
   all at once: the radix sort and lookup kernels (nvcc, one process
   each) and the host library (g++: the .skf codec, the batch union, the
   site filters).
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: the radix sort at N = 2^25 rows of (key limbs,
   int32 sample id, uint8 IUPAC set) for W=1 and W=2, on tie-heavy rows
   with all-ones sentinels. Both sorts are stable, so every operand, the
   payload included, must be equal. The kernel's and the plain version's
   times, the bound (each operand read once and written once at the
   card's 3.35 TB/s), the share of the bound, the launches per sort and
   each kernel's device time in one sort (torch.profiler) are printed.
   Then the reads build's layout (num_keys == W: the int32 rides along
   as payload) at N = 2^26 rows, one sample's rank sort at full width:
   62- and 126-bit whole k-mer limbs (W=1, W=2), each key about 24
   times, 1/8 sentinels, int32 = arange and a uint8 payload; every
   operand equal to the plain sort's, and at W=1 the library yardstick,
   torch.sort(limb ^ SIGN, stable=True) plus the uint8 gather, which
   gives the same order and positions. Last, the (key, sample id) layout
   at W=1 once more at N = 2^27 rows with 2 sample ids, the shape of
   phase 5's global sort (2 samples x 2^26), every operand equal. Then
   the lookup kernel (csrc/lower_bound.cu, ops/keys.py lower_bound), map's
   lookup: 2^21 queries (95% present, some shared by many rows, 64
   all-ones) in a sorted table of 2^23 unique 60-bit (W=1) or 124-bit
   (W=2) keys, and the edge cases (no keys, no queries, one key, runs of
   equal keys, a mostly all-ones table, W=2 keys whose first limbs tie,
   and the plan's boundaries: as many keys as the splitters hold with no
   level, one more and a quarter more, a ragged last line, and a table
   viewed at an odd int64 offset), every lower bound equal to the plain
   binary search's (ops/keys.py searchsorted); at W=1 torch.searchsorted
   on the sign-biased limb too, the library yardstick. Timed in turns
   beside the plain search, the yardstick and the route the kernel
   replaced (the radix kernel's limbs-only sort of [queries; table],
   then a cumsum and a scatter), each call alone after an L2 flush; the
   kernel and the yardstick also back to back and as device time
   (profiler); with the bound (each key and query read once, each answer
   written once). Then the sweep: 2^21 queries in tables of 2^22,
   4,500,000, 6,447,824, 2^23, 12,000,000 and 2^24 keys at W=1 and 2^22
   and 2^23 at W=2, made on the card, answers equal to the plain
   search's (and torch.searchsorted's), the kernel and at W=1 the
   library timed in turns: per call after an L2 flush, device time,
   back to back, and the card's and the host's time a call for calls
   queued behind a sleep kernel.
3. The main path: `ska build` of a cohort of 21 related 2 Mb genomes
   (S. pneumoniae size; each a 1.95 Mb chromosome plus a 50 kb plasmid
   with ~0.5% SNPs, short indels, an N run and IUPAC letters, made from
   --seed) at k=31, then `ska align`, through the CLI entry point of
   `python -m ska_tpu_torch` with --device cuda; then k=63 on the first 4
   genomes. The radix kernel must have been launched during each run
   (launch counters zeroed just before it). The .skf bytes must equal those of
   the port's plain route, `python -m ska_tpu_torch build --device cpu`,
   on the same files; the CPU tests hold that route byte for byte to the
   JAX package. The alignment must have one row per genome, all of one
   length.
4. The k=31 build twice more: once warm without the profiler, then
   under torch.profiler: host wall time of each `ska::` step span,
   device time of the largest kernels, and the share of the build's
   wall time in which the card ran nothing.
5. Reads at full width: paired 2 x 150 bp reads (inserts 300-500 bp,
   0.2% substitutions, PHRED+33 qualities mostly 30-40 with ~1% below
   20, a few Ns) of genomes 00-04 of phase 3's cohort, 30x for 00-03
   (~60.4 Mb of bases each: the merged path, two batches of 2 x 2^26)
   and 60x for 04 (~121 Mb, over the dispatch cap: the chunked
   count pipeline, two chunks of 2^26). `build -f samples.tsv -k 31`
   with the defaults (min-count 5, strict, min-qual 20) on the card,
   then `align`; each sample's FASTQ column must hold >= 99% of the
   split k-mers of its genome's column of phase 3's k31.skf, and the
   other way round. Then `cov` of genome 00's pair (one dispatch of
   2^26 rows), and the reads build once more under torch.profiler.
6. Reads exactly against the plain CPU route: the first 200,000 bases
   of genomes 00-04 with the same read model, SKA_MAX_CHUNK_BASES =
   8388480 in both routes (00-03 in one merged batch, 04 in two
   chunks): `build -k 31 --min-count auto` and `build -k 63 --min-count
   1 --qual-filter middle`, .skf bytes and stdout equal to those of
   `python -m ska_tpu_torch build --device cpu` run in a process of its
   own; `cov` stdout of pairs 00 (one dispatch) and 04 (chunked) equal.
7. `ska map` of phase 3's k31.skf to genome00.fa (two records) as aln,
   VCF and aln with --ambig-mask --repeat-mask, and of k63.skf as aln,
   on the card, each output's bytes equal to the plain CPU route's (a
   process of its own); `ska weed` of the reference's split k-mers
   (scanned on the card) from k31.skf, .skf bytes equal to the CPU
   route's; the aln once more with SKA_MAX_CHUNK_BASES = 1048448, so
   that the chromosome extracts in k-1-overlap slices, equal to the
   unsliced bytes; the lookup kernel launched in every card map; a warm
   k=31 VCF map under torch.profiler (spans and device); then that map's
   own lookup (k31.skf's keys, the reference's split k-mers) by the
   lookup kernel and by torch.searchsorted, answers equal, timed in
   turns as in phase 2, and both back to back on uniform random keys and
   queries of the same shape.
8. `ska distance` of k31.skf, plain, --min-freq 0.5 and
   --allow-ambiguous, TSV bytes equal to the CPU route's; then the class
   Gram of k31.skf's variable sites and of 512 samples x 2^20 sites on a
   random tree (made from --seed) by the port (int8 products) and by the
   plain version (host dedupe as in the JAX package, then weighted f32
   products), equal as int64, with each one's time beside its matmul
   bound.
9. The sharded paths (ska_tpu_torch/parallel/) on an NCCL group of
   torch.cuda.device_count() ranks, one process per card (ranks 1.. are
   processes of this script; with one card the group has one rank, and
   NCCL takes no two ranks on one card), through their functions:
   build_samples_distributed of phase 3's cohort at k=31 and k=63,
   keys, variants, counts and names equal to its .skf files;
   distributed_lookup of genome00.fa's split k-mers in k31.skf, equal to
   the plain binary search's; distributed_class_gram of phase 8's two
   inputs, equal to its int64 Grams; each call's wall time and kernel
   launches; the k=31 and k=63 builds and the lookup once more under
   torch.profiler, with the radix kernels' (the builds) or the lookup
   kernels' device time beside their bound (the operands of every call
   read once and its outputs written once).
10. The host commands, through the CLI with --device cuda, each with no
   kernel launched: `ska nk` (and --full-info) of k31.skf;
   `ska delete` of genomes 04-20 (a -f list) and of 00-03 from k31.skf,
   then `ska merge` of the two halves, equal to k31.skf in keys,
   variants, counts and names; `ska lo` of the first 50,000 bases of
   the chromosomes of genomes 00-03 (built on the card at k=31 and
   k=63), at k=31 with genome 00's cut chromosome as the reference at
   --threads 1 and min(8, cores), all four output files byte-equal, and
   at k=63 without a reference; each run's wall time and the stage times
   of its -v log (graph walk, group assembly, path filter, SNP stage).
11. The front ends, through their functions on the card: webapi.py's
   SkaData at k=31 indexes genome00.fa (two records, two JSON chunks)
   and maps genomes 01, 02 and 03 (FASTA) and genome 03's 30x pair of
   phase 5 (one dispatch of 2^26 rows, no count or quality filter), then
   get_reference(); at k=63 it maps genome 01; AlignData at k=31 aligns
   genomes 00-07 (one batched dispatch of 8 x 2^21), then adds genome
   08 and the 30x pair (the pairing heuristic, the build cache, a
   10-taxon NJ tree). SkaData and AlignData also run on the first
   200,000 bases of genomes 00-02's chromosomes and phase 6's read pairs
   of genomes 03 and 04. Every FASTA call and every cut-reads call must
   give the JSON string of the plain CPU route (this script with
   --webapi-cpu, a process of its own, in a thread beside the card's
   calls); the 30x reads query must map at least 99% of the reference
   positions that genome03.fa maps; every map and align call must launch
   the radix kernel, and every map the lookup kernel; a warm k=31 FASTA
   map once more under torch.profiler gives both kernels' device time
   per call. Then graft_entry.entry()'s step on the card, every
   output equal to the same step on the CPU, and
   graft_entry.dryrun_multichip(torch.cuda.device_count()) on NCCL
   (rows > 0, the radix kernel launched on rank 0). The radix sorts of
   the card's calls, of the profiled map and of entry() are logged by
   shape with their bound.
12. The CLI's two switches, each command `python -m ska_tpu_torch ...
   --device cuda` in a process of its own under SKA_PROFILE=<dir> and
   SKA_DISPATCH_STATS=1: `build -k 63` of phase 3's first 4 genomes
   (.skf bytes equal to phase 3's k63.skf, the stats line's launches
   equal to those phase 3 counted in-process for that build, a
   ska::device_pass span and the radix kernel's scatter_kernel events in
   the trace), `map -f vcf` of genome00.fa to k31.skf (bytes equal to
   phase 7's, 2 lookup launches, search_kernel events) and `nk` of
   k31.skf (no launch, a trace without a CUDA event); each one trace
   file and one stats line, no kernel built again (kernel_builds 0); the
   hand-written kernels' device time in each trace and their share of
   its traced wall time. A trace without the kernels' device events is
   taken again, up to 3 runs.

The last lines are the card's name and power limit (nvidia-smi), one
JSON line with each kernel's launches, error and times, and the result
line {"ok": true, "device": {...}}.
"""

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
SORT_LOG2 = 25  # rows of the k=31 build's first batch: 16 genomes x 2^21
READS_SORT_LOG2 = 27  # rows of phase 5's global sort: 2 samples x 2^26
LIMBS_LOG2 = 26  # rows of one 30x sample's rank sort in phase 5 (Lp = 2^26)
GENOMES = 21
GENOMES_K63 = 4
CHROMOSOME = 1_950_000  # bases; the plasmid takes the rest of 2,000,000
READ_LEN = 150
INSERT = (300, 500)  # fragment lengths, inclusive
DEPTHS = (30, 30, 30, 30, 60)  # reads samples: genomes 00-04
SMALL_BASES = 200_000  # phase 6: the first bases of each genome
SMALL_CAP = 8_388_480  # phase 6's SKA_MAX_CHUNK_BASES: Lp = 2^23
LOOKUP_TABLE_LOG2 = 23  # keys of a .skf of ~21 genomes of 2 Mb, rounded up
LOOKUP_QUERY_LOG2 = 21  # split k-mers of a 2 Mb reference
MAP_SLICE_CAP = 1_048_448  # phase 7's sliced run: 2^20 - 128 bases a slice
GRAM_SAMPLES = 512  # phase 8's cohort-size Gram: samples ...
GRAM_SITES_LOG2 = 20  # ... and variable sites
LO_GENOMES = 4  # phase 10's lo cohort: genomes 00-03 ...
LO_BASES = 50_000  # ... cut to the first bases of the chromosome
ALL_ONES = 0xFFFFFFFFFFFFFFFF
DEVICE = "cuda"


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 2


def sort_rows(torch, W, N, seed, dev, n_ids=16):
    """Tie-heavy rows made on the card: few distinct keys (top bits set),
    1/8 all-ones sentinels, n_ids sample ids, random 4-bit sets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    limbs = [torch.randint(0, 4096, (N,), generator=g, device=dev) * GOLDEN]
    if W == 2:
        limbs.insert(0, torch.randint(0, 3, (N,), generator=g, device=dev))
    sent = torch.rand(N, generator=g, device=dev) < 0.125
    limbs = [torch.where(sent, -1, x).contiguous() for x in limbs]
    sid = torch.randint(0, n_ids, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    sets = torch.randint(1, 16, (N,), generator=g, device=dev, dtype=torch.uint8)
    return tuple(limbs) + (sid, sets)


def time_ms(torch, fn, reps):
    """Per-call milliseconds by CUDA events, after a synchronize."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def sort_bound(W, N, keys=None):
    """Least time for one sort: each operand read once and written once
    at the card's memory rate, against N * ceil(log2 N) key-row
    comparisons of `keys` words (W+1 by default) at its non-tensor rate;
    the larger wins."""
    t_bytes = 2 * (8 * W + 5) * N / HBM_BYTES_PER_S
    t_ops = N * (N - 1).bit_length() * (keys or W + 1) / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_sort(torch, SO, W, seed, dev, log2=SORT_LOG2, n_ids=16):
    """The (key, sample id) layout at N = 2^log2 rows with n_ids sample
    ids: kernel against plain on every operand, times and launches."""
    N = 1 << log2
    ops = sort_rows(torch, W, N, seed + W, dev, n_ids)
    before = SO.radix_launches
    got = SO._sort_cuda(ops, W + 1)
    launches = SO.radix_launches - before
    want = SO._sort_plain(ops, W + 1)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g != w).sum()))
    check(err == 0, f"radix W={W}: {err} rows differ from the plain sort")
    check(bool((got[0][-1] == -1).all()), "sentinels sort last")
    check(launches == 2 + 8 * W, f"radix W={W}: {launches} launches per "
          f"sort, expected {2 + 8 * W} (histogram + 1 + 8W digit passes)")
    # alternate plain, kernel, kernel, plain on one card
    kern, plain = [], []
    for _ in range(3):
        plain += time_ms(torch, lambda: SO._sort_plain(ops, W + 1), 1)
        kern += time_ms(torch, lambda: SO._sort_cuda(ops, W + 1), 2)
        plain += time_ms(torch, lambda: SO._sort_plain(ops, W + 1), 1)
    bound, bound_by = sort_bound(W, N)
    split = kernel_split(torch, lambda: SO._sort_cuda(ops, W + 1))
    res = {
        "max_abs_err": float(err),
        "ms": statistics.median(kern),
        "plain_ms": statistics.median(plain),
        "bound_ms": bound,
        "bound_by": bound_by,
        "launches_per_sort": launches,
    }
    log(f"phase 2: radix sort W={W} N=2^{log2}, {n_ids} sample ids: kernel "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
        f"{bound:.3f} ms by {bound_by} ({100 * bound / res['ms']:.2f}% of "
        f"the bound), {launches} launches per sort (median of 6 each; "
        f"kernel runs {[round(x, 3) for x in kern]}, plain runs "
        f"{[round(x, 3) for x in plain]}); every operand equal to the plain "
        f"sort's")
    for name, (n, ms) in split.items():
        log(f"phase 2:   W={W} device {ms:.3f} ms in {n} launches "
            f"({ms / n:.3f} ms each): {name}")
    del ops, got, want
    torch.cuda.empty_cache()
    return res


def limb_rows(torch, W, N, seed, dev):
    """Rows as the reads build sorts them by the limbs alone (made on the
    card): whole k-mer limbs of 62 bits (W=1) or 62 + 64 bits (W=2),
    each key about 24 times, 1/8 all-ones sentinels; int32 = arange(N)
    and a random uint8 payload."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(bits):
        x = torch.randint(0, 1 << 32, (N // 24,), generator=g, device=dev)
        y = torch.randint(0, 1 << 32, (N // 24,), generator=g, device=dev)
        return ((x << 32) | y) & ((1 << bits) - 1 if bits < 64 else -1)

    pool = [rand(62)] + ([rand(64)] if W == 2 else [])
    idx = torch.randint(0, N // 24, (N,), generator=g, device=dev)
    sent = torch.rand(N, generator=g, device=dev) < 0.125
    limbs = [torch.where(sent, -1, p[idx]).contiguous() for p in pool]
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    flags = torch.randint(0, 32, (N,), generator=g, device=dev,
                          dtype=torch.uint8)
    return tuple(limbs) + (pos, flags)


def phase_sort_limbs(torch, SO, W, seed, dev):
    """The num_keys == W layout at N = 2^26: kernel against plain on
    every operand; at W=1 also the library yardstick."""
    from ska_tpu_torch.ops.keys import SIGN

    N = 1 << LIMBS_LOG2
    ops = limb_rows(torch, W, N, seed + 10 + W, dev)
    before = SO.radix_launches
    got = SO._sort_cuda(ops, W)
    launches = SO.radix_launches - before
    want = SO._sort_plain(ops, W)
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        err = max(err, int((g != w).sum()))
    check(err == 0, f"radix limbs W={W}: {err} rows differ from the plain sort")
    check(bool((got[0][-1] == -1).all()), "sentinels sort last")
    check(launches == 1 + 8 * W, f"radix limbs W={W}: {launches} launches "
          f"per sort, expected {1 + 8 * W} (histogram + 8W limb digits)")

    def library():
        values, idx = torch.sort(ops[0] ^ SIGN, stable=True)
        return values, idx, ops[W + 1].gather(0, idx)

    lib_ms = None
    if W == 1:
        lv, li, lf = library()
        check(bool(((lv ^ SIGN) == got[0]).all() and (li == got[1]).all()
                   and (lf == got[2]).all()),
              "torch.sort yardstick differs from the kernel")
    # alternate plain, kernel, kernel, plain (and the library) on one card
    kern, plain, lib = [], [], []
    for _ in range(3):
        plain += time_ms(torch, lambda: SO._sort_plain(ops, W), 1)
        kern += time_ms(torch, lambda: SO._sort_cuda(ops, W), 2)
        if W == 1:
            lib += time_ms(torch, library, 2)
        plain += time_ms(torch, lambda: SO._sort_plain(ops, W), 1)
    if lib:
        lib_ms = statistics.median(lib)
    bound, bound_by = sort_bound(W, N, keys=W)
    res = {
        "max_abs_err": float(err),
        "ms": statistics.median(kern),
        "plain_ms": statistics.median(plain),
        "library_ms": lib_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "launches_per_sort": launches,
    }
    lib_txt = "" if lib_ms is None else (
        f", library torch.sort + gather {lib_ms:.3f} ms (runs "
        f"{[round(x, 3) for x in lib]})")
    log(f"phase 2: radix sort by the limbs alone W={W} N=2^{LIMBS_LOG2}: "
        f"kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms"
        f"{lib_txt}, bound {bound:.3f} ms by {bound_by} "
        f"({100 * bound / res['ms']:.2f}% of the bound), {launches} launches "
        f"per sort (kernel runs {[round(x, 3) for x in kern]}, plain runs "
        f"{[round(x, 3) for x in plain]}); every operand equal to the plain "
        f"sort's")
    del ops, got, want
    torch.cuda.empty_cache()
    return res


def lookup_case(W, seed):
    """map's lookup at full size, as numpy uint64 keys: a sorted table of
    2^23 unique keys of 60 bits (W=1) or 60 + 64 bits (W=2, about 8 keys
    to each hi limb, so the lo limb decides often), the last one
    all-ones; 2^21 queries, 95% of them table keys (a twentieth of those
    drawn from 256 keys that many rows share), 5% absent (at W=2 a
    table key's hi limb with another lo limb), 64 all-ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N, M = 1 << LOOKUP_TABLE_LOG2, 1 << LOOKUP_QUERY_LOG2
    extra = N + N // 16
    cols = [rng.integers(0, 1 << 60, size=extra, dtype=np.uint64)]
    if W == 2:
        cols = [rng.choice(cols[0][: N // 8], size=extra),
                rng.integers(0, ALL_ONES, size=extra, dtype=np.uint64,
                             endpoint=True)]
    order = np.lexsort(cols[::-1])
    keys = np.stack([c[order] for c in cols], axis=-1)
    first = np.ones(len(keys), bool)
    first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    keys = keys[first]
    keys = keys[np.sort(rng.choice(len(keys), N - 1, replace=False))]
    table = np.concatenate([keys, np.full((1, W), ALL_ONES, np.uint64)])
    idx = rng.integers(0, N, size=M)
    shared = rng.random(M) < 0.05
    idx[shared] = rng.choice(N, 256)[rng.integers(0, 256, int(shared.sum()))]
    queries = table[idx]
    absent = rng.random(M) < 0.05
    queries[absent, W - 1] = rng.integers(
        0, 1 << 60 if W == 1 else ALL_ONES, size=int(absent.sum()),
        dtype=np.uint64, endpoint=W == 2)
    queries[rng.integers(0, M, 64)] = ALL_ONES
    return table, queries


def lookup_edges(W, seed):
    """The lookup's edge cases as (name, table, queries, offset), numpy
    uint64 keys: no keys, no queries, one key, runs of equal keys, a
    table that is mostly all-ones (a third of the queries all-ones), at
    W=2 runs of tied first limbs, and the plan's boundaries (ops/lookup.py
    plan): as many keys as the splitters hold with no level (one
    splitter a line), one more and a quarter more (a top of two lines),
    a ragged last line in the first table with a level (N = R - 1 mod R,
    R rows a line), and one more than the splitters hold at two lines
    searched as a view at an odd int64 offset (`offset` 1: the
    misaligned loads). Most queries lie just below, on or just above a
    table key."""
    import numpy as np

    from ska_tpu_torch.ops.lookup import SPLITTER_BYTES, line_rows

    rng = np.random.default_rng(seed)
    R = line_rows(W)
    full = SPLITTER_BYTES // (8 * W) * R  # keys the splitters hold, no level

    def rand(n):
        return rng.integers(0, ALL_ONES, size=(n, W), dtype=np.uint64,
                            endpoint=True)

    def srt(keys):
        return keys[np.lexsort(keys.T[::-1])] if len(keys) else keys

    def near(keys, m):
        q = keys[rng.integers(0, len(keys), m)]
        with np.errstate(over="ignore"):
            q[:, -1] += rng.integers(-1, 2, m).astype(np.uint64)
        return q

    ones = np.full((1, W), ALL_ONES, np.uint64)
    one = rand(1)
    runs = srt(np.repeat(rand(300), rng.integers(1, 200, 300), axis=0))
    mostly = srt(np.concatenate([rand(100), np.repeat(ones, 30000, axis=0)]))
    q_mostly = near(mostly, 20000)
    q_mostly[::3] = ALL_ONES
    cases = [
        ("no keys", rand(0), rand(1000), 0),
        ("no queries", srt(rand(1000)), rand(0), 0),
        ("one key", one, np.concatenate([near(one, 100), ones, 0 * ones]), 0),
        ("runs", runs, near(runs, 20000), 0),
        ("mostly all-ones", mostly, q_mostly, 0),
    ]
    if W == 2:
        hi = rand(8)[:, 0]
        hi[0] = ALL_ONES
        ties = np.stack([rng.choice(hi, 50000), rand(50000)[:, 0]], -1)
        ties[:2000, 1] = 0
        ties[2000:4000, 1] = ALL_ONES
        ties = srt(ties)
        q_ties = near(ties, 20000)
        q_ties[::7, 1] = rand(len(q_ties[::7]))[:, 0]
        cases.append(("tied first limbs", ties, q_ties, 0))
    for n, what, offset in ((full, "splitters full", 0),
                            (full + 1, "one more", 0),
                            (full + full // 4, "a quarter more", 0),
                            (2 * full + R - 1, "ragged last line", 0),
                            (2 * full + 1, "view at an odd int64 offset", 1)):
        t = srt(rand(n))
        cases.append((f"{n} keys, {what}", t,
                      np.concatenate([near(t, 5000), rand(1000)]), offset))
    return cases


def card_view(torch, TK, keys, offset, dev):
    """numpy uint64 keys on the card, as a view `offset` int64 words into
    a buffer of its own (0: the tensor itself)."""
    t = TK.from_numpy_keys(keys, dev)
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=torch.int64, device=dev)
    flat[offset:] = t.reshape(-1)
    view = flat[offset:].view(t.shape)
    check(view.data_ptr() % 16 == 8 * (offset % 2), "the view's alignment")
    return view


def old_lookup(torch, SO, table, queries):
    """The route the lookup kernel replaced, rebuilt from
    ops/sort.py: the radix kernel's limbs-only sort of [queries; table]
    carrying int32 positions and a uint8 query flag (stable, so each
    query sorts before the keys equal to it), a cumsum of the flags, and
    one scatter of the lower bounds into query order."""
    N, W = table.shape
    M = queries.shape[0]
    dev = queries.device
    both = torch.cat([queries, table])
    pos = torch.arange(M + N, dtype=torch.int32, device=dev)
    ops = tuple(both[:, i].contiguous() for i in range(W)) + (
        pos, (pos < M).to(torch.uint8))
    got = SO._sort_cuda(ops, W)
    spos, is_q = got[W], got[W + 1].bool()
    table_before = torch.arange(M + N, device=dev) - (
        torch.cumsum(is_q, dim=0) - 1)
    out = torch.empty(M + 1, dtype=torch.int64, device=dev)
    out[torch.where(is_q, spos.long(), M)] = table_before
    return out[:M]


def lookup_bound(W, N, M):
    """Least time for one lookup: each key and query read once and each
    int64 answer written once at the card's memory rate, against the
    M * ceil(log2(N + 1)) comparisons of W words a search makes at the
    card's non-tensor rate; the larger wins."""
    t_bytes = (8 * W * (N + M) + 8 * M) / HBM_BYTES_PER_S
    t_ops = M * max(1, N.bit_length()) * W / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_lookup(torch, SO, LU, TK, W, seed, dev):
    """The lookup kernel (ops/keys.py lower_bound, csrc/lower_bound.cu)
    on the edge cases and at map's shape, every answer against the plain
    binary search (at W=1 the library call too); times in turns beside
    the route it replaced."""
    err = 0
    edges = lookup_edges(W, seed + 40 + W)
    for name, t_np, q_np, offset in edges:
        t = card_view(torch, TK, t_np, offset, dev)
        q = TK.from_numpy_keys(q_np, dev)
        got, want = TK.lower_bound(t, q), TK.searchsorted(t, q)
        check(got.shape == want.shape, f"lookup W={W} [{name}]: shape")
        e = int((got - want).abs().max()) if len(q_np) else 0
        check(e == 0, f"lookup W={W} [{name}]: the kernel's lower bounds "
              f"differ from the plain binary search's by up to {e}")
        err = max(err, e)
    log(f"phase 2: lookup kernel W={W}: {len(edges)} edge cases "
        f"({'; '.join(n for n, *_ in edges)}) equal to the plain binary "
        f"search")

    table_np, q_np = lookup_case(W, seed + 30 + W)
    N, M = len(table_np), len(q_np)
    table = TK.from_numpy_keys(table_np, dev)
    queries = TK.from_numpy_keys(q_np, dev)
    before = LU.lower_bound_launches
    lb = TK.lower_bound(table, queries)
    per_lookup = LU.lower_bound_launches - before
    want = TK.searchsorted(table, queries)
    e = int((lb - want).abs().max())
    check(e == 0, f"lookup W={W}: the kernel's lower bounds differ from the "
          f"plain binary search's by up to {e}")
    err = max(err, e)
    check(per_lookup == 2, f"lookup W={W}: {per_lookup} launches per lookup, "
          "expected 2 (levels, search)")
    ones = (queries == -1).all(dim=1)
    check(bool((lb[ones] == N - 1).all()), "all-ones queries find the last key")
    hits = float(TK.equal(table[lb.clamp(0, N - 1)], queries).float().mean())
    check(bool((old_lookup(torch, SO, table, queries) == lb).all()),
          f"lookup W={W}: the old sort route differs from the kernel")

    biased = (table[:, 0] ^ TK.SIGN, queries[:, 0] ^ TK.SIGN)

    def library():
        return torch.searchsorted(*biased)

    lib_ms = None
    if W == 1:
        check(bool((library() == lb).all()), "torch.searchsorted differs")
    # in turns on one card (plain, kernel, library, old route, plain),
    # each call timed alone after the 50 MB L2 is flushed, as map's one
    # lookup of a table finds it
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    kern, plain, lib, old = [], [], [], []
    for _ in range(3):
        plain += cold_ms(torch, lambda: TK.searchsorted(table, queries), 1, flush)
        kern += cold_ms(torch, lambda: TK.lower_bound(table, queries), 2, flush)
        if W == 1:
            lib += cold_ms(torch, library, 2, flush)
        old += cold_ms(torch, lambda: old_lookup(torch, SO, table, queries), 2,
                       flush)
        plain += cold_ms(torch, lambda: TK.searchsorted(table, queries), 1, flush)
    del flush
    if lib:
        lib_ms = statistics.median(lib)

    bound, bound_by = lookup_bound(W, N, M)
    split = kernel_split(torch, lambda: TK.lower_bound(table, queries))
    res = {
        "max_abs_err": float(err),
        "ms": statistics.median(kern),
        "plain_ms": statistics.median(plain),
        "library_ms": lib_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "launches_per_lookup": per_lookup,
        "old_route_ms": statistics.median(old),
        "device_ms": device_ms(split),
        "back_to_back_ms": back_to_back(
            torch, lambda: TK.lower_bound(table, queries)),
        "library_device_ms": None,
        "library_back_to_back_ms": None,
    }
    if W == 1:
        res["library_device_ms"] = device_ms(kernel_split(torch, library))
        res["library_back_to_back_ms"] = back_to_back(torch, library)
    lib_txt = "" if lib_ms is None else (
        f"; library torch.searchsorted on the sign-biased limb {lib_ms:.3f} ms "
        f"(runs {[round(x, 3) for x in lib]}), device "
        f"{ms_text(res['library_device_ms'])}, back to back "
        f"{res['library_back_to_back_ms']:.3f} ms a call")
    log(f"phase 2: map's lookup W={W}, {M} queries in {N} keys ({100 * hits:.2f}% "
        f"found), each call alone after an L2 flush: lookup kernel "
        f"{res['ms']:.3f} ms, plain binary search "
        f"{res['plain_ms']:.3f} ms, bound {bound:.3f} ms by {bound_by} "
        f"({100 * bound / res['ms']:.2f}% of the bound), device "
        f"{ms_text(res['device_ms'])}, back to back {res['back_to_back_ms']:.3f} "
        f"ms a call, {per_lookup} launches "
        f"per lookup; the old route (radix sort of the {N + M} rows, cumsum, "
        f"scatter) {res['old_route_ms']:.3f} ms{lib_txt} (kernel runs "
        f"{[round(x, 3) for x in kern]}, plain runs "
        f"{[round(x, 3) for x in plain]}, old route runs "
        f"{[round(x, 3) for x in old]}); lower bounds equal to the plain "
        f"binary search's, the old route's"
        + (" and the library's" if W == 1 else ""))
    for name, (n, ms) in split.items():
        log(f"phase 2:   W={W} device {ms:.3f} ms in {n} launches "
            f"({ms / n:.3f} ms each): {name}")
    del table, queries, biased, lb, want
    torch.cuda.empty_cache()
    return res


def sweep_case(torch, TK, W, N, seed, dev):
    """A sorted table of N unique keys and 2^LOOKUP_QUERY_LOG2 queries,
    made on the card: 60-bit keys at W=1; at W=2 60-bit first limbs
    shared by about 8 rows each and random second limbs. 95% of the
    queries are table keys, 5% random keys of the same kind."""
    g = torch.Generator(device=dev).manual_seed(seed)
    M = 1 << LOOKUP_QUERY_LOG2
    extra = N + N // 16

    def rand(n, bits):
        hi = torch.randint(0, 1 << 31, (n,), generator=g, device=dev)
        lo = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
        x = (hi << 32) | lo
        return x >> (63 - bits) if bits == 60 else x ^ torch.randint(
            0, 2, (n,), generator=g, device=dev) << 63

    if W == 1:
        keys = torch.unique(rand(extra, 60))
        keys = keys[torch.randperm(len(keys), generator=g, device=dev)[:N]
                    .sort().values][:, None]
    else:
        pool = rand(extra // 8, 60)
        hi = pool[torch.randint(0, len(pool), (extra,), generator=g,
                                device=dev)]
        lo = rand(extra, 64)
        order = torch.sort(lo ^ TK.SIGN, stable=True).indices
        order = order[torch.sort(hi[order], stable=True).indices]
        keys = torch.stack([hi[order], lo[order]], dim=-1)
        fresh = torch.ones(len(keys), dtype=torch.bool, device=dev)
        fresh[1:] = (keys[1:] != keys[:-1]).any(dim=1)
        keys = keys[fresh]
        keys = keys[torch.randperm(len(keys), generator=g, device=dev)[:N]
                    .sort().values]
    check(len(keys) == N, f"sweep W={W}: {len(keys)} unique keys, not {N}")
    queries = keys[torch.randint(0, N, (M,), generator=g, device=dev)]
    absent = torch.rand(M, generator=g, device=dev) < 0.05
    queries[absent, 0] = rand(int(absent.sum()), 60)
    return keys.contiguous(), queries.contiguous()


# the table sizes of the sweep, 2^21 queries each: W=1 across the plan's
# steps and the band of 4.2-7.3 M keys where the splitter-window design
# ran two blocks an SM, k31.skf's size among them; W=2 at 2^22 and 2^23
SWEEP = ((1, 1 << 22), (1, 4_500_000), (1, 6_447_824), (1, 1 << 23),
         (1, 12_000_000), (1, 1 << 24), (2, 1 << 22), (2, 1 << 23))


def queued_ms(torch, fn, calls=5, reps=3):
    """The card's ms a call, and the host's, for `calls` calls enqueued
    behind a ~5 ms sleep kernel: the events around the calls time the
    card alone (its kernels and the gaps between them, no host gap),
    and the host's clock times the enqueueing (median of `reps`)."""
    card, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        b.record()
        torch.cuda.synchronize()
        card.append(a.elapsed_time(b) / calls)
    return statistics.median(card), statistics.median(host)


def time_lookups(torch, fns, flush, reps=3):
    """Each of fns (name -> call) timed in turns on one card: per call
    alone after an L2 flush (median of 2 * reps), device time of one call
    (profiler; None where it saw no kernel), back to back, and queued_ms's
    card and host times: {name: {"ms", "device_ms", "back_to_back_ms",
    "queued_ms", "host_ms", "runs"}}."""
    runs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            runs[name] += cold_ms(torch, fn, 2, flush)
    out = {}
    for name, fn in fns.items():
        queued, host = queued_ms(torch, fn)
        out[name] = {
            "ms": statistics.median(runs[name]),
            "device_ms": (device_ms(kernel_split(torch, fn))
                          or device_total_ms(torch, fn)),
            "back_to_back_ms": back_to_back(torch, fn),
            "queued_ms": queued,
            "host_ms": host,
            "runs": [round(x, 4) for x in runs[name]],
        }
    return out


def times_text(times):
    return "; ".join(
        f"{name} {t['ms']:.4f} ms a call after an L2 flush, device "
        f"{ms_text(t['device_ms'])}, back to back {t['back_to_back_ms']:.4f} "
        f"ms, queued {t['queued_ms']:.4f} ms (host {t['host_ms']:.4f} ms a "
        f"call; runs {t['runs']})" for name, t in times.items())


def lookup_sweep(torch, TK, dev, seed, variants=None, cases=SWEEP):
    """The lookup kernel across table sizes: answers equal to the plain
    binary search's (and at W=1 to torch.searchsorted's), then the kernel
    (and at W=1 the library) timed in turns as time_lookups does, beside
    the bound. `variants` (name -> fn(table, queries)) are timed and
    checked beside them."""
    from ska_tpu_torch.ops.lookup import plan

    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    out = []
    for W, N in cases:
        table, queries = sweep_case(torch, TK, W, N, seed + N + W, dev)
        M = queries.shape[0]
        fns = {"kernel": lambda: TK.lower_bound(table, queries)}
        if W == 1:
            biased = (table[:, 0] ^ TK.SIGN, queries[:, 0] ^ TK.SIGN)
            fns["library"] = lambda: torch.searchsorted(*biased)
        for name, fn in (variants or {}).items():
            fns[name] = lambda fn=fn: fn(table, queries)
        want = TK.searchsorted(table, queries)
        for name, fn in fns.items():
            check(torch.equal(fn(), want), f"sweep W={W} N={N}: {name}'s "
                  "lower bounds differ from the plain binary search's")
        times = time_lookups(torch, fns, flush)
        bound, bound_by = lookup_bound(W, N, M)
        p = plan(N, W)
        out.append({"W": W, "N": N, "M": M, "bound_ms": bound,
                    "bound_by": bound_by, "levels": p.levels,
                    "top_lines": 1 << p.log_lines, "splitters": p.splitters,
                    **times})
        log(f"phase 2: lookup sweep W={W}, {M} queries in {N} keys (plan: "
            f"{p.splitters} splitters, {p.levels} levels, top "
            f"{1 << p.log_lines} lines): bound {bound:.4f} ms by {bound_by}; "
            + times_text(times) + "; answers equal")
        del table, queries, fns, want
        torch.cuda.empty_cache()
    del flush
    return out


# (b): the splitter-window design forced to one block an SM, with the
# carveout that holds its splitters
ONE_BLOCK_FROM = "  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;\n"
ONE_BLOCK_TO = (
    "  cudaFuncSetAttribute(kernel, "
    "cudaFuncAttributePreferredSharedMemoryCarveout,\n"
    "                       (smem + 1024) * 100 / (228 * 1024) + 1);\n"
    "  long long blocks = (long long)sms;\n")


def window_variants(torch, src):
    """The lookup's splitter-window design (a lower_bound.cu whose
    search lifts over shared-memory splitters, then over a window of
    8-byte table loads; its entry points ska_lower_bound_splitters and
    ska_lower_bound_search) from the source file `src`, built twice with
    nvcc: as it is, where the occupancy API picks the blocks an SM
    ("window"), and forced to one block an SM ("window_one_block").
    Returns name -> fn(table, queries) with that design's wrapper."""
    import ctypes

    from ska_tpu_torch import kernels

    with open(src) as f:
        text = f.read()
    check(text.count(ONE_BLOCK_FROM) == 1,
          f"{src}: not the splitter-window source")
    d = os.path.join(WORK, "variants")
    os.makedirs(d, exist_ok=True)
    srcs = {"window": text, "window_one_block": text.replace(ONE_BLOCK_FROM,
                                                             ONE_BLOCK_TO)}
    fns = {}
    for name, code in srcs.items():
        cu = os.path.join(d, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(code)
        so = kernels._compile(kernels._nvcc(), kernels.NVCC_FLAGS, [cu],
                              os.path.join(d, f"lib{name}.so"))
        with open(so + ".log") as f:
            log(f"window variant {name}: " + f.read().strip())
        lib = ctypes.CDLL(so)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ska_lower_bound_splitters.argtypes = [i32, p, i32, i32, p, p]
        lib.ska_lower_bound_search.argtypes = [i32, p, i64, p, i32, i32, p,
                                               i64, p, p]

        def run(table, queries, lib=lib):
            (n, W), m = table.shape, queries.shape[0]
            most = (1 << 17) // (8 * W)
            s = max(0, (n - 1).bit_length() - (most.bit_length() - 1))
            n_split = (n + (1 << s) - 1) >> s
            splitters = torch.empty((n_split, W), dtype=torch.int64,
                                    device=table.device)
            out = torch.empty(m, dtype=torch.int64, device=table.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ska_lower_bound_splitters(
                W, table.data_ptr(), s, n_split, splitters.data_ptr(),
                stream) if n_split else 0
            err = err or lib.ska_lower_bound_search(
                W, table.data_ptr(), n, splitters.data_ptr(), n_split, s,
                queries.data_ptr(), m, out.data_ptr(), stream)
            check(err == 0, f"window variant: CUDA error {err}")
            return out

        fns[name] = run
    return fns


def real_table_variants(torch, cli, TK, variants, seed):
    """The map's real table (phase 3's k31.skf of the cohort made from
    `seed`, built here, and genome00.fa's split k-mers, W=1): the lookup
    kernel, torch.searchsorted and `variants`, answers equal, timed in
    turns as time_lookups does."""
    from ska_tpu_torch import ref as R
    from ska_tpu_torch.io import skf

    cohort = make_cohort(GENOMES, seed)
    out = os.path.join(WORK, "k31")
    cli.main(["build", "-k", "31", "-o", out, "--device", DEVICE,
              *[p for p, _ in cohort]])
    arr = skf.load(out + ".skf")
    kmers = R.RefSka(31, cohort[0][0], arr.rc, False, False,
                     device=DEVICE).kmers
    table = TK.from_numpy_keys(arr.sorted_view()[0], DEVICE)
    queries = TK.from_numpy_keys(kmers, DEVICE)
    (N, W), M = table.shape, queries.shape[0]
    biased = (table[:, 0] ^ TK.SIGN, queries[:, 0] ^ TK.SIGN)
    fns = {"kernel": lambda: TK.lower_bound(table, queries),
           "library": lambda: torch.searchsorted(*biased)}
    for name, fn in variants.items():
        fns[name] = lambda fn=fn: fn(table, queries)
    want = TK.searchsorted(table, queries)
    for name, fn in fns.items():
        check(torch.equal(fn(), want), f"real table: {name} differs")
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=DEVICE)
    times = time_lookups(torch, fns, flush)
    bound, bound_by = lookup_bound(W, N, M)
    log(f"lookup variants on the real table, {M} queries in {N} keys, W=1: "
        f"bound {bound:.4f} ms by {bound_by}; " + times_text(times)
        + "; answers equal")
    return {"N": N, "M": M, "bound_ms": bound, **times}


def lookup_only(torch, TK, LU, SO, cli, dev, args, smi):
    """--lookup-only: phase 2's lookup (edge cases, map's shape, the
    sweep); with --lookup-variants SRC also the splitter-window design
    from SRC, as it is and at one block an SM, in the sweep and on the
    real table."""
    res = {W: phase_lookup(torch, SO, LU, TK, W, args.seed, dev)
           for W in (1, 2)}
    variants = (window_variants(torch, args.lookup_variants)
                if args.lookup_variants else {})
    sweep = lookup_sweep(torch, TK, dev, args.seed, variants)
    real = (real_table_variants(torch, cli, TK, variants, args.seed)
            if variants else None)
    print(smi)
    print(json.dumps({"lookup": res, "sweep": sweep, "real_table": real}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def cold_ms(torch, fn, reps, flush):
    """Per-call ms of `reps` calls of fn (CUDA events), each alone after
    the 50 MB L2 is flushed by zeroing `flush` (a 128 MB tensor), as a
    command's one call finds it."""
    out = []
    for _ in range(reps):
        flush.zero_()
        out += time_ms(torch, fn, 1)
    return out


def back_to_back(torch, fn, calls=20):
    """Per-call ms of `calls` calls between two events, warm: the card's
    time with the host's launch gaps hidden behind it."""
    return statistics.median(time_ms(
        torch, lambda: [fn() for _ in range(calls)], 3)) / calls


def kernel_split(torch, fn, tries=3):
    """Device time of each kernel of one call of fn, by torch.profiler:
    {kernel name: (launches, ms)}. A profile that saw no device activity
    (one H100 run had two such in a row) is taken again, up to `tries`
    times; {} if none saw any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split = {e.key[:60]: (e.count, e.device_time_total / 1e3)
                 for e in prof.key_averages() if e.device_time_total > 0}
        if split:
            return split
    return {}


def device_total_ms(torch, fn, tries=3):
    """Device ms of one call of fn: its device events under a CPU and
    CUDA profile, as profile_call takes it (a CUDA-only profile, as
    kernel_split takes it, saw nothing six times in a row after phase
    7's profiled map on one H100); taken again up to `tries` times,
    None if no profile saw any."""
    for _ in range(tries):
        _, _, kernels = profile_call(torch, fn, need_device=False)
        if kernels:
            return sum(t for _, t in kernels.values()) / 1e3
    return None


def device_ms(split):
    """The device ms of a kernel_split, None where the profiler saw
    nothing."""
    return sum(ms for _, ms in split.values()) if split else None


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


# ---------------------------------------------------------------- phase 3


def make_cohort(n_genomes, seed):
    """FASTA files of related genomes: one random base genome, then per
    genome ~0.5% SNPs, 6 short indels, one N run and 20 IUPAC letters;
    records are a chromosome (the first CHROMOSOME bases) and a plasmid.
    Returns [(path, [record lengths])]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(b"RYKMSW", np.uint8)
    base = rng.choice(acgt, size=2_000_000)
    os.makedirs(WORK, exist_ok=True)
    cohort = []
    for s in range(n_genomes):
        g = base.copy()
        snp = np.flatnonzero(rng.random(len(g)) < 0.005)
        g[snp] = rng.choice(acgt, size=len(snp))
        a = int(rng.integers(0, len(g) - 1000))
        g[a : a + int(rng.integers(100, 1000))] = ord("N")
        g[rng.integers(0, len(g), 20)] = rng.choice(iupac, size=20)
        for pos in np.sort(rng.integers(0, len(g) - 20, 6))[::-1]:
            n = int(rng.integers(1, 11))
            if rng.random() < 0.5:
                g = np.delete(g, np.arange(pos, pos + n))
            else:
                g = np.insert(g, pos, rng.choice(acgt, size=n))
        path = os.path.join(WORK, f"genome{s:02d}.fa")
        records = [g[:CHROMOSOME], g[CHROMOSOME:]]
        with open(path, "wb") as f:
            f.write(b">chromosome\n" + records[0].tobytes()
                    + b"\n>plasmid\n" + records[1].tobytes() + b"\n")
        cohort.append((path, [len(r) for r in records]))
    return cohort


def check_alignment(path, n_genomes, tag):
    """One row per genome, named by its file, all rows of one length."""
    with open(path, "rb") as f:
        recs = [r.split(b"\n", 1) for r in f.read().split(b">")[1:]]
    names = [r[0].decode() for r in recs]
    lens = {len(r[1].replace(b"\n", b"")) for r in recs}
    check(names == [f"genome{s:02d}" for s in range(n_genomes)],
          f"{tag}: alignment rows {names}")
    check(len(lens) == 1 and lens.pop() > 0, f"{tag}: alignment row lengths")


def phase_main(torch, cli, torchinit, cohort, k, tag):
    paths = [p for p, _ in cohort]
    out = os.path.join(WORK, tag)
    torchinit.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["build", "-k", str(k), "-o", out, "--device", "cuda", *paths])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_launches = torchinit.launch_counts()
    t0 = time.perf_counter()
    cli.main(["align", out + ".skf", "-o", out + ".aln", "--device", "cuda"])
    t_align = time.perf_counter() - t0
    launches = torchinit.launch_counts()
    log(f"phase 3 [{tag}]: CUDA launches during build+align: {launches}")
    check(launches["radix_sort"] > 0,
          "the radix kernel was not launched on the main path")
    check_alignment(out + ".aln", len(paths), tag)

    # reference: the port's plain route on the CPU, in its own process
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "ska_tpu_torch", "build", "-k", str(k), "-o",
         out + "_cpu", "--device", "cpu", *paths],
        cwd=REPO, check=True, timeout=600, stdout=subprocess.DEVNULL,
    )
    t_cpu = time.perf_counter() - t0
    with open(out + ".skf", "rb") as a, open(out + "_cpu.skf", "rb") as b:
        port_bytes = a.read()
        check(port_bytes == b.read(),
              f"{tag}: .skf bytes differ from the plain CPU route's")
    windows = sum(max(n - k + 1, 0) for _, lens in cohort for n in lens)
    rate = windows / t_build
    log(f"phase 3 [{tag}]: {len(paths)} genomes, k={k}: .skf {len(port_bytes)} "
        f"bytes equal to the plain CPU route's; build {t_build:.3f} s wall "
        f"({windows} windows, {rate:.0f} split k-mers/s end to end), align "
        f"{t_align:.3f} s, plain CPU route build {t_cpu:.3f} s (a process "
        f"of its own)")
    return launches, rate, t_build, build_launches


# ---------------------------------------------------------------- phase 4


def phase_profile(torch, cli, argv, ref_skf, t_build, phase, what):
    """Two more builds of `argv`, warm: unprofiled, then per step span
    and per kernel times under the profiler. Both must write the bytes
    of ref_skf."""
    def build(tag):
        out = ref_skf[:-4] + f"_{tag}"
        t0 = time.perf_counter()
        quiet(cli.main, ["build", *argv, "-o", out, "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out + ".skf", "rb") as a, open(ref_skf, "rb") as b:
            check(a.read() == b.read(), f"{tag} build: .skf bytes differ")
        return wall

    t_warm = build("warm")
    wall, spans, kernels = profile_call(torch, lambda: build("profiled"))
    log(f"{phase}: {what} under torch.profiler: {wall:.3f} s wall "
        f"(unprofiled: {t_warm:.3f} s warm, {t_build:.3f} s as the first "
        f"build)")
    log_profile(phase, "the build", wall, spans, kernels)


def profile_call(torch, fn, need_device=True):
    """fn() under torch.profiler: (wall s, {ska:: span: (calls, us) of
    host time}, {device item: (calls, us)}); a profile without device
    activity fails, unless need_device is False."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (wall,) + profile_events(prof, need_device)


def profile_events(prof, need_device=True):
    """({ska:: span: (calls, us) of host time}, {device item: (calls,
    us)}) of a finished torch.profiler run; one without device activity
    fails, unless need_device is False."""
    from torch.autograd import DeviceType

    spans, kernels = {}, {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        on_card = e.device_type == DeviceType.CUDA
        if e.name.startswith("ska::"):
            if not on_card:
                n, t = spans.get(e.name, (0, 0.0))
                spans[e.name] = (n + 1, t + us)
        elif on_card:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + us)
    check(kernels or not need_device, "the profiler saw no device activity")
    return spans, kernels


# spans around other spans (the command, a webapi call, an .skf load
# around its steps), left out of the sum of the spans' times
ENCLOSING_SPANS = ("ska::command", "ska::call", "ska::load")


def log_profile(phase, what, wall, spans, kernels, top=10):
    """Each span's host wall time, the card's busy time and idle share
    over `wall`, and the largest device items."""
    busy = sum(t for _, t in kernels.values()) / 1e6
    in_spans = sum(t for name, (_, t) in spans.items()
                   if name not in ENCLOSING_SPANS) / 1e6
    if spans:
        log(f"{phase}: step spans add up to {in_spans:.3f} s, the other "
            f"{wall - in_spans:.3f} s is outside every step span")
    for name, (n, t) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"{phase}:   span {name}: {t / 1e3:.3f} ms host wall ({n} calls)")
    log(f"{phase}: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall: the "
        f"card ran nothing for {100 * (1 - busy / wall):.1f}% of {what}")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"{phase}:   device {t / 1e3:.3f} ms in {n} calls: {name[:100]}")


def quiet(fn, *args):
    """Call fn with its stdout and stderr kept; returns them as text."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*args)
    return out.getvalue(), err.getvalue()


# ---------------------------------------------------------------- phase 5


COMP = bytes.maketrans(b"ACGTNRYKMSW", b"TGCANYRMKSW")


def read_genome(path):
    """The records of one of make_cohort's FASTA files, as uint8 arrays."""
    import numpy as np

    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [np.frombuffer(x, np.uint8) for x in lines[1::2] if x]


def make_reads(records, depth, seed, prefix):
    """Paired-end reads of a genome, written as prefix_1.fastq and
    prefix_2.fastq: 2 x READ_LEN from fragments of INSERT bases placed
    uniformly over the records, either strand first; 0.2% substitutions,
    1 in 5000 bases N, PHRED+33 qualities 30-40 with ~1% of bases at
    2-19. Each file is written from one array of fixed-width records.
    Returns (fwd path, rev path, number of reads)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    comp = np.frombuffer(bytes(range(256)).translate(COMP), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = np.array([len(r) for r in records])
    genome = np.concatenate(records)
    n = depth * int(lens.sum()) // (2 * READ_LEN)
    rec = rng.choice(len(records), size=n, p=lens / lens.sum())
    ins = rng.integers(INSERT[0], INSERT[1] + 1, size=n)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])[rec] + (
        rng.random(n) * (lens[rec] - ins + 1)).astype(np.int64)
    cols = np.arange(READ_LEN)
    r1 = genome[start[:, None] + cols]
    r2 = comp[genome[(start + ins - READ_LEN)[:, None] + cols][:, ::-1]]
    swap = rng.random(n) < 0.5
    r1, r2 = np.where(swap[:, None], r2, r1), np.where(swap[:, None], r1, r2)
    digits = ((np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10
              + ord("0")).astype(np.uint8)
    paths = []
    for mate, r in ((1, r1), (2, r2)):
        sub = rng.random(r.shape) < 0.002
        r[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        r[rng.random(r.shape) < 0.0002] = ord("N")
        q = rng.integers(33 + 30, 33 + 41, size=r.shape, dtype=np.uint8)
        low = rng.random(r.shape) < 0.01
        q[low] = rng.integers(33 + 2, 33 + 20, size=int(low.sum()),
                              dtype=np.uint8)

        def const(b):
            return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

        rows = np.concatenate([const(b"@r"), digits, const(b"/%d\n" % mate), r,
                               const(b"\n+\n"), q, const(b"\n")], axis=1)
        path = f"{prefix}_{mate}.fastq"
        with open(path, "wb") as f:
            f.write(rows.tobytes())
        paths.append(path)
    return paths[0], paths[1], 2 * n


def write_reads(genomes, depths, seed, subdir):
    """Read sets of (name, records) genomes at depths, and samples.tsv."""
    d = os.path.join(WORK, subdir)
    os.makedirs(d, exist_ok=True)
    samples, n_reads = [], 0
    for i, ((name, records), depth) in enumerate(zip(genomes, depths)):
        fwd, rev, n = make_reads(records, depth, seed * 100 + i,
                                 os.path.join(d, name))
        samples.append((name, fwd, rev))
        n_reads += n
    tsv = os.path.join(d, "samples.tsv")
    with open(tsv, "w") as f:
        f.writelines(f"{a}\t{b}\t{c}\n" for a, b, c in samples)
    return tsv, samples, n_reads


def column_keys(arr, name):
    """Keys of the non-gap rows of one sample's column."""
    col = arr.names.index(name)
    return arr.keys[arr.variants[:, col] != ord("-")]


def phase_reads(torch, cli, torchinit, cohort, seed):
    """The reads build at full width, align, key agreement with phase
    3's FASTA columns, cov of one pair, and a profile of the build."""
    import numpy as np

    from ska_tpu_torch.io import skf

    t0 = time.perf_counter()
    genomes = [(f"genome{s:02d}", read_genome(cohort[s][0]))
               for s in range(len(DEPTHS))]
    tsv, samples, n_reads = write_reads(genomes, DEPTHS, seed, "reads")
    log(f"phase 5: {n_reads} reads of {READ_LEN} bp ({len(samples)} samples "
        f"at {list(DEPTHS)}x) written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(WORK, "reads31")
    argv = ["-f", tsv, "-k", "31"]
    torchinit.reset_launch_counts()
    t0 = time.perf_counter()
    quiet(cli.main, ["build", *argv, "-o", out, "--device", DEVICE])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    quiet(cli.main, ["align", out + ".skf", "-o", out + ".aln",
                     "--device", DEVICE])
    t_align = time.perf_counter() - t0
    launches = torchinit.launch_counts()
    log(f"phase 5: CUDA launches during build+align: {launches}")
    check(launches["radix_sort"] > 0,
          "the radix kernel was not launched on the reads path")
    check_alignment(out + ".aln", len(samples), "reads31")

    fa = skf.load(os.path.join(WORK, "k31.skf"))
    fq = skf.load(out + ".skf")
    for name, *_ in samples:
        a, b = column_keys(fa, name)[:, 0], column_keys(fq, name)[:, 0]
        fa_in_fq = float(np.isin(a, b).mean())
        fq_in_fa = float(np.isin(b, a).mean())
        log(f"phase 5: {name}: {len(a)} split k-mers in the FASTA column, "
            f"{len(b)} in the FASTQ column; {100 * fa_in_fq:.3f}% of the "
            f"FASTA's in the FASTQ's, {100 * fq_in_fa:.3f}% the other way")
        check(fa_in_fq >= 0.99 and fq_in_fa >= 0.99,
              f"{name}: FASTQ and FASTA columns agree on fewer than 99%")
    windows = n_reads * (READ_LEN - 31 + 1)
    rate = windows / t_build
    log(f"phase 5: reads build {t_build:.3f} s wall ({windows} windows, "
        f"{rate:.0f} split k-mers/s end to end), .skf "
        f"{os.path.getsize(out + '.skf')} bytes, align {t_align:.3f} s")

    # cov of genome 00's pair: one dispatch of 2^26 rows
    torchinit.reset_launch_counts()
    t0 = time.perf_counter()
    stdout, stderr = quiet(cli.main, ["cov", samples[0][1], samples[0][2],
                                      "--device", DEVICE])
    torch.cuda.synchronize()
    t_cov = time.perf_counter() - t0
    cutoff = [ln for ln in stderr.splitlines() if ln.startswith("Estimated")]
    check(len(cutoff) == 1 and stdout.startswith("Count\tK_mers"),
          "cov printed no table and cutoff")
    check(torchinit.launch_counts()["radix_sort"] > 0, "cov launched no sort")
    log(f"phase 5: cov of {samples[0][0]}'s pair: {t_cov:.3f} s wall, "
        f"{cutoff[0]!r}, {len(stdout.splitlines()) - 1} histogram rows")
    phase_profile(torch, cli, argv, out + ".skf", t_build, "phase 5",
                  "reads build of 5 samples")
    return launches, rate, t_build


# ---------------------------------------------------------------- phase 6


def card_run(torch, cli, torchinit, argv, env):
    """One CLI run on the card in this process, under the extra
    environment `env`, launch counters zeroed just before it and read
    just after: (stdout, wall s, launches)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        torchinit.reset_launch_counts()
        t0 = time.perf_counter()
        stdout, _ = quiet(cli.main, argv + ["--device", DEVICE])
        torch.cuda.synchronize()
        return stdout, time.perf_counter() - t0, torchinit.launch_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def card_and_cpu(torch, cli, torchinit, runs):
    """Each (tag, argv, env) of `runs` on the card (card_run) and on the
    plain CPU route, `python -m ska_tpu_torch ... --device cpu` in a
    process of its own; the CPU runs go in a thread beside the card's,
    so the card's wall times share the host's cores. "{dev}" in argv
    stands for the device. Returns ({tag: (stdout, s, launches)},
    {tag: (stdout, s)})."""

    def argv(args, dev):
        return [a.format(dev=dev) for a in args]

    def cpu_route():
        res = {}
        for tag, args, env in runs:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "ska_tpu_torch", *argv(args, "cpu"),
                 "--device", "cpu"],
                cwd=REPO, env=dict(os.environ, **env), capture_output=True,
                text=True, timeout=900)
            check(r.returncode == 0, f"{tag} on the CPU route: {r.stderr[-2000:]}")
            res[tag] = (r.stdout, time.perf_counter() - t0)
        return res

    with cf.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(cpu_route)
        card = {tag: card_run(torch, cli, torchinit, argv(args, DEVICE), env)
                for tag, args, env in runs}
        return card, cpu.result()


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        return data == fb.read(), len(data)


def phase_exact(torch, cli, torchinit, cohort, seed):
    """Reads at 200,000 bases per genome, card against the plain CPU
    route, .skf and stdout byte for byte."""
    genomes = [(f"genome{s:02d}", [read_genome(cohort[s][0])[0][:SMALL_BASES]])
               for s in range(len(DEPTHS))]
    tsv, samples, n_reads = write_reads(genomes, DEPTHS, seed + 1, "small")
    d = os.path.dirname(tsv)
    env = {"SKA_MAX_CHUNK_BASES": str(SMALL_CAP)}

    def out(tag):
        return ["-o", os.path.join(d, f"{tag}_{{dev}}")]

    runs = [
        ("auto31", ["build", "-f", tsv, "-k", "31", "--min-count", "auto",
                    *out("auto31")], env),
        ("k63", ["build", "-f", tsv, "-k", "63", "--min-count", "1",
                 "--qual-filter", "middle", *out("k63")], env),
        ("cov00", ["cov", samples[0][1], samples[0][2]], env),
        ("cov04", ["cov", samples[4][1], samples[4][2]], env),
    ]
    card, cpu = card_and_cpu(torch, cli, torchinit, runs)
    for tag, args, _ in runs:
        stdout, t_card, launches = card[tag]
        check(launches["radix_sort"] > 0,
              f"{tag}: the radix kernel was not launched")
        check(stdout == cpu[tag][0], f"{tag}: stdout differs from the CPU route's")
        what = "stdout"
        if args[0] == "build":
            same, size = same_bytes(os.path.join(d, f"{tag}_{DEVICE}.skf"),
                                    os.path.join(d, f"{tag}_cpu.skf"))
            check(same, f"{tag}: .skf bytes differ from the plain CPU route's")
            what = f".skf ({size} bytes) and stdout"
        cut = stdout.count("\n")
        log(f"phase 6 [{tag}]: {what} equal to the plain CPU route's; card "
            f"{t_card:.3f} s wall, CPU route {cpu[tag][1]:.3f} s (a process of "
            f"its own); launches {launches}"
            + (f"; {cut - 1} histogram rows" if cut else ""))
    windows = n_reads * (READ_LEN - 31 + 1)
    log(f"phase 6: {n_reads} reads; the card's auto31 build (fit included) "
        f"{windows / card['auto31'][1]:.0f} split k-mers/s end to end")


# ---------------------------------------------------------------- phase 7


def phase_map(torch, cli, torchinit, cohort):
    """`ska map` of phase 3's .skf files to genome00.fa (a chromosome and
    a plasmid) on the card, byte for byte against the plain CPU route;
    the aln once more with the chromosome in k-1-overlap slices; then a
    warm k=31 VCF map under torch.profiler and its lookup timed beside
    the library call. Returns the lookup kernel's launches in the card's
    maps and real_table_lookup's times."""
    from ska_tpu_torch import ref as R
    from ska_tpu_torch.io import skf

    ref = cohort[0][0]
    d = os.path.join(WORK, "map")
    os.makedirs(d, exist_ok=True)
    skfs = {k: os.path.join(WORK, f"k{k}.skf") for k in (31, 63)}

    def run(tag, k, fmt, *flags):
        return (tag, ["map", ref, skfs[k], "-f", fmt, *flags, "-o",
                      os.path.join(d, f"{tag}_{{dev}}.{fmt}")], {})

    runs = [run("k31_aln", 31, "aln"), run("k31_vcf", 31, "vcf"),
            run("k31_masked", 31, "aln", "--ambig-mask", "--repeat-mask"),
            run("k63_aln", 63, "aln")]
    card, cpu = card_and_cpu(torch, cli, torchinit, runs)
    launches = 0
    for tag, args, _ in runs:
        _, t_card, counts = card[tag]
        fmt = args[4]
        check(counts["lower_bound"] > 0, f"{tag}: the lookup kernel was not "
              "launched")
        launches += counts["lower_bound"]
        same, size = same_bytes(os.path.join(d, f"{tag}_{DEVICE}.{fmt}"),
                                os.path.join(d, f"{tag}_cpu.{fmt}"))
        check(same, f"{tag}: {fmt} bytes differ from the plain CPU route's")
        log(f"phase 7 [{tag}]: {fmt} ({size} bytes) equal to the plain CPU "
            f"route's; card {t_card:.3f} s wall, CPU route {cpu[tag][1]:.3f} s "
            f"(a process of its own); launches {counts}")
    # weed the reference's split k-mers (scanned on the card) from k31.skf
    weed = [("weed", ["weed", skfs[31], ref, "-o",
                      os.path.join(d, "weed_{dev}.skf")], {})]
    (_, t_card, counts), = card_and_cpu(torch, cli, torchinit, weed)[0].values()
    same, size = same_bytes(os.path.join(d, f"weed_{DEVICE}.skf"),
                            os.path.join(d, "weed_cpu.skf"))
    check(same, "weed: .skf bytes differ from the plain CPU route's")
    log(f"phase 7 [weed]: .skf ({size} bytes) equal to the plain CPU "
        f"route's; card {t_card:.3f} s wall; launches {counts}")
    tag, args, _ = run("k31_sliced", 31, "aln")
    _, t_card, counts = card_run(
        torch, cli, torchinit, [a.format(dev=DEVICE) for a in args],
        {"SKA_MAX_CHUNK_BASES": str(MAP_SLICE_CAP)})
    check(counts["lower_bound"] > 0, f"{tag}: the lookup kernel was not "
          "launched")
    launches += counts["lower_bound"]
    same, size = same_bytes(os.path.join(d, f"k31_sliced_{DEVICE}.aln"),
                            os.path.join(d, f"k31_aln_{DEVICE}.aln"))
    check(same, "the sliced reference scan changed the alignment")
    log(f"phase 7 [{tag}]: SKA_MAX_CHUNK_BASES={MAP_SLICE_CAP}, the "
        f"chromosome in slices: aln equal to the unsliced run's; card "
        f"{t_card:.3f} s wall; launches {counts}")

    # where the time of one map goes: the steps of api.map_mode, warm
    mapped = {}

    def map_vcf():
        arr = skf.load(skfs[31])
        ska_ref = R.RefSka(31, ref, arr.rc, False, False, device=DEVICE)
        ska_ref.map(arr)
        with open(os.path.join(d, "k31_profiled.vcf"), "w") as fh:
            ska_ref.write_vcf(fh)
        mapped["n"] = len(ska_ref.mapped_pos)
        mapped["arr"], mapped["ref"] = arr, ska_ref

    wall, spans, kernels = profile_call(torch, map_vcf)
    same, _ = same_bytes(os.path.join(d, "k31_profiled.vcf"),
                         os.path.join(d, f"k31_vcf_{DEVICE}.vcf"))
    check(same, "the profiled map wrote other VCF bytes")
    log(f"phase 7: k=31 VCF map under torch.profiler: {wall:.3f} s wall; "
        f"{mapped['n']} of the reference's {mapped['ref'].ksize} split k-mers "
        f"mapped to the {mapped['arr'].ksize} keys of k31.skf")
    log_profile("phase 7", "the map", wall, spans, kernels)
    real = real_table_lookup(torch, mapped["arr"].sorted_view()[0],
                             mapped["ref"].kmers)
    return launches, real


def real_table_lookup(torch, sorted_keys, kmers):
    """The map's own lookup, k31.skf's sorted keys and the reference's
    split k-mers (W=1), by the lookup kernel and by the library call,
    torch.searchsorted on the sign-biased limb: equal answers, then in
    turns each call alone after an L2 flush, device time (profiler) and
    back to back, beside the bound."""
    from ska_tpu_torch.ops import keys as TK

    table = TK.from_numpy_keys(sorted_keys, DEVICE)
    queries = TK.from_numpy_keys(kmers, DEVICE)
    (N, W), M = table.shape, queries.shape[0]
    check(W == 1, f"phase 7: k31.skf's keys have {W} limbs")
    biased = (table[:, 0] ^ TK.SIGN, queries[:, 0] ^ TK.SIGN)

    def kernel():
        return TK.lower_bound(table, queries)

    def library():
        return torch.searchsorted(*biased)

    check(torch.equal(kernel(), library()),
          "phase 7: torch.searchsorted differs from the lookup kernel")
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=DEVICE)
    kern, lib = [], []
    for _ in range(3):
        kern += cold_ms(torch, kernel, 2, flush)
        lib += cold_ms(torch, library, 2, flush)
    del flush
    bound, bound_by = lookup_bound(W, N, M)
    res = {
        "ms": statistics.median(kern),
        "library_ms": statistics.median(lib),
        "device_ms": device_total_ms(torch, kernel),
        "library_device_ms": device_total_ms(torch, library),
        "back_to_back_ms": back_to_back(torch, kernel),
        "library_back_to_back_ms": back_to_back(torch, library),
        "bound_ms": bound,
        "bound_by": bound_by,
    }
    # the card's time without host gaps, and the host's, where the
    # profiler sees no kernel
    res["queued_ms"], res["host_ms"] = queued_ms(torch, kernel)
    res["library_queued_ms"], res["library_host_ms"] = queued_ms(torch, library)
    # the same shape on uniform keys and queries in random order, to tell
    # the table's size from its data
    g = torch.Generator(device=DEVICE).manual_seed(7)
    uniform = torch.unique(torch.randint(0, 1 << 60, (N + N // 64,),
                                         generator=g, device=DEVICE))[:N]
    u_queries = uniform[torch.randint(0, N, (M,), generator=g, device=DEVICE)]
    u_table, u_q = uniform[:, None].contiguous(), u_queries[:, None].contiguous()
    u_biased = (uniform ^ TK.SIGN, u_queries ^ TK.SIGN)
    check(torch.equal(TK.lower_bound(u_table, u_q),
                      torch.searchsorted(*u_biased)),
          "phase 7: the uniform table's answers differ")
    res["uniform_back_to_back_ms"] = back_to_back(
        torch, lambda: TK.lower_bound(u_table, u_q))
    res["uniform_library_back_to_back_ms"] = back_to_back(
        torch, lambda: torch.searchsorted(*u_biased))
    del uniform, u_queries, u_table, u_q, u_biased
    log(f"phase 7: the map's lookup, {M} queries in {N} keys, W=1: lookup "
        f"kernel {res['ms']:.3f} ms a call after an L2 flush (runs "
        f"{[round(x, 3) for x in kern]}), device {ms_text(res['device_ms'])}, "
        f"back to back {res['back_to_back_ms']:.3f} ms; library "
        f"torch.searchsorted {res['library_ms']:.3f} ms (runs "
        f"{[round(x, 3) for x in lib]}), device "
        f"{ms_text(res['library_device_ms'])}, back to back "
        f"{res['library_back_to_back_ms']:.3f} ms; queued behind a sleep "
        f"kernel {res['queued_ms']:.4f} ms a call (host {res['host_ms']:.4f} "
        f"ms), library {res['library_queued_ms']:.4f} ms (host "
        f"{res['library_host_ms']:.4f} ms); bound {bound:.3f} ms by "
        f"{bound_by}; answers equal. The same shape on uniform random keys "
        f"and queries, back to back: lookup kernel "
        f"{res['uniform_back_to_back_ms']:.3f} ms, library "
        f"{res['uniform_library_back_to_back_ms']:.3f} ms")
    return res


# ---------------------------------------------------------------- phase 8


def gram_sites(torch, seed, dev):
    """A cohort whose sites follow a tree: 512 samples, the leaves of a
    random binary tree (each clade a run of a random leaf order, split at
    a uniform point), x 2^20 sites. Each site has one majority base and
    one mutation on a branch drawn in proportion to its (exponential)
    length, whose clade carries another base. Gaps are missing blocks:
    each sample misses each block of 256 sites with probability 3%; 0.1%
    of cells are IUPAC letters (R, Y, K, M, S, W). Made on the card from
    `seed`; returns numpy uint8 (S, n)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    S, n = 1 << GRAM_SITES_LOG2, GRAM_SAMPLES
    clades, stack = [], [(0, n)]
    while stack:
        a, b = stack.pop()
        if b - a > 1:
            m = int(rng.integers(a + 1, b))
            stack += [(a, m), (m, b)]
            clades += [(a, m), (m, b)]
    clades = np.array(clades)
    length = rng.exponential(size=len(clades))
    lo, hi = torch.from_numpy(clades[rng.choice(
        len(clades), size=S, p=length / length.sum())].T.copy()).to(dev)
    rank = torch.from_numpy(np.argsort(rng.permutation(n))).to(dev)
    in_clade = (rank >= lo[:, None]) & (rank < hi[:, None])
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    major = torch.randint(0, 4, (S, 1), generator=g, device=dev)
    alt = (major + torch.randint(1, 4, (S, 1), generator=g, device=dev)) % 4
    v = base[torch.where(in_clade, alt, major)]
    miss = torch.rand((S // 256, n), generator=g, device=dev) < 0.03
    v = torch.where(miss.repeat_interleave(256, dim=0), ord("-"), v)
    iupac = torch.tensor(list(b"RYKMSW"), dtype=torch.uint8, device=dev)
    amb = torch.rand((S, n), generator=g, device=dev) < 0.001
    v = torch.where(amb, iupac[torch.randint(0, 6, (S, n), generator=g,
                                             device=dev)], v)
    return v.cpu().numpy()


def dedupe_rows(compact):
    """Exact unique rows and their counts, as the JAX package dedupes
    before its weighted Gram: 16 4-bit class codes packed per u64 word,
    then a lexsort of the words."""
    import numpy as np

    S, n = compact.shape
    nw = -(-n // 16)
    packed = np.zeros((S, nw), np.uint64)
    for j in range(16):
        cols = np.arange(j, n, 16)
        if len(cols):
            packed[:, : len(cols)] |= (compact[:, cols].astype(np.uint64)
                                       << np.uint64(4 * j))
    order = np.lexsort(tuple(packed[:, w] for w in range(nw - 1, -1, -1)))
    sp = packed[order]
    first = np.ones(S, bool)
    np.any(sp[1:] != sp[:-1], axis=1, out=first[1:])
    starts = np.flatnonzero(first)
    return compact[order[starts]], np.diff(np.append(starts, S))


def gram_dedupe_f32(torch, D, v, dev, chunk=1 << 15):
    """The plain version of class_gram, by the JAX package's other route:
    rows deduplicated on the host, then per chunk one f32 product of the
    one-hot scaled by each row's count (exact: every sum is an integer
    below 2^24, in full f32). Returns (int64 Gram, distinct rows)."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    S, n = v.shape
    compact, present, K, width, _ = D.compact_classes(v)
    rows, counts = dedupe_rows(compact)
    Gc = torch.zeros((n * width, n * width), dtype=torch.int64, device=dev)
    cols = torch.arange(n, device=dev) * width
    for s0 in range(0, len(rows), chunk):
        c = torch.from_numpy(rows[s0 : s0 + chunk]).to(dev).long()
        X = torch.zeros((len(c), n * width), dtype=torch.float32, device=dev)
        X.scatter_(1, cols + c, 1.0)
        w = torch.from_numpy(counts[s0 : s0 + chunk]).to(dev).float()
        Gc += torch.matmul((X * w[:, None]).t(), X).to(torch.int64)
    G = D.scatter_gram_16(Gc.cpu().numpy(), present, K, width, n)
    return G, len(rows)


def gram_inputs(torch, seed):
    """The Gram's two inputs: the sites that `distance k31.skf` holds
    after its constant-site filter, and the tree cohort (gram_sites)."""
    from ska_tpu_torch import api
    from ska_tpu_torch.constants import FILTER_NOCONST
    from ska_tpu_torch.io import skf

    arr = skf.load(os.path.join(WORK, "k31.skf"))
    api.apply_filters(arr, 0.0, False, FILTER_NOCONST, False, False)
    t0 = time.perf_counter()
    tree = gram_sites(torch, seed, torch.device(DEVICE))
    log(f"phase 8: {tree.shape[0]} sites x {tree.shape[1]} samples on a "
        f"tree made in {time.perf_counter() - t0:.1f} s")
    return {"k31.skf": arr.variants, "tree": tree}


def phase_distance(torch, cli, torchinit, seed):
    """`ska distance` of k31.skf on the card, TSV bytes against the plain
    CPU route; then the class Gram of k31.skf's sites and of a 512-sample
    cohort on a tree, each by the port (int8) and by the plain version
    (host dedupe, weighted f32), equal as int64, with both times. Returns
    {tag: (variants, the port's Gram)}."""
    import numpy as np

    from ska_tpu_torch import distance as D

    d = os.path.join(WORK, "distance")
    os.makedirs(d, exist_ok=True)
    k31 = os.path.join(WORK, "k31.skf")

    def run(tag, *flags):
        return (tag, ["distance", k31, *flags, "-o",
                      os.path.join(d, f"{tag}_{{dev}}.tsv")], {})

    runs = [run("plain"), run("min_freq", "--min-freq", "0.5"),
            run("ambig", "--allow-ambiguous")]
    card, cpu = card_and_cpu(torch, cli, torchinit, runs)
    for tag, _, _ in runs:
        same, size = same_bytes(os.path.join(d, f"{tag}_{DEVICE}.tsv"),
                                os.path.join(d, f"{tag}_cpu.tsv"))
        check(same, f"distance {tag}: TSV bytes differ from the CPU route's")
        log(f"phase 8 [{tag}]: TSV ({size} bytes) equal to the plain CPU "
            f"route's; card {card[tag][1]:.3f} s wall, CPU route "
            f"{cpu[tag][1]:.3f} s (a process of its own)")

    grams = {}
    for tag, v in gram_inputs(torch, seed).items():
        S, n = v.shape
        _, _, K, width, _ = D.compact_classes(v)
        P = n * width
        res = {}
        wall_port, _, kernels_port = profile_call(
            torch, lambda: res.update(port=D.class_gram(v, DEVICE)))
        wall_plain, _, kernels_plain = profile_call(
            torch, lambda: res.update(plain=gram_dedupe_f32(
                torch, D, v, torch.device(DEVICE))))
        G, rows = res["plain"]
        check(np.array_equal(res["port"], G),
              f"{tag}: class_gram differs from the deduplicated f32 Gram")
        check(int(np.trace(res["port"].reshape(n, 16, n, 16)[0, :, 0, :])) == S,
              f"{tag}: Gram diagonal counts")
        log(f"phase 8 [{tag}]: {S} sites x {n} samples, {K} classes, width "
            f"{width}, {rows} distinct rows; the two {n * 16}^2 int64 Grams "
            f"are equal")
        log(f"phase 8 [{tag}]: class_gram (int8) {wall_port:.3f} s wall, "
            f"matmul bound {2 * S * P * P / INT8_OPS_PER_S * 1e3:.3f} ms "
            f"(2 x {S} x {P}^2 at {INT8_OPS_PER_S / 1e12:.0f} T/s); plain "
            f"(host dedupe, weighted f32) {wall_plain:.3f} s wall, bound "
            f"{2 * rows * P * P / PEAK_OPS_PER_S * 1e3:.3f} ms (2 x {rows} x "
            f"{P}^2 at {PEAK_OPS_PER_S / 1e12:.0f} T/s)")
        log_profile("phase 8", f"class_gram of {tag}", wall_port, {},
                    kernels_port, top=5)
        log_profile("phase 8", f"the plain Gram of {tag}", wall_plain, {},
                    kernels_plain, top=5)
        grams[tag] = (v, res["port"])
    return grams


# ---------------------------------------------------------------- phase 9


def join_group(torch, rank, world, port):
    """This process as rank `rank` of an NCCL group of `world` ranks, on
    card rank % cards (made current before anything allocates)."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    # NCCL sets its communicator up at the first collective and its
    # point-to-point channels at the first all_to_all: here, not inside
    # the first timed call
    x = torch.zeros(world, device="cuda")
    dist.all_reduce(x)
    dist.all_to_all_single(torch.empty_like(x), x)
    torch.cuda.synchronize()
    return dist


def dist_calls(torch, torchinit, grams, on_result,
               profiled=lambda tag: contextlib.nullcontext()):
    """The sharded calls of phase 9, in one order on every rank (each is
    collective): the build of phase 3's cohort at k=31 and of its first 4
    genomes at k=63, the lookup of genome00.fa's split k-mers in k31.skf,
    each once more inside the context manager profiled(tag), and the
    class Gram of phase 8's two inputs. on_result(tag, result, wall s,
    {kernel: launches}) sees each."""
    from ska_tpu_torch import api
    from ska_tpu_torch.constants import DEFAULT_MINCOUNT, DEFAULT_MINQUAL, QUAL_STRICT
    from ska_tpu_torch.io import fastx, skf
    from ska_tpu_torch.parallel.postbuild import (
        distributed_class_gram, distributed_lookup)
    from ska_tpu_torch.ref import RefSka
    from ska_tpu_torch.sample import build_samples_distributed
    from ska_tpu_torch.sampletypes import QualOpts

    qual = QualOpts(min_count=DEFAULT_MINCOUNT, min_qual=DEFAULT_MINQUAL,
                    qual_filter=QUAL_STRICT)
    paths = [os.path.join(WORK, f"genome{s:02d}.fa") for s in range(GENOMES)]

    def timed(tag, fn, ctx=contextlib.nullcontext()):
        torchinit.reset_launch_counts()
        torch.cuda.synchronize()
        with ctx:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_result(tag, out, wall, torchinit.launch_counts())

    def build(k, n):
        files = fastx.get_input_list(None, paths[:n])
        return lambda: api.assemble(build_samples_distributed(
            files, k, True, qual, device=DEVICE), k, True)

    timed("build k31", build(31, GENOMES))
    timed("build k63", build(63, GENOMES_K63))
    timed("profile k31", build(31, GENOMES), profiled("profile k31"))
    timed("profile k63", build(63, GENOMES_K63), profiled("profile k63"))
    arr = skf.load(os.path.join(WORK, "k31.skf"))
    sorted_keys, _ = arr.sorted_view()
    kmers = RefSka(31, paths[0], arr.rc, False, False, device=DEVICE).kmers
    timed("lookup", lambda: distributed_lookup(sorted_keys, kmers, DEVICE))
    timed("profile lookup",
          lambda: distributed_lookup(sorted_keys, kmers, DEVICE),
          profiled("profile lookup"))
    for tag, (v, _) in grams.items():
        timed(f"gram {tag}", lambda: distributed_class_gram(v, DEVICE))


def phase_dist(torch, torchinit, grams):
    """The sharded paths (parallel/) on an NCCL group of one rank per
    card, driven through their functions directly (use_distributed()
    stays false at one rank, as in the JAX package): every array equal to
    phase 3's .skf files, the plain lookup and phase 8's serial Grams.
    Returns the radix launches of the builds, the lookup kernel's
    launches in the lookup, and each profiled call's kernel time and
    bound ({tag: {"ms", "bound_ms"}})."""
    import socket

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ska_tpu_torch.io import skf
    from ska_tpu_torch.ops import keys as TK
    from ska_tpu_torch.ops import lookup as LU
    from ska_tpu_torch.ops import sort as SO
    from ska_tpu_torch.ref import RefSka

    world = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    helpers = []
    if world > 1:
        # ranks 1.. are processes of this script, each on its own card
        for tag, (v, _) in grams.items():
            np.save(os.path.join(WORK, f"gram_{tag}.npy"), v)
        helpers = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
             "--dist-world", str(world), "--dist-port", str(port)], cwd=REPO)
            for r in range(1, world)]
    done = False
    try:
        t0 = time.perf_counter()
        dist = join_group(torch, 0, world, port)
        log(f"phase 9: NCCL group of world size {world} "
            f"(backend {dist.get_backend()}), rank 0 on "
            f"{torch.cuda.get_device_name(0)}, joined and warmed up in "
            f"{time.perf_counter() - t0:.3f} s")
        results, profs = {}, {}

        @contextlib.contextmanager
        def profiled(tag):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof, \
                    CallBytes(SO, "_sort_cuda") as sorts, \
                    CallBytes(LU, "lower_bound") as lookups:
                yield
            profs[tag] = (prof, lookups if "lookup" in tag else sorts)

        dist_calls(torch, torchinit, grams,
                   lambda tag, *res: results.__setitem__(tag, res), profiled)
        dist.destroy_process_group()
        done = True
    finally:
        # after a failure here the other ranks would wait for their
        # timeout: end them at once
        for h in helpers:
            try:
                h.wait(timeout=600 if done else 0)
            except subprocess.TimeoutExpired:
                h.kill()
                h.wait()
    check(all(h.returncode == 0 for h in helpers), "a phase 9 rank failed")

    for k, tag in ((31, "build k31"), (63, "build k63"), (31, "profile k31"),
                   (63, "profile k63")):
        arr, wall, launches = results[tag]
        want = skf.load(os.path.join(WORK, f"k{k}.skf"))
        check(arr.names == want.names
              and np.array_equal(arr.keys, want.keys)
              and np.array_equal(arr.variants, want.variants)
              and np.array_equal(arr.counts, want.counts.astype(np.int64)),
              f"phase 9 {tag}: the sharded build differs from k{k}.skf")
        check(launches["radix_sort"] > 0,
              f"phase 9 {tag}: the radix kernel was not launched")
        log(f"phase 9 [{tag}]: {arr.ksize} rows x {arr.nsamples} samples, "
            f"keys, variants, counts and names equal to k{k}.skf; "
            f"{wall:.3f} s wall, launches {launches}")

    (found, rows), wall, launches = results["lookup"]
    check(all(np.array_equal(a, b) for a, b in zip(
        (found, rows), results["profile lookup"][0])),
          "phase 9 lookup: the profiled lookup gave other rows")
    arr = skf.load(os.path.join(WORK, "k31.skf"))
    sorted_keys, _ = arr.sorted_view()
    kmers = RefSka(31, os.path.join(WORK, "genome00.fa"), arr.rc, False, False,
                   device=DEVICE).kmers
    table = TK.from_numpy_keys(sorted_keys, DEVICE)
    q = TK.from_numpy_keys(kmers, DEVICE)
    idx = TK.searchsorted(table, q).clamp(0, len(sorted_keys) - 1)
    s_found = TK.equal(table[idx], q).cpu().numpy()
    s_rows = np.where(s_found, idx.cpu().numpy(), -1)
    check(np.array_equal(found, s_found) and np.array_equal(rows, s_rows),
          "phase 9 lookup: rows differ from the plain binary search's")
    check(launches["lower_bound"] > 0,
          "phase 9 lookup: the lookup kernel was not launched")
    log(f"phase 9 [lookup]: {len(kmers)} queries in {len(sorted_keys)} keys, "
        f"{int(found.sum())} found, rows equal to the plain binary search's; "
        f"{wall:.3f} s wall, launches {launches}")

    for tag, (v, G) in grams.items():
        got, wall, launches = results[f"gram {tag}"]
        check(got.dtype == np.int64 and np.array_equal(got, G),
              f"phase 9 gram {tag}: differs from phase 8's class_gram")
        log(f"phase 9 [gram {tag}]: {v.shape[0]} sites x {v.shape[1]} samples, "
            f"int64 Gram equal to phase 8's class_gram; {wall:.3f} s wall, "
            f"launches {launches}")

    device = {}
    for tag, what, names in (
            ("k31", "radix", ("histogram_kernel", "scatter_kernel")),
            ("k63", "radix", ("histogram_kernel", "scatter_kernel")),
            ("lookup", "lookup", ("levels_kernel", "search_kernel"))):
        prof, calls = profs[f"profile {tag}"]
        spans, kernels = profile_events(prof)
        ms = sum(t for name, (_, t) in kernels.items()
                 if any(n in name for n in names)) / 1e3
        bound = sum(b for _, b in calls.calls) / HBM_BYTES_PER_S * 1e3
        shapes = {}
        for shape, _ in calls.calls:
            shapes[shape] = shapes.get(shape, 0) + 1
        device[tag] = {"ms": ms, "bound_ms": bound}
        log(f"phase 9 [{what}, {tag}]: {len(calls.calls)} calls "
            f"({', '.join(f'{n} x {s}' for s, n in shapes.items())}): "
            f"kernels {ms:.3f} ms on the card (profiler), bound {bound:.3f} "
            f"ms (each input read and each output written once at 3.35 TB/s)")
    wall = results["profile k31"][1]
    spans, kernels = profile_events(profs["profile k31"][0])
    log(f"phase 9: the k=31 sharded build under torch.profiler: {wall:.3f} s "
        f"wall (unprofiled: {results['build k31'][1]:.3f} s)")
    log_profile("phase 9", "the sharded k=31 build", wall, spans, kernels)
    return (sum(results[t][2]["radix_sort"] for t in ("build k31", "build k63")),
            results["lookup"][2]["lower_bound"], device)


class CallBytes:
    """Records each call of the kernel wrapper mod.name made while
    installed (ops/sort.py _sort_cuda, ops/lookup.py lower_bound): (its
    tensor arguments' shapes and dtypes, the bytes of its tensor
    arguments and of what it returns)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.calls = mod, name, []

    def __enter__(self):
        import torch

        real = self.real = getattr(self.mod, self.name)

        def tensors(x):
            if isinstance(x, torch.Tensor):
                return [x]
            if isinstance(x, (tuple, list)):
                return [t for y in x for t in tensors(y)]
            return []

        def spy(*args):
            out = real(*args)
            ins = tensors(args)
            shape = ", ".join(
                "x".join(map(str, t.shape)) + " " + str(t.dtype).split(".")[-1]
                for t in ins)
            self.calls.append((shape, sum(t.numel() * t.element_size()
                                          for t in ins + tensors(out))))
            return out

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def dist_only(torch, cli, torchinit, seed, smi):
    """--dist-only: phase 3's cohort and its .skf files built on the card
    (serial), phase 8's Gram inputs and their serial Grams, then phase 9
    at world size torch.cuda.device_count()."""
    from ska_tpu_torch import distance as D

    paths = [p for p, _ in make_cohort(GENOMES, seed)]
    for k, n in ((31, GENOMES), (63, GENOMES_K63)):
        quiet(cli.main, ["build", "-k", str(k), "-o",
                         os.path.join(WORK, f"k{k}"), "--device", DEVICE,
                         *paths[:n]])
    grams = {tag: (v, D.class_gram(v, DEVICE))
             for tag, v in gram_inputs(torch, seed).items()}
    t0 = time.perf_counter()
    radix, lookups, _ = phase_dist(torch, torchinit, grams)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s in all, {radix} radix "
        f"launches in the builds, {lookups} lookup launches in the lookup")
    from ska_tpu_torch import graft_entry

    dryrun(torch, graft_entry, torch.cuda.device_count())
    check("jax" not in sys.modules, "jax was imported")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def dist_helper(rank, world, port):
    """Rank `rank` (> 0) of phase 9: the same collective calls as rank 0,
    on the Gram inputs rank 0 wrote; nothing printed, nothing checked."""
    import numpy as np
    import torch

    from ska_tpu_torch import torchinit

    dist = join_group(torch, rank, world, port)
    grams = {tag: (np.load(os.path.join(WORK, f"gram_{tag}.npy")), None)
             for tag in ("k31.skf", "tree")}
    dist_calls(torch, torchinit, grams, lambda *a: None)
    dist.destroy_process_group()


# ---------------------------------------------------------------- phase 10


class StageLog(logging.Handler):
    """Keeps the (time, message) of each record of `ska lo`'s -v log."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))

    def at(self, pattern):
        """(time, match) of the first record matching `pattern`."""
        for t, msg in self.records:
            m = re.search(pattern, msg)
            if m:
                return t, m
        raise RuntimeError(f"chip_smoke: no log record matches {pattern!r}")

    def stages(self):
        """Seconds of the graph walk, the group assembly, the path filter
        and the SNP stage."""
        return {
            "graph walk": float(self.at(r"graph walk: ([\d.]+)s")[1][1]),
            "group assembly": float(self.at(r"group assembly: ([\d.]+)s")[1][1]),
            "path filter": (self.at(r"^Sorting variant groups")[0]
                            - self.at(r"^Filtering paths")[0]),
            "SNP stage": (self.at(r"^\d+ SNPs")[0]
                          - self.at(r"^Processing SNPs")[0]),
        }


def host_cpu():
    """The host's CPU model and its core count: /proc/cpuinfo's model
    name, else lscpu's, else platform.processor()."""
    import platform
    import shutil

    with open("/proc/cpuinfo") as f:
        model = next((ln.split(":", 1)[1].strip() for ln in f
                      if ln.lower().startswith("model name")), "")
    if not model and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.lower().startswith("model name")), "")
    model = model or platform.processor() or "CPU model not exposed"
    return f"{model}, {os.cpu_count()} cores"


def host_run(cli, torchinit, argv, stdout_path=None):
    """One CLI run of a host command with --device cuda, launch counters
    zeroed just before it; stdout goes to stdout_path (or is dropped).
    Returns the wall time; no kernel may have been launched."""
    torchinit.reset_launch_counts()
    t0 = time.perf_counter()
    with open(stdout_path or os.devnull, "w") as out, \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv + ["--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = torchinit.launch_counts()
    check(all(n == 0 for n in launches.values()),
          f"{argv[0]} launched a kernel: {launches}")
    return wall


def count_lines(path):
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            n += block.count(b"\n")
    return n


def phase_host_cmds(cli, torchinit, cohort):
    """`ska nk`, `delete`, `merge` and `lo` through cli.main with --device
    cuda. They are host code (the JAX package sends no part of them to
    its accelerator): no kernel may be launched in any of them.

    nk, delete and merge run at full width on phase 3's k31.skf (21
    genomes): nk's header and --full-info's one line per k-mer; delete
    of genomes 04-20 (names from a -f list) and of 00-03, then the merge
    of the two, whose keys, variants, counts and names must equal
    k31.skf's. lo runs on a cut: the first LO_BASES bases of the
    chromosome of genomes 00-03, as one-record FASTAs built on the card
    at k=31 and k=63. The cut is set by lo's path filter, a pure-Python
    loop over every kept path (about 2,800-7,000 paths/s, one thread).
    k=31 runs with -r (genome 00's cut chromosome, one record: lo takes
    no other) at --threads 1 and min(8, cores), whose four output files
    must be byte-equal; k=63 runs without a reference."""
    import numpy as np

    from ska_tpu_torch.io import skf

    log(f"phase 10: host CPU {host_cpu()}")
    k31 = os.path.join(WORK, "k31.skf")
    ref = skf.load(k31)
    names = list(ref.names)
    check(names == [f"genome{s:02d}" for s in range(GENOMES)],
          f"phase 10: k31.skf names {names}")

    nk_out = os.path.join(WORK, "nk31.txt")
    t_nk = host_run(cli, torchinit, ["nk", k31], nk_out)
    with open(nk_out) as f:
        head = f.read().split("\n")
    check(head[4] == f"k-mers={ref.ksize}" and head[5] == f"samples={GENOMES}",
          f"phase 10: nk printed {head[4]!r}, {head[5]!r}")
    full_out = os.path.join(WORK, "nk31_full.txt")
    t_full = host_run(cli, torchinit, ["nk", k31, "--full-info"],
                      full_out)
    n_lines = count_lines(full_out)
    # the header's 8 lines and a blank one, a line per k-mer, a blank one
    check(n_lines == 9 + ref.ksize + 1,
          f"phase 10: nk --full-info printed {n_lines} lines for "
          f"{ref.ksize} k-mers")
    log(f"phase 10 [nk]: k-mers={ref.ksize}, samples={GENOMES}; nk "
        f"{t_nk:.3f} s wall, --full-info {t_full:.3f} s wall "
        f"({os.path.getsize(full_out)} bytes, one line per k-mer)")
    os.remove(full_out)

    drop = os.path.join(WORK, "delete_04_20.txt")
    with open(drop, "w") as f:
        f.writelines(f"{n}\t{n}.fa\n" for n in names[4:])
    first4 = os.path.join(WORK, "k31_04")
    rest = os.path.join(WORK, "k31_rest")
    merged = os.path.join(WORK, "k31_merged")
    t_del04 = host_run(cli, torchinit,
                       ["delete", "-s", k31, "-o", first4, "-f", drop])
    t_delrest = host_run(cli, torchinit,
                         ["delete", "-s", k31, "-o", rest, *names[:4]])
    t_merge = host_run(cli, torchinit,
                       ["merge", first4 + ".skf", rest + ".skf", "-o", merged])
    got = skf.load(merged + ".skf")
    check(got.names == names and got.k == ref.k and got.rc == ref.rc,
          "phase 10: merge of the deleted halves: names, k or strand differ")
    check(np.array_equal(got.keys, ref.keys)
          and np.array_equal(got.variants, ref.variants)
          and np.array_equal(got.counts.astype(np.int64),
                             ref.counts.astype(np.int64)),
          "phase 10: merge of the deleted halves differs from k31.skf")
    same, size = same_bytes(merged + ".skf", k31)
    log(f"phase 10 [delete, merge]: delete of genomes 04-20 (-f) "
        f"{t_del04:.3f} s wall ({skf.load(first4 + '.skf').ksize} rows "
        f"left), of 00-03 {t_delrest:.3f} s, merge of the two {t_merge:.3f} "
        f"s: keys, variants, counts and names equal to k31.skf's; .skf "
        f"bytes {'equal' if same else 'NOT equal'} ({size} bytes)")

    lo_dir = os.path.join(WORK, "lo")
    os.makedirs(lo_dir, exist_ok=True)
    paths = []
    for s in range(LO_GENOMES):
        chrom = read_genome(cohort[s][0])[0][:LO_BASES]
        path = os.path.join(lo_dir, f"genome{s:02d}.fa")
        with open(path, "wb") as f:
            f.write(b">chromosome\n" + chrom.tobytes() + b"\n")
        paths.append(path)
    for k in (31, 63):
        cli.main(["build", "-k", str(k), "-o", os.path.join(lo_dir, f"k{k}"),
                  "--device", DEVICE, *paths])
    threads = min(8, os.cpu_count())
    runs = [
        ("k31_t1", 31, ["--threads", "1", "-r", paths[0]]),
        (f"k31_t{threads}", 31, ["--threads", str(threads), "-r", paths[0]]),
        ("k63", 63, []),
    ]
    skalo_log = logging.getLogger("ska_tpu_torch.skalo")
    skalo_log.setLevel(logging.INFO)
    skalo_log.propagate = False
    suffixes = ("_snps.fas", "_snps.vcf", "_indels.vcf", "_pseudo_genomes.fas")
    outputs = {}
    t_all = time.perf_counter()
    for tag, k, extra in runs:
        stages = StageLog()
        skalo_log.addHandler(stages)
        try:
            prefix = os.path.join(lo_dir, f"lo_{tag}")
            wall = host_run(cli, torchinit, [
                "lo", os.path.join(lo_dir, f"k{k}.skf"), prefix, "-v", *extra])
        finally:
            skalo_log.removeHandler(stages)
        outputs[tag] = {}
        for suffix in suffixes:
            if os.path.exists(prefix + suffix):
                with open(prefix + suffix, "rb") as f:
                    outputs[tag][suffix] = f.read()
        fas = outputs[tag]["_snps.fas"].split(b"\n")
        n_snps = len(fas[1])
        n_indels = sum(1 for ln in outputs[tag]["_indels.vcf"].split(b"\n")
                       if ln and not ln.startswith(b"#"))
        check(len(fas) == 2 * LO_GENOMES + 1 and n_snps > 0,
              f"phase 10 [lo {tag}]: _snps.fas holds {len(fas)} lines, "
              f"{n_snps} SNPs")
        times = ", ".join(f"{name} {t:.3f} s"
                          for name, t in stages.stages().items())
        paths_kept = stages.at(r"\((\d+) paths\)")[1][1]
        log(f"phase 10 [lo {tag}]: {wall:.3f} s wall ({times}); {paths_kept} "
            f"kept paths, {n_snps} SNPs, {n_indels} indel records, files "
            f"{sorted(outputs[tag])}")
    with_ref = [tag for tag, _, extra in runs if "-r" in extra]
    check(len(outputs[with_ref[0]]) == 4
          and outputs[with_ref[0]] == outputs[with_ref[1]],
          "phase 10: lo's four output files differ between thread counts")
    log(f"phase 10 [lo]: the four files of {with_ref[0]} and {with_ref[1]} "
        f"byte-equal; the three runs {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------- phase 11


def webapi_plan():
    """The front-end calls of phase 11: [(object tag, class, constructor
    args, [(call tag, method, args, card only)])]. Full width: phase 3's
    genomes and phase 5's 30x pair of genome 03; cut: phase 6's 200 kb
    pairs and the same 200 kb of the genomes' chromosomes (WORK/webapi)."""
    def g(s):
        return os.path.join(WORK, f"genome{s:02d}.fa")

    def cut(s):
        return os.path.join(WORK, "webapi", f"genome{s:02d}.fa")

    def small(s):
        return [os.path.join(WORK, "small", f"genome{s:02d}_{m}.fastq")
                for m in (1, 2)]

    reads03 = [os.path.join(WORK, "reads", f"genome03_{m}.fastq") for m in (1, 2)]
    return [
        ("SkaData k31", "SkaData", (g(0), 31), [
            ("map genome01", "map", (g(1),), False),
            ("map genome02", "map", (g(2),), False),
            ("map genome03", "map", (g(3),), False),
            ("map genome03 30x", "map", tuple(reads03), True),
            ("get_reference", "get_reference", (), False),
        ]),
        ("SkaData k63", "SkaData", (g(0), 63), [
            ("map genome01", "map", (g(1),), False),
        ]),
        ("AlignData k31", "AlignData", (31,), [
            ("align genomes 00-07", "align", ([g(s) for s in range(8)],), False),
            ("align + genome08, genome03 30x", "align", ([g(8), *reads03],), True),
        ]),
        ("SkaData cut", "SkaData", (cut(0), 31), [
            ("map genome03 reads", "map", tuple(small(3)), False),
            ("map genome04 reads", "map", tuple(small(4)), False),
            ("map genome01", "map", (cut(1),), False),
        ]),
        ("AlignData cut", "AlignData", (31,), [
            ("align 00-02, reads 03-04", "align",
             ([cut(0), cut(1), cut(2), *small(3), *small(4)],), False),
        ]),
    ]


def run_webapi(device, torch=None, torchinit=None):
    """Every call of webapi_plan() on `device`, in order; the card's run
    (torchinit given) also makes the card-only calls, and zeroes the
    launch counters just before each call (and each constructor) and
    reads them just after. Returns {"object / call": (output, wall s,
    {kernel: launches})}, the output None for a constructor."""
    from ska_tpu_torch import webapi

    out = {}

    def timed(tag, fn):
        if torchinit:
            torchinit.reset_launch_counts()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        if torchinit:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = torchinit.launch_counts() if torchinit else {}
        out[tag] = (res if isinstance(res, str) else None, wall, n)
        return res

    for obj_tag, cls, args, calls in webapi_plan():
        obj = timed(obj_tag, lambda: getattr(webapi, cls)(*args, device=device))
        for tag, method, cargs, card_only in calls:
            if card_only and not torchinit:
                continue
            timed(f"{obj_tag} / {tag}", lambda: getattr(obj, method)(*cargs))
    return out


def webapi_cpu(path):
    """--webapi-cpu: phase 11's plain CPU route, in a process of its own;
    writes {tag: [output, wall s]} as JSON to `path`."""
    res = run_webapi("cpu")
    with open(path, "w") as f:
        json.dump({tag: [r[0], r[1]] for tag, r in res.items()}, f)


def mapped_share(fasta_json, reads_json):
    """Share of the reference positions that the FASTA query maps (not
    '-') that the reads query maps too."""
    import numpy as np

    a, b = ("".join(json.loads(x)["Mapped sequences"]).encode()
            for x in (fasta_json, reads_json))
    fa = np.frombuffer(a, np.uint8) != ord("-")
    fq = np.frombuffer(b, np.uint8) != ord("-")
    return float((fa & fq).sum() / fa.sum()), int(fa.sum())


def phase_webapi(torch, torchinit, cohort):
    """The in-memory API (webapi.py) and graft_entry on the card; the
    FASTA and cut-reads calls against the plain CPU route, string for
    string; one warm FASTA map under torch.profiler. Returns the card's
    calls' {kernel: launches} and the profiled map's {kernel: device
    ms}."""
    import numpy as np

    from ska_tpu_torch import graft_entry
    from ska_tpu_torch.ops import sort as SO

    d = os.path.join(WORK, "webapi")
    os.makedirs(d, exist_ok=True)
    for s in range(3):
        with open(os.path.join(d, f"genome{s:02d}.fa"), "wb") as f:
            f.write(b">chromosome\n"
                    + read_genome(cohort[s][0])[0][:SMALL_BASES].tobytes()
                    + b"\n")
    cpu_json = os.path.join(d, "cpu.json")

    def cpu_route():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--webapi-cpu", cpu_json], cwd=REPO,
                           capture_output=True, text=True, timeout=900)
        check(r.returncode == 0, f"phase 11 CPU route: {r.stderr[-3000:]}")
        with open(cpu_json) as f:
            return json.load(f), time.perf_counter() - t0

    with cf.ThreadPoolExecutor(1) as pool, \
            CallBytes(SO, "_sort_cuda") as sorts:
        cpu_future = pool.submit(cpu_route)
        t0 = time.perf_counter()
        card = run_webapi(DEVICE, torch, torchinit)
        t_card = time.perf_counter() - t0
        cpu, t_cpu = cpu_future.result()
    log_sort_bounds("phase 11 [the card's calls]", sorts)

    launches = {"radix_sort": 0, "lower_bound": 0}
    for tag, (res, wall, n) in card.items():
        is_call = "/" in tag and not tag.endswith("get_reference")
        if is_call:
            check(n["radix_sort"] > 0,
                  f"phase 11 [{tag}]: the radix kernel was not launched")
            check(n["lower_bound"] > 0 or "/ map" not in tag,
                  f"phase 11 [{tag}]: the lookup kernel was not launched")
            for name in launches:
                launches[name] += n[name]
        same = ""
        if tag in cpu and res is not None:
            check(res == cpu[tag][0],
                  f"phase 11 [{tag}]: differs from the plain CPU route's")
            same = (f", {len(res)} characters equal to the plain CPU "
                    f"route's ({cpu[tag][1]:.3f} s there)")
        log(f"phase 11 [{tag}]: {wall:.3f} s wall, launches {n}{same}")

    share, n_pos = mapped_share(card["SkaData k31 / map genome03"][0],
                                card["SkaData k31 / map genome03 30x"][0])
    log(f"phase 11: the 30x reads query maps {100 * share:.3f}% of the "
        f"{n_pos} reference positions that genome03.fa maps")
    check(share >= 0.99, "phase 11: the reads query maps under 99% of the "
          "FASTA query's positions")
    doc = json.loads(card["AlignData k31 / align + genome08, genome03 30x"][0])
    check(doc["names"] == [f"genome{s:02d}.fa" for s in range(9)]
          + ["genome03_1.fastq"], f"phase 11: AlignData names {doc['names']}")
    # the Newick names drop ".fa" wherever it stands: genome03_1stq
    taxa = [f"genome{s:02d}" for s in range(9)] + ["genome03_1stq"]
    check(all(f"{t}:" in doc["newick"] for t in taxa)
          and doc["newick"].endswith(");")
          and doc["alignment"].count(">") == 10,
          "phase 11: the 10-sample tree or alignment is malformed")
    log(f"phase 11: the card's calls {t_card:.1f} s in all, the CPU route's "
        f"{t_cpu:.1f} s beside them (a process of its own); 10-taxon NJ "
        f"tree of {len(doc['newick'])} characters, alignment of "
        f"{len(doc['alignment'])}")

    # the kernels' device time in one warm k=31 FASTA map
    from ska_tpu_torch import webapi

    ska = webapi.SkaData(os.path.join(WORK, "genome00.fa"), 31, device=DEVICE)
    query = os.path.join(WORK, "genome01.fa")
    warm = ska.map(query)
    mapped = {}
    with CallBytes(SO, "_sort_cuda") as map_sorts:
        wall, _, kernels = profile_call(
            torch, lambda: mapped.__setitem__("json", ska.map(query)))
    map_bound = log_sort_bounds("phase 11 [SkaData k31 / map genome01]",
                                map_sorts)
    check(mapped["json"] == warm == card["SkaData k31 / map genome01"][0],
          "phase 11: the profiled map gave another JSON string")
    map_ms = {
        kernel: sum(t for name, (_, t) in kernels.items()
                    if any(n in name for n in names)) / 1e3
        for kernel, names in (
            ("radix_sort", ("histogram_kernel", "scatter_kernel")),
            ("lower_bound", ("levels_kernel", "search_kernel")))}
    log(f"phase 11 [SkaData k31 / map genome01, profiled]: {wall:.3f} s wall; "
        f"device time {', '.join(f'{k} {v:.3f} ms' for k, v in map_ms.items())}"
        f"; the radix sorts' bound {map_bound:.3f} ms")
    log_profile("phase 11", "the map", wall, {}, kernels, top=5)

    # graft_entry: the flagship step on the card and on the CPU
    fn, args = graft_entry.entry()
    torchinit.reset_launch_counts()
    t0 = time.perf_counter()
    with CallBytes(SO, "_sort_cuda") as entry_sorts:
        got = fn(*args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entry_bound = log_sort_bounds("phase 11 [entry]", entry_sorts)
    n = torchinit.launch_counts()["radix_sort"]
    want = fn(*(a.cpu() for a in args))
    check(n > 0, "phase 11 [entry]: the radix kernel was not launched")
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "phase 11 [entry]: the card's outputs differ from the CPU's")
    launches["radix_sort"] += n
    log(f"phase 11 [entry]: merged_build_pipeline of {tuple(args[0].shape)} "
        f"bases, {int(got[3])} rows, every output equal to the CPU's; "
        f"{wall:.3f} s wall (first call), {n} radix launches")
    dryrun(torch, graft_entry, torch.cuda.device_count())
    return launches, map_ms, {"map": map_bound, "entry": entry_bound}


def log_sort_bounds(what, sorts):
    """Log each shape of the radix sorts a CallBytes recorded, with its
    calls and the bound of one (each operand read and written once at
    the card's memory rate); returns the bound of them all, ms."""
    shapes = {}
    for shape, nbytes in sorts.calls:
        n, _ = shapes.get(shape, (0, 0))
        shapes[shape] = (n + 1, nbytes)
    for shape, (n, nbytes) in shapes.items():
        log(f"{what}: {n} radix sorts of [{shape}], bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms each")
    return sum(b for _, b in sorts.calls) / HBM_BYTES_PER_S * 1e3


def dryrun(torch, graft_entry, world):
    """graft_entry.dryrun_multichip(world) on the cards: NCCL, rows > 0
    and the radix kernel launched on rank 0 (its report, logged)."""
    records = StageLog()
    logger = logging.getLogger("ska_tpu_torch")
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        n_rows = graft_entry.dryrun_multichip(world)
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(records)
    report = json.loads(records.at(r"^dryrun_multichip: (.*)")[1][1])
    check(n_rows > 0 and report["backend"] == "nccl"
          and report["radix_sort"] > 0,
          f"phase 11 [dryrun_multichip({world})]: {report}")
    log(f"phase 11 [dryrun_multichip({world})]: {report}; {wall:.3f} s wall "
        f"(rank processes started, joined and run)")
    return report


# ---------------------------------------------------------------- phase 12

# the hand-written kernels' device functions, by the counter they count in
KERNEL_NAMES = {"radix_sort": ("histogram_kernel", "scatter_kernel"),
                "lower_bound": ("levels_kernel", "search_kernel")}
# Chrome-trace categories of the card's work and of the CUDA runtime
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime",
               "cuda_driver")


def switched_run(tag, argv, device_names, tries=3):
    """`python -m ska_tpu_torch <argv> --device cuda` in a process of its
    own under SKA_PROFILE=<dir> and SKA_DISPATCH_STATS=1: one trace,
    rank0.*.pt.trace.json, and one stats line. A trace that holds no
    device event named by each of `device_names` (the profiler once saw
    none, phase 2) is taken again, up to `tries` runs. Returns (stdout,
    wall s, stats, trace events)."""
    trace_dir = os.path.join(WORK, "observe", f"trace_{tag}")
    env = dict(os.environ, SKA_PROFILE=trace_dir, SKA_DISPATCH_STATS="1")
    for attempt in range(1, tries + 1):
        shutil.rmtree(trace_dir, ignore_errors=True)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "ska_tpu_torch", *argv, "--device", DEVICE],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"phase 12 [{tag}]: {r.stderr[-3000:]}")
        lines = re.findall(r"SKA_DISPATCH_STATS (\{.*\})", r.stderr)
        check(len(lines) == 1, f"phase 12 [{tag}]: {len(lines)} stats lines")
        traces = os.listdir(trace_dir)
        check(len(traces) == 1 and re.match(r"rank0\.\d+\.pt\.trace\.json$",
                                            traces[0]),
              f"phase 12 [{tag}]: trace files {traces}")
        with open(os.path.join(trace_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        on_card = [e["name"] for e in events if e.get("cat") == "kernel"]
        if all(any(n in k for k in on_card) for n in device_names):
            return r.stdout, wall, json.loads(lines[0]), events
        log(f"phase 12 [{tag}]: run {attempt} of {tries}: the trace holds "
            f"no device event of {device_names}")
    check(False, f"phase 12 [{tag}]: no trace held the kernels' events")


def trace_split(events):
    """(the traced wall time, {counter: device ms of its kernels}) of a
    Chrome trace: the span of its complete events, and the summed
    durations of each hand-written kernel's device events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    ms = {name: sum(float(e["dur"]) for e in spans
                    if e.get("cat") == "kernel"
                    and any(n in e["name"] for n in names)) / 1e3
          for name, names in KERNEL_NAMES.items()}
    return (t1 - t0) / 1e3, ms


def phase_observe(cohort, build63):
    """The two switches of `python -m ska_tpu_torch` on the card, each
    command in a process of its own: the k=63 build of phase 3 (its
    .skf bytes, its radix launches as phase 3 counted them for that
    build in-process), the k=31 VCF map of phase 7 (its bytes, 2 lookup
    launches) and `nk` (a CPU-only trace). No kernel is built again.
    `nk` runs beside the other two. Returns each run's {counter:
    launches}."""
    d = os.path.join(WORK, "observe")
    os.makedirs(d, exist_ok=True)
    k31, k63 = (os.path.join(WORK, f"k{k}.skf") for k in (31, 63))
    runs = [
        ("build", ["build", "-k", "63", "-o", os.path.join(d, "k63"),
                   *[p for p, _ in cohort[:GENOMES_K63]]],
         ("scatter_kernel",)),
        ("map", ["map", cohort[0][0], k31, "-f", "vcf", "-o",
                 os.path.join(d, "k31.vcf")], ("search_kernel",)),
        ("nk", ["nk", k31], ()),
    ]
    # nk touches no card: it runs in a thread beside the build and the map
    with cf.ThreadPoolExecutor(1) as pool:
        nk = pool.submit(switched_run, *runs[2])
        done = [(tag, switched_run(tag, argv, names))
                for tag, argv, names in runs[:2]]
        done.append(("nk", nk.result()))
    launches = {}
    for tag, (stdout, wall, stats, events) in done:
        names = {e.get("name", "") for e in events}
        traced_ms, ms = trace_split(events)
        launches[tag] = stats["launches"]
        check(stats["kernel_builds"] == 0,
              f"phase 12 [{tag}]: {stats['kernel_builds']} kernel builds")
        check(stats["kernel_launches"] == sum(stats["launches"].values()),
              f"phase 12 [{tag}]: stats {stats}")
        if tag == "build":
            same, size = same_bytes(os.path.join(d, "k63.skf"), k63)
            check(same, "phase 12 [build]: .skf bytes differ from phase 3's")
            check(stats["launches"] == build63,
                  f"phase 12 [build]: launches {stats['launches']}, phase 3 "
                  f"counted {build63} in-process")
            check("ska::device_pass" in names,
                  "phase 12 [build]: no ska::device_pass span in the trace")
            what = f".skf ({size} bytes) equal to phase 3's k63.skf"
        elif tag == "map":
            same, size = same_bytes(os.path.join(d, "k31.vcf"), os.path.join(
                WORK, "map", f"k31_vcf_{DEVICE}.vcf"))
            check(same, "phase 12 [map]: VCF bytes differ from phase 7's")
            check(stats["launches"]["lower_bound"] == 2,
                  f"phase 12 [map]: launches {stats['launches']}")
            what = f"VCF ({size} bytes) equal to phase 7's"
        else:
            check(stats["kernel_launches"] == 0,
                  f"phase 12 [nk]: launches {stats['launches']}")
            card = [e["name"] for e in events if e.get("cat") in DEVICE_CATS]
            check(not card, f"phase 12 [nk]: CUDA events in the trace: {card[:5]}")
            check(stdout.startswith("ska_version="),
                  f"phase 12 [nk]: stdout {stdout[:200]!r}")
            what = "a CPU-only trace"
        kernel_ms = sum(ms.values())
        log(f"phase 12 [{tag}]: {what}; {wall:.3f} s wall (a process of its "
            f"own); stats {json.dumps(stats)}; trace of {len(events)} events "
            f"over {traced_ms:.3f} ms: hand-written kernels "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f" on the card, {100 * kernel_ms / traced_ms:.3f}% of the traced "
            f"wall time")
    return launches


# ---------------------------------------------------------------- main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lookup-only", action="store_true",
                    help="phase 1 and phase 2's lookup alone: edge cases, "
                    "map's shape and the table-size sweep")
    ap.add_argument("--lookup-variants", metavar="SRC", default=None,
                    help="with --lookup-only: also time the splitter-window "
                    "design of the lookup from the lower_bound.cu at SRC, as "
                    "it is and at one block an SM, in the sweep and on the "
                    "real table (a k=31 build of the cohort)")
    ap.add_argument("--dist-only", action="store_true",
                    help="phase 1, the .skf files and Grams that phase 9 "
                    "compares with, and phase 9 (for a machine of several "
                    "cards)")
    # phase 9's ranks 1..: processes of this script, one per further card
    for flag in ("--dist-rank", "--dist-world", "--dist-port"):
        ap.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    # phase 11's plain CPU route: a process of this script
    ap.add_argument("--webapi-cpu", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch finds no CUDA device; it runs on a card only")
    if args.dist_rank is not None:
        return dist_helper(args.dist_rank, args.dist_world, args.dist_port)
    if args.webapi_cpu is not None:
        return webapi_cpu(args.webapi_cpu)
    from ska_tpu_torch import cli, kernels, torchinit
    from ska_tpu_torch.ops import keys as TK
    from ska_tpu_torch.ops import lookup as LU
    from ska_tpu_torch.ops import sort as SO

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ({smi})")

    # phase 1: the native libraries, built at once (one compiler each)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(kernels.build, "radix_sort"),
                  pool.submit(kernels.build, "lower_bound"),
                  pool.submit(kernels.build_host)]
        libs = [f.result() for f in builds]
    log(f"phase 1: built {libs} in {time.perf_counter() - t0:.1f} s")
    for so in libs:
        with open(so + ".log") as f:
            log(f.read().strip())

    if args.dist_only:
        return dist_only(torch, cli, torchinit, args.seed, smi)
    if args.lookup_only:
        return lookup_only(torch, TK, LU, SO, cli, dev, args, smi)

    # phase 2: each kernel against its plain version at the main path's shapes
    sort_res = {W: phase_sort(torch, SO, W, args.seed, dev) for W in (1, 2)}
    limbs_res = {W: phase_sort_limbs(torch, SO, W, args.seed, dev)
                 for W in (1, 2)}
    # phase 5's global (key, sample id) sort: 2 samples x 2^26 rows
    reads_res = phase_sort(torch, SO, 1, args.seed + 20, dev,
                           READS_SORT_LOG2, 2)
    # map's lookup: 2^21 reference split k-mers in 2^23 keys
    lookup_res = {W: phase_lookup(torch, SO, LU, TK, W, args.seed, dev)
                  for W in (1, 2)}
    t0 = time.perf_counter()
    sweep = lookup_sweep(torch, TK, dev, args.seed)
    log(f"phase 2: lookup sweep in {time.perf_counter() - t0:.1f} s")

    # phase 3: the main path
    t0 = time.perf_counter()
    cohort = make_cohort(GENOMES, args.seed)
    log(f"phase 3: cohort of {len(cohort)} genomes written in "
        f"{time.perf_counter() - t0:.1f} s")
    launches31, rate31, t31, _ = phase_main(torch, cli, torchinit, cohort,
                                            31, "k31")
    launches63, rate63, _, build63 = phase_main(
        torch, cli, torchinit, cohort[:GENOMES_K63], 63, "k63")
    log(f"end to end: {rate31:.0f} split k-mers/s at k=31 ({GENOMES} genomes), "
        f"{rate63:.0f} at k=63 ({GENOMES_K63} genomes)")

    # phase 4: where the time of the k=31 build goes
    phase_profile(torch, cli, ["-k", "31", *[p for p, _ in cohort]],
                  os.path.join(WORK, "k31.skf"), t31, "phase 4",
                  "k=31 build")

    # phase 5: reads at full width; phase 6: reads exactly
    launches_reads, rate_reads, _ = phase_reads(torch, cli, torchinit,
                                                cohort, args.seed)
    phase_exact(torch, cli, torchinit, cohort, args.seed)
    log(f"end to end: {rate_reads:.0f} split k-mers/s for the 5-sample reads "
        "build (k=31)")

    # phase 7: map; phase 8: distance
    launches_map, real_lookup = phase_map(torch, cli, torchinit, cohort)
    grams = phase_distance(torch, cli, torchinit, args.seed)

    # phase 9: the sharded paths on an NCCL group, one rank per card
    t0 = time.perf_counter()
    radix_dist, lookups_dist, device_dist = phase_dist(torch, torchinit, grams)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s in all")

    # phase 10: nk, delete, merge and lo, host code launching no kernel
    t0 = time.perf_counter()
    phase_host_cmds(cli, torchinit, cohort)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s in all")

    # phase 11: the front ends (webapi, graft_entry)
    t0 = time.perf_counter()
    launches_webapi, webapi_ms, webapi_bound = phase_webapi(torch, torchinit,
                                                            cohort)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s in all")

    # phase 12: the CLI's two switches, SKA_PROFILE and SKA_DISPATCH_STATS
    t0 = time.perf_counter()
    launches_observed = phase_observe(cohort, build63)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s in all")
    check("jax" not in sys.modules, "jax was imported")

    w1, w2 = sort_res[1], sort_res[2]
    l1, l2 = lookup_res[1], lookup_res[2]
    kernels_line = {"kernels": [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "ska_tpu_torch/csrc/radix_sort.cu",
        "replaces": "ska_tpu/ops/sort.py:178",
        "launches": (launches31["radix_sort"] + launches63["radix_sort"]
                     + launches_reads["radix_sort"] + radix_dist
                     + launches_webapi["radix_sort"]
                     + launches_observed["build"]["radix_sort"]),
        "max_abs_err": max(r["max_abs_err"] for r in (
            *sort_res.values(), *limbs_res.values(), reads_res)),
        "ms": w1["ms"],
        "plain_ms": w1["plain_ms"],
        "bound_ms": w1["bound_ms"],
        "bound_by": w1["bound_by"],
        "library_ms": None,
        "launches_per_sort": w1["launches_per_sort"],
        "ms_w2": w2["ms"],
        "plain_ms_w2": w2["plain_ms"],
        "bound_ms_w2": w2["bound_ms"],
        "launches_per_sort_w2": w2["launches_per_sort"],
        "launches_fasta": launches31["radix_sort"] + launches63["radix_sort"],
        "launches_reads": launches_reads["radix_sort"],
        "limbs_ms": limbs_res[1]["ms"],
        "limbs_plain_ms": limbs_res[1]["plain_ms"],
        "limbs_bound_ms": limbs_res[1]["bound_ms"],
        "limbs_library_ms": limbs_res[1]["library_ms"],
        "limbs_launches_per_sort": limbs_res[1]["launches_per_sort"],
        "limbs_ms_w2": limbs_res[2]["ms"],
        "limbs_plain_ms_w2": limbs_res[2]["plain_ms"],
        "limbs_bound_ms_w2": limbs_res[2]["bound_ms"],
        "limbs_launches_per_sort_w2": limbs_res[2]["launches_per_sort"],
        "reads_global_ms": reads_res["ms"],
        "reads_global_plain_ms": reads_res["plain_ms"],
        "reads_global_bound_ms": reads_res["bound_ms"],
        "reads_global_launches_per_sort": reads_res["launches_per_sort"],
        "launches_dist": radix_dist,
        "dist_ms": {t: device_dist[t]["ms"] for t in ("k31", "k63")},
        "dist_bound_ms": {t: device_dist[t]["bound_ms"] for t in ("k31", "k63")},
        "launches_webapi": launches_webapi["radix_sort"],
        "webapi_map_ms": webapi_ms["radix_sort"],
        "webapi_map_bound_ms": webapi_bound["map"],
        "entry_bound_ms": webapi_bound["entry"],
        "launches_observed": launches_observed["build"]["radix_sort"],
    }, {
        "name": "lower_bound",
        "route": "cuda",
        "source": "ska_tpu_torch/csrc/lower_bound.cu",
        "replaces": "ska_tpu/ops/keys.py:195",
        "launches": (launches_map + lookups_dist
                     + launches_webapi["lower_bound"]
                     + launches_observed["map"]["lower_bound"]),
        "max_abs_err": max(l1["max_abs_err"], l2["max_abs_err"]),
        "ms": l1["ms"],
        "plain_ms": l1["plain_ms"],
        "bound_ms": l1["bound_ms"],
        "bound_by": l1["bound_by"],
        "library_ms": l1["library_ms"],
        "launches_per_lookup": l1["launches_per_lookup"],
        "old_route_ms": l1["old_route_ms"],
        "device_ms": l1["device_ms"],
        "back_to_back_ms": l1["back_to_back_ms"],
        "library_device_ms": l1["library_device_ms"],
        "library_back_to_back_ms": l1["library_back_to_back_ms"],
        "ms_w2": l2["ms"],
        "plain_ms_w2": l2["plain_ms"],
        "bound_ms_w2": l2["bound_ms"],
        "bound_by_w2": l2["bound_by"],
        "launches_per_lookup_w2": l2["launches_per_lookup"],
        "old_route_ms_w2": l2["old_route_ms"],
        "device_ms_w2": l2["device_ms"],
        "back_to_back_ms_w2": l2["back_to_back_ms"],
        "launches_map": launches_map,
        "launches_dist": lookups_dist,
        "dist_ms": device_dist["lookup"]["ms"],
        "dist_bound_ms": device_dist["lookup"]["bound_ms"],
        "launches_webapi": launches_webapi["lower_bound"],
        "webapi_map_ms": webapi_ms["lower_bound"],
        "launches_observed": launches_observed["map"]["lower_bound"],
        "real_table_ms": real_lookup["ms"],
        "real_table_device_ms": real_lookup["device_ms"],
        "real_table_back_to_back_ms": real_lookup["back_to_back_ms"],
        "real_table_bound_ms": real_lookup["bound_ms"],
        "real_table_library_ms": real_lookup["library_ms"],
        "real_table_library_device_ms": real_lookup["library_device_ms"],
        "real_table_library_back_to_back_ms":
            real_lookup["library_back_to_back_ms"],
        "real_table_queued_ms": real_lookup["queued_ms"],
        "real_table_library_queued_ms": real_lookup["library_queued_ms"],
        "uniform_table_back_to_back_ms": real_lookup["uniform_back_to_back_ms"],
        "uniform_table_library_back_to_back_ms":
            real_lookup["uniform_library_back_to_back_ms"],
        "sweep": sweep,
    }]}
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
