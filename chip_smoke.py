#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ska_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA card and refuses to
run without one. Six phases, and any failure ends the run with a
non-zero exit (nothing is caught, nothing moves to the CPU):

1. Build the port's native libraries from the sources in the checkout,
   both at once: the radix sort kernel (nvcc) and the host library
   (g++: the .skf codec, the batch union, the site filters).
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
   phase 5's global sort (2 samples x 2^26), every operand equal.
3. The main path: `ska build` of a cohort of 21 related 2 Mb genomes
   (S. pneumoniae size; each a 1.95 Mb chromosome plus a 50 kb plasmid
   with ~0.5% SNPs, short indels, an N run and IUPAC letters, made from
   --seed) at k=31, then `ska align`, through the CLI entry point of
   `python -m ska_tpu_torch` with --device cuda; then k=63 on the first 4
   genomes. Every kernel must have been launched during each run (launch
   counters zeroed just before it). The .skf bytes must equal those of
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

The last lines are the card's name and power limit (nvidia-smi), one
JSON line with each kernel's launches, error and times, and the result
line {"ok": true, "device": {...}}.
"""

import argparse
import concurrent.futures as cf
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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


def kernel_split(torch, fn):
    """Device time of each kernel of one call of fn, by torch.profiler:
    {kernel name: (launches, ms)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: (e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0}


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
    t0 = time.perf_counter()
    cli.main(["align", out + ".skf", "-o", out + ".aln", "--device", "cuda"])
    t_align = time.perf_counter() - t0
    launches = torchinit.launch_counts()
    log(f"phase 3 [{tag}]: CUDA launches during build+align: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    return launches, rate, t_build


# ---------------------------------------------------------------- phase 4


def phase_profile(torch, cli, argv, ref_skf, t_build, phase, what):
    """Two more builds of `argv`, warm: unprofiled, then per step span
    and per kernel times under the profiler. Both must write the bytes
    of ref_skf."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = build("profiled")
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
    check(kernels, "the profiler saw no device activity")
    busy = sum(t for _, t in kernels.values()) / 1e6
    in_spans = sum(t for _, t in spans.values()) / 1e6
    log(f"{phase}: {what} under torch.profiler: {wall:.3f} s wall "
        f"(unprofiled: {t_warm:.3f} s warm, {t_build:.3f} s as the first "
        f"build); spans add up to {in_spans:.3f} s, the other "
        f"{wall - in_spans:.3f} s is outside every span")
    for name, (n, t) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"{phase}:   span {name}: {t / 1e3:.3f} ms host wall ({n} calls)")
    log(f"{phase}: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall: the "
        f"card ran nothing for {100 * (1 - busy / wall):.1f}% of the build")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, t) in top:
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the reads path")
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


def phase_exact(torch, cli, torchinit, cohort, seed):
    """Reads at 200,000 bases per genome, card against the plain CPU
    route, .skf and stdout byte for byte."""
    genomes = [(f"genome{s:02d}", [read_genome(cohort[s][0])[0][:SMALL_BASES]])
               for s in range(len(DEPTHS))]
    tsv, samples, n_reads = write_reads(genomes, DEPTHS, seed + 1, "small")
    d = os.path.dirname(tsv)
    runs = [
        ("auto31", ["build", "-f", tsv, "-k", "31", "--min-count", "auto"]),
        ("k63", ["build", "-f", tsv, "-k", "63", "--min-count", "1",
                 "--qual-filter", "middle"]),
        ("cov00", ["cov", samples[0][1], samples[0][2]]),
        ("cov04", ["cov", samples[4][1], samples[4][2]]),
    ]
    env = dict(os.environ, SKA_MAX_CHUNK_BASES=str(SMALL_CAP))

    def argv(tag, args, dev):
        out = ["-o", os.path.join(d, f"{tag}_{dev}")] if args[0] == "build" else []
        return args + out + ["--device", dev]

    # the plain CPU route, each run in a process of its own, beside the
    # card's runs (so the card's wall times here share the host's cores)
    def cpu_route():
        res = {}
        for tag, args in runs:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "ska_tpu_torch", *argv(tag, args, "cpu")],
                cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
            check(r.returncode == 0, f"{tag} on the CPU route: {r.stderr[-2000:]}")
            res[tag] = (r.stdout, time.perf_counter() - t0)
        return res

    with cf.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(cpu_route)
        card = {}
        os.environ["SKA_MAX_CHUNK_BASES"] = str(SMALL_CAP)
        try:
            for tag, args in runs:
                torchinit.reset_launch_counts()
                t0 = time.perf_counter()
                stdout, _ = quiet(cli.main, argv(tag, args, DEVICE))
                torch.cuda.synchronize()
                card[tag] = (stdout, time.perf_counter() - t0,
                             torchinit.launch_counts())
        finally:
            del os.environ["SKA_MAX_CHUNK_BASES"]
        cpu = cpu.result()
    for tag, args in runs:
        stdout, t_card, launches = card[tag]
        for name, n in launches.items():
            check(n > 0, f"{tag}: kernel {name} was not launched")
        check(stdout == cpu[tag][0], f"{tag}: stdout differs from the CPU route's")
        what = "stdout"
        if args[0] == "build":
            with open(os.path.join(d, f"{tag}_{DEVICE}.skf"), "rb") as a, \
                    open(os.path.join(d, f"{tag}_cpu.skf"), "rb") as b:
                size = len(a.read())
                a.seek(0)
                check(a.read() == b.read(),
                      f"{tag}: .skf bytes differ from the plain CPU route's")
            what = f".skf ({size} bytes) and stdout"
        cut = stdout.count("\n")
        log(f"phase 6 [{tag}]: {what} equal to the plain CPU route's; card "
            f"{t_card:.3f} s wall, CPU route {cpu[tag][1]:.3f} s (a process of "
            f"its own); launches {launches}"
            + (f"; {cut - 1} histogram rows" if cut else ""))
    windows = n_reads * (READ_LEN - 31 + 1)
    log(f"phase 6: {n_reads} reads; the card's auto31 build (fit included) "
        f"{windows / card['auto31'][1]:.0f} split k-mers/s end to end")


# ---------------------------------------------------------------- main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch finds no CUDA device; it runs on a card only")
    from ska_tpu_torch import cli, kernels, torchinit
    from ska_tpu_torch.ops import sort as SO

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ({smi})")

    # phase 1: both native libraries, built at once
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(kernels.build, "radix_sort"),
                  pool.submit(kernels.build_host)]
        libs = [f.result() for f in builds]
    log(f"phase 1: built {libs} in {time.perf_counter() - t0:.1f} s")
    for so in libs:
        with open(so + ".log") as f:
            log(f.read().strip())

    # phase 2: each kernel against its plain version at the main path's shapes
    sort_res = {W: phase_sort(torch, SO, W, args.seed, dev) for W in (1, 2)}
    limbs_res = {W: phase_sort_limbs(torch, SO, W, args.seed, dev)
                 for W in (1, 2)}
    # phase 5's global (key, sample id) sort: 2 samples x 2^26 rows
    reads_res = phase_sort(torch, SO, 1, args.seed + 20, dev,
                           READS_SORT_LOG2, 2)

    # phase 3: the main path
    t0 = time.perf_counter()
    cohort = make_cohort(GENOMES, args.seed)
    log(f"phase 3: cohort of {len(cohort)} genomes written in "
        f"{time.perf_counter() - t0:.1f} s")
    launches31, rate31, t31 = phase_main(torch, cli, torchinit, cohort, 31, "k31")
    launches63, rate63, _ = phase_main(
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
    check("jax" not in sys.modules, "jax was imported")

    w1, w2 = sort_res[1], sort_res[2]
    kernels_line = {"kernels": [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "ska_tpu_torch/csrc/radix_sort.cu",
        "replaces": "ska_tpu/ops/sort.py:178",
        "launches": (launches31["radix_sort"] + launches63["radix_sort"]
                     + launches_reads["radix_sort"]),
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
