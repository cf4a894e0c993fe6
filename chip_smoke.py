#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ska_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it needs one CUDA card and refuses to
run without one. Four phases, and any failure ends the run with a
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
GENOMES = 21
GENOMES_K63 = 4
CHROMOSOME = 1_950_000  # bases; the plasmid takes the rest of 2,000,000


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 2


def sort_rows(torch, W, N, seed, dev):
    """Tie-heavy rows made on the card: few distinct keys (top bits set),
    1/8 all-ones sentinels, 16 sample ids, random 4-bit sets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    limbs = [torch.randint(0, 4096, (N,), generator=g, device=dev) * GOLDEN]
    if W == 2:
        limbs.insert(0, torch.randint(0, 3, (N,), generator=g, device=dev))
    sent = torch.rand(N, generator=g, device=dev) < 0.125
    limbs = [torch.where(sent, -1, x).contiguous() for x in limbs]
    sid = torch.randint(0, 16, (N,), generator=g, device=dev, dtype=torch.int32)
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


def sort_bound(W, N):
    """Least time for one sort: each operand read once and written once
    at the card's memory rate, against N * ceil(log2 N) key-row
    comparisons of W+1 words at its non-tensor rate; the larger wins."""
    t_bytes = 2 * (8 * W + 5) * N / HBM_BYTES_PER_S
    t_ops = N * (N - 1).bit_length() * (W + 1) / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_sort(torch, SO, W, seed, dev):
    N = 1 << SORT_LOG2
    ops = sort_rows(torch, W, N, seed + W, dev)
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
    log(f"phase 2: radix sort W={W} N=2^{SORT_LOG2}: kernel "
        f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
        f"{bound:.3f} ms by {bound_by} ({100 * bound / res['ms']:.2f}% of "
        f"the bound), {launches} launches per sort (median of 6 each; "
        f"kernel runs {[round(x, 3) for x in kern]}, plain runs "
        f"{[round(x, 3) for x in plain]}); every operand equal to the plain "
        f"sort's")
    for name, (n, ms) in split.items():
        log(f"phase 2:   W={W} device {ms:.3f} ms in {n} launches "
            f"({ms / n:.3f} ms each): {name}")
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


def phase_profile(torch, cli, cohort, k, t_build):
    """Two more builds, warm: unprofiled, then per step span and per
    kernel times under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    paths = [p for p, _ in cohort]

    def build(tag):
        out = os.path.join(WORK, f"k{k}_{tag}")
        t0 = time.perf_counter()
        cli.main(["build", "-k", str(k), "-o", out, "--device", "cuda", *paths])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out + ".skf", "rb") as a, open(
                os.path.join(WORK, f"k{k}.skf"), "rb") as b:
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
    log(f"phase 4: k={k} build under torch.profiler: {wall:.3f} s wall "
        f"(unprofiled: {t_warm:.3f} s warm, {t_build:.3f} s as the first "
        f"build of phase 3); spans add up to {in_spans:.3f} s, the other "
        f"{wall - in_spans:.3f} s is outside every span")
    for name, (n, t) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"phase 4:   span {name}: {t / 1e3:.3f} ms host wall ({n} calls)")
    log(f"phase 4: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall: the "
        f"card ran nothing for {100 * (1 - busy / wall):.1f}% of the build")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, t) in top:
        log(f"phase 4:   device {t / 1e3:.3f} ms in {n} calls: {name[:100]}")


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
    phase_profile(torch, cli, cohort, 31, t31)
    check("jax" not in sys.modules, "jax was imported")

    w1, w2 = sort_res[1], sort_res[2]
    kernels_line = {"kernels": [{
        "name": "radix_sort",
        "route": "cuda",
        "source": "ska_tpu_torch/csrc/radix_sort.cu",
        "replaces": "ska_tpu/ops/sort.py:178",
        "launches": launches31["radix_sort"] + launches63["radix_sort"],
        "max_abs_err": max(r["max_abs_err"] for r in sort_res.values()),
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
