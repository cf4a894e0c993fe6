"""``python -m ska_tpu_torch <cmd>``, for all ten subcommands: build,
align, map, distance, merge, delete, weed, nk, cov and lo.

The grammar is the JAX package's, whole (``build_parser``, a copy of
ska_tpu/cli.py's mirror of the reference's clap CLI, src/cli.rs:167-426),
plus ``--device`` (default: SKA_DEVICE, else ``cuda``), which may stand
anywhere on the line. ``merge``, ``delete``, ``nk`` and ``lo`` are host
code, as in the JAX package, which sends no part of them to its
accelerator: ``--device`` is accepted and has nothing to do for them.
``main`` is ska_tpu.cli's wrapper: a closed stdout exits 141 without a
traceback, a MemoryError with guidance prints it and exits 1, the banner
and the footer go to stderr, and ``--threads`` sets SKA_THREADS (which
map's AlnWriter and lo's two C++ cores read). With SKA_COORDINATOR set
the process joins its group first (parallel/multihost.py).

SKA_PROFILE=<dir> (ska_tpu.cli's switch) runs the command under
torch.profiler, started after the group join, and writes one Chrome
trace a process, ``<dir>/rank<r>.<ns>.pt.trace.json`` (r is the rank, 0
without a group; TensorBoard's profiler plugin and Perfetto read it). It
records CPU activity, and CUDA activity too where the command's device
is a card; the host commands record CPU activity alone and resolve no
device. The subcommand runs in the span ``ska::command``, around the
spans of its steps.
"""

import argparse
import contextlib
import logging
import os
import sys
import time

from .constants import (
    DEFAULT_AMBIGMASK,
    DEFAULT_AMBIGMISSING,
    DEFAULT_CONSTGAPS,
    DEFAULT_KMER,
    DEFAULT_MAX_INDEL_KMERS,
    DEFAULT_MAX_PATHDEPTH,
    DEFAULT_MINCOUNT,
    DEFAULT_MINFREQ,
    DEFAULT_MINQUAL,
    DEFAULT_MISSING_SKALO,
    DEFAULT_REPEATMASK,
    QUAL_FILTER_NAMES,
    check_k,
)

log = logging.getLogger("ska_tpu_torch")

# host code, as in the JAX package: no kernel, no device to resolve
HOST_COMMANDS = ("merge", "delete", "nk", "lo")


def _valid_kmer(s):
    try:
        return check_k(int(s))
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _zero_to_one(s):
    f = float(s)
    if not 0.0 <= f <= 1.0:
        raise argparse.ArgumentTypeError("Frequency must be between 0 and 1 (inclusive)")
    return f


def _threads(s):
    t = int(s)
    if t < 1:
        raise argparse.ArgumentTypeError("Threads must be one or higher")
    return t


def _min_count(s):
    if s == "auto":
        return "auto"
    x = int(s)
    if x < 1:
        raise argparse.ArgumentTypeError("Minimum kmer count must be >= 1")
    return x


def build_parser():
    p = argparse.ArgumentParser(
        prog="ska",
        description="SKA (PyTorch/CUDA port): Split K-mer Analysis, the alignment-free aligner",
    )
    p.add_argument("-v", "--verbose", action="store_true", help="Show progress messages")
    # the reference (clap) accepts -v after the subcommand too; SUPPRESS
    # keeps the subparser from clobbering a -v given before the subcommand
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        default=argparse.SUPPRESS,
        help="Show progress messages",
    )
    sub = p.add_subparsers(dest="command", required=True)
    _orig_add_parser = sub.add_parser

    def _add_parser(*a, **kw):
        kw.setdefault("parents", [common])
        return _orig_add_parser(*a, **kw)

    sub.add_parser = _add_parser

    filt_choices = ["no-filter", "no-const", "no-ambig", "no-ambig-or-const"]

    b = sub.add_parser("build", help="Create a split-kmer file from input sequences")
    b.add_argument("seq_files", nargs="*", help="List of input FASTA files")
    b.add_argument("-f", dest="file_list", help="File listing input files")
    b.add_argument("-o", dest="output", required=True, help="Output prefix")
    b.add_argument("-k", type=_valid_kmer, default=DEFAULT_KMER, help="K-mer size")
    b.add_argument("--proportion-reads", type=_zero_to_one, default=None)
    b.add_argument("--single-strand", action="store_true")
    b.add_argument("--min-count", type=_min_count, default=None)
    b.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    b.add_argument("--qual-filter", choices=list(QUAL_FILTER_NAMES), default="strict")
    b.add_argument("--threads", type=_threads, default=None)

    a = sub.add_parser("align", help="Write an unordered alignment")
    a.add_argument("input", nargs="+", help="A .skf file, or list of .fasta files")
    a.add_argument("-o", dest="output", default=None)
    a.add_argument("-m", "--min-freq", type=_zero_to_one, default=DEFAULT_MINFREQ)
    a.add_argument("--filter-ambig-as-missing", action="store_true", default=DEFAULT_AMBIGMISSING)
    a.add_argument("--filter", choices=filt_choices, default="no-const")
    a.add_argument("--ambig-mask", action="store_true", default=DEFAULT_AMBIGMASK)
    a.add_argument("--no-gap-only-sites", action="store_true", default=DEFAULT_CONSTGAPS)
    a.add_argument("--threads", type=_threads, default=None)

    m = sub.add_parser("map", help="Write an ordered alignment using a reference sequence")
    m.add_argument("reference")
    m.add_argument("input", nargs="+")
    m.add_argument("-o", dest="output", default=None)
    m.add_argument("-f", "--format", choices=["vcf", "aln"], default="aln")
    m.add_argument("--ambig-mask", action="store_true", default=DEFAULT_AMBIGMASK)
    m.add_argument("--repeat-mask", action="store_true", default=DEFAULT_REPEATMASK)
    m.add_argument("--threads", type=_threads, default=None)

    d = sub.add_parser("distance", help="Calculate SNP distances and k-mer mismatches")
    d.add_argument("skf_file")
    d.add_argument("-o", dest="output", default=None)
    d.add_argument("-m", "--min-freq", type=_zero_to_one, default=0.0)
    d.add_argument("--allow-ambiguous", action="store_true")
    d.add_argument("--threads", type=_threads, default=None)

    g = sub.add_parser("merge", help="Combine multiple split k-mer files")
    g.add_argument("skf_files", nargs="+")
    g.add_argument("-o", dest="output", required=True)

    de = sub.add_parser("delete", help="Remove samples from a split k-mer file")
    de.add_argument("-s", "--skf-file", required=True)
    de.add_argument("-o", dest="output", default=None)
    de.add_argument("-f", dest="file_list", default=None)
    de.add_argument("names", nargs="*")

    w = sub.add_parser("weed", help="Remove k-mers from a split k-mer file")
    w.add_argument("skf_file")
    w.add_argument("weed_file", nargs="?", default=None)
    w.add_argument("-o", dest="output", default=None)
    w.add_argument("--reverse", action="store_true")
    w.add_argument("-m", "--min-freq", type=_zero_to_one, default=DEFAULT_MINFREQ)
    w.add_argument("--filter-ambig-as-missing", action="store_true")
    w.add_argument("--filter", choices=filt_choices, default="no-filter")
    w.add_argument("--ambig-mask", action="store_true")
    w.add_argument("--no-gap-only-sites", action="store_true")

    n = sub.add_parser("nk", help="Get the number of k-mers in a split k-mer file")
    n.add_argument("skf_file")
    n.add_argument("--full-info", action="store_true")

    c = sub.add_parser("cov", help="Estimate a coverage cutoff from FASTQ k-mer counts")
    c.add_argument("fastq_fwd")
    c.add_argument("fastq_rev")
    c.add_argument("-k", type=_valid_kmer, default=DEFAULT_KMER)
    c.add_argument("--single-strand", action="store_true")

    lo = sub.add_parser("lo", help="Finds 'left out' SNPs and INDELs using a graph")
    lo.add_argument("input_skf")
    lo.add_argument("output")
    lo.add_argument("-r", "--reference", default=None)
    lo.add_argument("-m", "--missing", type=float, default=DEFAULT_MISSING_SKALO)
    lo.add_argument("-d", "--depth", type=int, default=DEFAULT_MAX_PATHDEPTH)
    lo.add_argument("-n", "--indel-kmers", type=int, default=DEFAULT_MAX_INDEL_KMERS)
    lo.add_argument("--threads", type=_threads, default=None)

    return p


def main(argv=None):
    # a downstream `| head` closes stdout early: exit silently with the
    # reference binary's SIGPIPE status instead of a traceback
    try:
        return _main(argv)
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        sys.exit(141)  # 128 + SIGPIPE
    except MemoryError as e:
        # a MemoryError raised WITH guidance is reported as such; a bare
        # one keeps its traceback (the allocation site is what helps)
        if not str(e):
            raise
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


def _main(argv=None):
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--device", default=None)
    opts, rest = pre.parse_known_args(argv)
    parser = build_parser()
    parser.prog = "python -m ska_tpu_torch"
    args = parser.parse_args(rest)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
        stream=sys.stderr,
    )
    print("SKA: Split K-mer Analysis (the alignment-free aligner)", file=sys.stderr)
    start = time.time()

    # the reference sizes its rayon pool with --threads; here the host
    # library's threaded stages (map's AlnWriter, lo's graph walk and SNP
    # stage) read SKA_THREADS. An explicit --threads wins over an
    # inherited SKA_THREADS.
    if getattr(args, "threads", None) is not None:
        os.environ["SKA_THREADS"] = str(args.threads)

    from .parallel import init_multihost

    # a multi-process run joins its group before anything touches a card
    joined = bool(os.environ.get("SKA_COORDINATOR")) and init_multihost(
        device=opts.device)
    try:
        with _profiled(args.command, opts.device):
            done = _run(args, opts.device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    if done:
        _footer(start)


@contextlib.contextmanager
def _profiled(cmd, device):
    """The command under torch.profiler when SKA_PROFILE names a
    directory: one Chrome trace of this process written there when the
    command returns, on every rank (one with nothing to do too)."""
    profile_dir = os.environ.get("SKA_PROFILE")
    if not profile_dir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cmd not in HOST_COMMANDS:
        from .torchinit import get_device

        if get_device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"rank{rank}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def _run(args, device) -> bool:
    """Run the subcommand in the span ``ska::command``, whose self time
    is the command's work outside its steps' spans (argument handling,
    checks, array construction, frees); False when this rank has nothing
    to do."""
    from torch.profiler import record_function

    with record_function("ska::command"):
        return _dispatch(args, device)


def _dispatch(args, device) -> bool:
    from torch.profiler import record_function

    from . import api
    from .io import fastx, skf
    from .parallel import is_primary, use_distributed
    from .sampletypes import QualOpts

    cmd = args.command
    primary = is_primary()
    # in a process group, build, map and distance (and align of FASTA
    # files, which builds first) run their collectives on every rank and
    # rank 0 writes; every other command runs on rank 0 alone
    collective = cmd in ("build", "map", "distance") or (
        cmd == "align" and len(args.input) > 1)
    if not primary and not (collective and use_distributed(device)):
        log.info("secondary process: '%s' runs on rank 0 only", cmd)
        return False
    if cmd == "build":
        input_files = fastx.get_input_list(args.file_list, args.seq_files or None)
        rc = not args.single_strand
        qual = QualOpts(
            min_count=_resolve_min_count(args, input_files, rc, device),
            min_qual=args.min_qual,
            qual_filter=QUAL_FILTER_NAMES[args.qual_filter],
        )
        arr = api.build(input_files, args.k, rc, qual, args.proportion_reads,
                        device=device)
        if primary:
            with record_function("ska::save"):
                skf.save(arr, args.output)
    elif cmd == "cov":
        from .coverage import CoverageHistogram

        cov = CoverageHistogram(args.fastq_fwd, args.fastq_rev, args.k,
                                not args.single_strand, args.verbose,
                                device=device)
        cutoff = cov.fit_histogram()
        cov.plot_hist()
        print(f"Estimated cutoff\t{cutoff}", file=sys.stderr)
    elif cmd == "align":
        arr = api.load_array(args.input, device=device)
        with _ostream(args.output, binary=True, primary=primary) as fh:
            api.align(
                arr,
                fh,
                filter_type=args.filter,
                ambig_mask=args.ambig_mask,
                ignore_const_gaps=args.no_gap_only_sites,
                min_freq=args.min_freq,
                filter_ambig_as_missing=args.filter_ambig_as_missing,
            )
    elif cmd == "map":
        arr = api.load_array(args.input, device=device)
        with _ostream(args.output, binary=args.format == "aln",
                      primary=primary) as fh:
            api.map_mode(arr, args.reference, fh, args.format,
                         args.ambig_mask, args.repeat_mask, device=device)
    elif cmd == "distance":
        arr = skf.load(args.skf_file)
        with _ostream(args.output, primary=primary) as fh:
            api.distance_mode(arr, fh, args.min_freq, not args.allow_ambiguous,
                              device=device)
    elif cmd == "merge":
        if len(args.skf_files) < 2:
            raise SystemExit("Need at least two files to merge")
        api.merge_mode(args.skf_files, args.output)
    elif cmd == "delete":
        input_files = fastx.get_input_list(args.file_list, args.names or None)
        names = [t[0] for t in input_files]
        arr = skf.load(args.skf_file)
        api.delete_mode(arr, names, args.output or args.skf_file)
    elif cmd == "nk":
        arr = skf.load(args.skf_file)
        print(arr.nk_display())
        if args.full_info:
            print(arr.nk_full_info())
    elif cmd == "lo":
        from .skalo import SkaloConfig, run_skalo

        arr = api.load_array([args.input_skf])
        config = SkaloConfig(
            output_name=args.output,
            max_missing=args.missing,
            max_depth=args.depth,
            max_indel_kmers=args.indel_kmers,
            reference_genome=args.reference,
        )
        run_skalo(arr, config)
    else:
        arr = skf.load(args.skf_file)
        api.weed_mode(
            arr,
            args.weed_file,
            args.reverse,
            args.min_freq,
            args.filter_ambig_as_missing,
            args.filter,
            args.ambig_mask,
            args.no_gap_only_sites,
            args.output or args.skf_file,
            device=device,
        )
    return True


def _footer(start):
    print(f"SKA done in {int(time.time() - start)}s", file=sys.stderr)
    print("⬛⬜⬛⬜⬛⬜⬛", file=sys.stderr)
    print("⬜⬛⬜⬛⬜⬛⬜", file=sys.stderr)


@contextlib.contextmanager
def _ostream(output, binary=False, primary=True):
    """The output file (closed after), or stdout (flushed after): bytes
    for alignments, text for VCF and TSV. A secondary rank of a process
    group writes nothing (os.devnull)."""
    if not primary:
        output = os.devnull
    if output is None:
        fh = sys.stdout.buffer if binary else sys.stdout
        try:
            yield fh
        finally:
            fh.flush()
    else:
        with open(output, "wb" if binary else "w") as fh:
            yield fh


def _resolve_min_count(args, input_files, rc, device) -> int:
    """--min-count auto fits the coverage model on the first two FASTQ
    samples' forward reads (reference io_utils.rs:175-212), as
    ska_tpu.cli does; the fit's table goes to stdout."""
    mc = args.min_count
    if mc is None:
        return DEFAULT_MINCOUNT
    if mc != "auto":
        return mc
    fastqs = [t for t in input_files if t[2] is not None]
    if len(fastqs) >= 2:
        from .coverage import CoverageHistogram

        cov = CoverageHistogram(fastqs[0][1], fastqs[1][1], args.k, rc,
                                args.verbose, device=device)
        out = cov.fit_histogram()
        cov.plot_hist()
        log.info("Using inferred minimum kmer value of %d", out)
        return out
    log.info("Not enough fastq files to fit mixture model, using default kmer count of 5")
    return DEFAULT_MINCOUNT
