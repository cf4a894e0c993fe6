"""``python -m ska_tpu_torch build|align``.

The grammar is the JAX package's (ska_tpu.cli.build_parser), plus
``--device`` (default: SKA_DEVICE, else ``cuda``), which may stand
anywhere on the line. Other subcommands are not ported yet and are
refused.
"""

import argparse
import logging
import sys

from ska_tpu.cli import build_parser
from ska_tpu.constants import DEFAULT_MINCOUNT, QUAL_FILTER_NAMES

PORTED = ("build", "align")


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--device", default=None)
    opts, rest = pre.parse_known_args(argv)
    parser = build_parser()
    parser.prog = "python -m ska_tpu_torch"
    args = parser.parse_args(rest)
    if args.command not in PORTED:
        parser.exit(2, f"{parser.prog}: '{args.command}' is not ported yet "
                       f"(ported: {', '.join(PORTED)}); run it with ./ska.py\n")
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
        stream=sys.stderr,
    )

    from ska_tpu.io import fastx, skf
    from ska_tpu.sampletypes import QualOpts
    from torch.profiler import record_function

    from . import api

    if args.command == "build":
        if args.min_count == "auto":
            raise NotImplementedError(
                "--min-count auto is not ported yet (ROADMAP A11)")
        qual = QualOpts(
            min_count=DEFAULT_MINCOUNT if args.min_count is None else args.min_count,
            min_qual=args.min_qual,
            qual_filter=QUAL_FILTER_NAMES[args.qual_filter],
        )
        input_files = fastx.get_input_list(args.file_list, args.seq_files or None)
        arr = api.build(input_files, args.k, not args.single_strand, qual,
                        args.proportion_reads, device=opts.device)
        with record_function("ska::save"):
            skf.save(arr, args.output)
    else:
        arr = api.load_array(args.input, device=opts.device)
        fh = open(args.output, "wb") if args.output else sys.stdout.buffer
        try:
            api.align(
                arr,
                fh,
                filter_type=args.filter,
                ambig_mask=args.ambig_mask,
                ignore_const_gaps=args.no_gap_only_sites,
                min_freq=args.min_freq,
                filter_ambig_as_missing=args.filter_ambig_as_missing,
            )
        finally:
            if args.output:
                fh.close()
            else:
                fh.flush()
