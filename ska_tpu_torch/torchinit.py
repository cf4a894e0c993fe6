"""The port's device choice and kernel launch counters (the counterpart
of ska_tpu/jaxinit.py).

The device is chosen explicitly: a ``device=`` argument, else the
SKA_DEVICE environment variable, else ``cuda``. Asking for CUDA on a
machine without a card raises; nothing carries on quietly on the CPU.
Tests pass ``cpu``.

Each hand-written kernel's wrapper keeps a plain integer that it adds
one to where it launches its kernel, and nowhere else;
``launch_counts`` reads them all and ``reset_launch_counts`` zeroes them,
and the radix kernels' sorts and rows (``sort_counts``), the chunked
build's counters (``chunk_counts``), the merged build's
(``merged_counts``), the class Gram's (``gram_counts``) and the
`.skf` writer's (``save_counts``) with them.

SKA_DISPATCH_STATS=1 (the counterpart of ska_tpu/jaxinit.py's switch)
prints one stderr line when the process exits:

    SKA_DISPATCH_STATS {"kernel_launches": N, "launches": {...}, "radix_sorts": {...}, "kernel_builds": B, "chunked": {...}, "merged": {...}, "gram": {...}, "save": {...}}

``launches`` is ``launch_counts()`` at exit and ``kernel_launches`` their
sum: the hand-written kernels' launches, the port's counterpart of the
JAX package's jit dispatches (a torch op launches kernels of its own,
which nothing here counts). ``radix_sorts`` is ``sort_counts()`` at
exit: the sorts the radix kernels ran and the rows they sorted, by key
layout. ``kernel_builds`` is the compiler runs that ``kernels`` made in
this process, nvcc and g++ together, the counterpart of its backend
compiles. ``chunked`` is ``chunk_counts()`` at exit: the samples built
in chunks, their chunks, the rows the chunks handed to the host merge
and the bytes those rows took from the device to the host (sample.py; a
chunk is compacted on the device, so only its kept rows cross).
``merged`` is ``merged_counts()`` at exit: the merged build's batches
copied out, their rows and the bytes those rows took from the device to
the host (sample.py; a batch's ASCII, counts and presence are made on
the device). ``gram`` is ``gram_counts()`` at exit: the class Gram's
calls, its int8 products, the site rows they took, the widest one-hot's
columns and the one-hot bytes made (distance.py). ``save`` is
``save_counts()`` at exit: the `.skf` files
written, their snappy framing chunks, the most threads one save used
and the keys written as tag-2 bignums (io/skf.py). Every compute module
imports this one, so the CLI, webapi and graft_entry all report it. The line has the
form of the JAX package's, which scripts/bench_cmds.py's ``_STATS_RE``
matches, but that script runs the JAX CLI: the port's line is for
whoever runs a command of the port.
"""

import atexit
import json
import os
import sys

import torch


def get_device(device=None) -> torch.device:
    """Resolve ``device`` (None, a string or a torch.device) to a
    torch.device, falling back to SKA_DEVICE and then to ``cuda``."""
    if device is None:
        device = os.environ.get("SKA_DEVICE") or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch finds no CUDA "
            "device; pass --device cpu (or SKA_DEVICE=cpu) to run on the CPU"
        )
    return dev


def launch_counts() -> dict:
    """{kernel name: launches} since the last reset_launch_counts()."""
    from .ops import lookup, sort

    return {"radix_sort": sort.radix_launches,
            "lower_bound": lookup.lower_bound_launches}


def sort_counts() -> dict:
    """The radix kernels' sorts and the rows they sorted since the last
    reset_launch_counts(), by key layout: {"W=<limbs>,num_keys=<n>":
    {"sorts": .., "rows": ..}}. num_keys W + 1 is the (key, sample id)
    sort, W the limbs alone."""
    from .ops import sort

    return {f"W={w},num_keys={nk}": {"sorts": s, "rows": r}
            for (w, nk), (s, r) in sorted(sort.radix_sorts.items())}


def chunk_counts() -> dict:
    """The chunked build's counters since the last reset_launch_counts():
    samples built in chunks, chunks, rows handed to the host merge, and
    the bytes those rows took from the device to the host."""
    from . import sample

    return {"chunked_samples": sample.chunked_samples,
            "chunks": sample.chunks, "chunk_rows": sample.chunk_rows,
            "chunk_copy_bytes": sample.chunk_copy_bytes}


def merged_counts() -> dict:
    """The merged build's counters since the last reset_launch_counts():
    batches copied out, their rows, and the bytes those rows took from
    the device to the host."""
    from . import sample

    return {"merged_batches": sample.merged_batches,
            "merged_rows": sample.merged_rows,
            "merged_copy_bytes": sample.merged_copy_bytes}


def gram_counts() -> dict:
    """The class Gram's counters since the last reset_launch_counts():
    calls, chunks (one int8 product each), site rows with tail padding,
    the widest one-hot's columns, and the one-hot bytes made."""
    from . import distance

    return {"calls": distance.gram_calls, "chunks": distance.gram_chunks,
            "rows": distance.gram_row_count,
            "onehot_width": distance.gram_onehot_width,
            "onehot_bytes": distance.gram_onehot_bytes}


def save_counts() -> dict:
    """The `.skf` writer's counters since the last reset_launch_counts():
    files written, their framing chunks, the most threads one save used,
    and the keys written as tag-2 bignums."""
    from .io import skf

    return {"files": skf.saved_files, "chunks": skf.save_chunks,
            "max_threads": skf.save_threads, "wide_keys": skf.save_wide_keys}


def reset_launch_counts():
    from . import distance, sample
    from .io import skf
    from .ops import lookup, sort

    sort.radix_launches = 0
    sort.radix_sorts.clear()
    lookup.lower_bound_launches = 0
    sample.chunked_samples = sample.chunks = sample.chunk_rows = 0
    sample.chunk_copy_bytes = 0
    sample.merged_batches = sample.merged_rows = sample.merged_copy_bytes = 0
    distance.gram_calls = distance.gram_chunks = distance.gram_row_count = 0
    distance.gram_onehot_width = distance.gram_onehot_bytes = 0
    skf.saved_files = skf.save_chunks = skf.save_threads = 0
    skf.save_wide_keys = 0


def _print_dispatch_stats():
    """The SKA_DISPATCH_STATS line of this process, on stderr."""
    from . import kernels

    launches = launch_counts()
    stats = {"kernel_launches": sum(launches.values()), "launches": launches,
             "radix_sorts": sort_counts(), "kernel_builds": kernels.builds,
             "chunked": chunk_counts(), "merged": merged_counts(),
             "gram": gram_counts(), "save": save_counts()}
    print("SKA_DISPATCH_STATS " + json.dumps(stats), file=sys.stderr)


if os.environ.get("SKA_DISPATCH_STATS"):
    atexit.register(_print_dispatch_stats)
