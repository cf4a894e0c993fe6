"""``lower_bound``: the wrapper of the lookup kernel, csrc/lower_bound.cu
(counterpart of ops/sort.py for that kernel; ops/keys.py::lower_bound
routes to it).

The kernel takes an (N, W) int64 table whose rows are sorted as unsigned
words, first limb most significant, and (M, W) int64 queries, W = 1 or 2,
both contiguous on one CUDA device (the table may be a view at any int64
offset), and writes each query's lower bound in [0, N] as int64:
np.searchsorted(side="left").

It searches a B-tree of 128-byte lines built for each lookup: level l is
the table's rows 0, R^l, 2 R^l, ... (R = 16 rows a line at W=1, 8 at
W=2), level 0 the table, and the splitters above the top level L, every
2^shift-th row, live in shared memory. ``plan`` fixes L and the top
level's width (one or two lines) from N; a query then makes a binary
lifting over the splitters and reads one line a level below them (two at
the top when the plan says so), 2 or 3 dependent round trips at map's
shapes. Two launches a lookup, back to back on the current stream: the
levels (splitters included), then the search. The launch plan is the
same for every N: 1024 threads a block, one block an SM, the shared
memory limit and carveout set once a device (``_prepare``). The wrapper
checks the operands and raises on anything else; nothing here routes to
another version.
"""

import contextlib
import functools
from typing import NamedTuple

import torch

from .. import kernels

# CUDA launches of the lookup kernels, the levels and the search together
# (2 for one lookup in a table of at least one row)
lower_bound_launches = 0

SPLITTER_BYTES = 1 << 17  # splitters' shared memory (csrc kSplitterBytes)
LINE_BYTES = 128  # one node of the levels (csrc kLineBytes)
THREADS = 1024  # search threads a block, one block an SM (csrc kThreads)
# the kernel addresses rows by int64 element offsets, row * W + limb
MAX_ROWS = 1 << 62
_LIB = None
_SMS = {}  # CUDA device index -> its SMs, once _prepare has run there


class Plan(NamedTuple):
    """Where a table of n rows is searched from: ``levels`` levels (L)
    below ``splitters`` splitters, every 2^``shift``-th row, and a top
    level 2^``log_lines`` lines wide; ``rows`` the rows of the buffer
    that holds the splitters and levels L, ..., 1 (level l: the
    ceil(n / R^l) rows 0, R^l, 2 R^l, ...), each padded to whole lines."""
    levels: int
    log_lines: int
    shift: int
    splitters: int
    rows: int


def line_rows(W: int) -> int:
    """Rows of W limbs in a line of the levels."""
    return LINE_BYTES // (8 * W)


def plan(n: int, W: int) -> Plan:
    """The least number of levels L, then the least top width f in
    (1, 2) lines, that leave at most SPLITTER_BYTES of splitters, every
    R^(L+1) * f-th row of n (R = line_rows(W))."""
    return _plan(n, W, SPLITTER_BYTES, LINE_BYTES)


# cached: the wrapper's host time is part of every lookup's
@functools.lru_cache(maxsize=256)
def _plan(n: int, W: int, splitter_bytes: int, line_bytes: int) -> Plan:
    R = line_bytes // (8 * W)
    r = R.bit_length() - 1
    most = splitter_bytes // (8 * W)
    pad = lambda x: -(-x // R) * R  # noqa: E731
    levels = 0
    while True:
        for log_lines in (0, 1):
            shift = r * (levels + 1) + log_lines
            splitters = -(-n // (1 << shift))
            if splitters <= most:
                return Plan(levels, log_lines, shift, splitters, pad(
                    splitters) + sum(pad(-(-n // (1 << (r * l))))
                                     for l in range(1, levels + 1)))
        levels += 1


def _lib():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = kernels.load("lower_bound")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ska_lower_bound.argtypes = [i32, p, i64, p, i32, i32, i32, p,
                                        i64, p, i32, p]
        lib.ska_lower_bound.restype = i32
        lib.ska_lower_bound_prepare.argtypes = []
        lib.ska_lower_bound_prepare.restype = i32
        for name, want in (("splitter_bytes", SPLITTER_BYTES),
                           ("line_bytes", LINE_BYTES), ("threads", THREADS)):
            fn = getattr(lib, f"ska_lower_bound_{name}")
            fn.argtypes, fn.restype = [], i32
            if fn() != want:
                raise RuntimeError(f"lower_bound.cu has {name} {fn()}, the "
                                   f"wrapper plans {want}")
        _LIB = lib
    return _LIB


def _prepare(lib, index: int) -> int:
    """The SM count of CUDA device `index` (current), after the kernels'
    shared memory limit and carveout are set there: once a device."""
    sms = _SMS.get(index)
    if sms is None:
        err = lib.ska_lower_bound_prepare()
        if err:
            raise RuntimeError(
                f"lower bound kernel setup failed: CUDA error {err}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SMS[index] = sms
    return sms


def check_operands(sorted_keys, queries) -> int:
    """The limb count W of a table and queries the kernel takes, else
    raise."""
    for name, x in (("sorted_keys", sorted_keys), ("queries", queries)):
        if x.dtype != torch.int64:
            raise TypeError(f"the CUDA lower bound takes int64 key limbs; "
                            f"{name} is {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"the CUDA lower bound takes (rows, W) keys; "
                             f"{name} has shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"the CUDA lower bound takes contiguous keys; "
                             f"{name} is not")
        if x.shape[0] >= MAX_ROWS:
            raise ValueError(
                f"the CUDA lower bound indexes fewer than 2^62 rows; {name} "
                f"has {x.shape[0]}")
    W = sorted_keys.shape[1]
    if queries.shape[1] != W:
        raise ValueError(f"keys of {W} limbs and queries of "
                         f"{queries.shape[1]} do not compare")
    if W not in (1, 2):
        raise ValueError(f"the CUDA lower bound takes 1 or 2 limbs, got {W}")
    if sorted_keys.device != queries.device or not queries.is_cuda:
        raise ValueError(
            f"the CUDA lower bound takes keys and queries on one CUDA "
            f"device, got {sorted_keys.device} and {queries.device}")
    return W


def lower_bound(sorted_keys, queries):
    """Launch the kernel: int64 lower bounds of the queries, (M,)."""
    global lower_bound_launches
    W = check_operands(sorted_keys, queries)
    n, m = sorted_keys.shape[0], queries.shape[0]
    dev = queries.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    p = plan(n, W)
    buf = torch.empty((p.rows, W), dtype=torch.int64, device=dev)
    lib = _lib()
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        blocks = min(_prepare(lib, dev.index), -(-m // THREADS))
        err = lib.ska_lower_bound(
            W, sorted_keys.data_ptr(), n, buf.data_ptr(), p.levels,
            p.log_lines, p.splitters, queries.data_ptr(), m, out.data_ptr(),
            blocks, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lower bound kernel launch failed: CUDA error {err}")
    lower_bound_launches += 2 if n else 1
    return out
