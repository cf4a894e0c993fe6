"""``lower_bound``: the wrapper of the lookup kernel, csrc/lower_bound.cu
(counterpart of ops/sort.py for that kernel; ops/keys.py::lower_bound
routes to it).

The kernel takes an (N, W) int64 table whose rows are sorted as unsigned
words, first limb most significant, and (M, W) int64 queries, W = 1 or 2,
both contiguous on one CUDA device, and writes each query's lower bound
in [0, N] as int64: np.searchsorted(side="left"). Two launches a lookup:
the splitter copy (every 2^s-th table row, at most SPLITTER_BYTES of
them) and the search. The wrapper checks the operands and raises on
anything else; nothing here routes to another version.
"""

import torch

from .. import kernels

# CUDA launches of the lookup kernels, the splitter copy and the search
# together (2 for one lookup in a table of more than one row)
lower_bound_launches = 0

SPLITTER_BYTES = 1 << 17  # splitters' shared memory (csrc kSplitterBytes)
# the kernel addresses rows by int64 element offsets, row * W + limb
MAX_ROWS = 1 << 62
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = kernels.load("lower_bound")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ska_lower_bound_splitters.argtypes = [i32, p, i32, i32, p, p]
        lib.ska_lower_bound_splitters.restype = i32
        lib.ska_lower_bound_search.argtypes = [i32, p, i64, p, i32, i32, p,
                                               i64, p, p]
        lib.ska_lower_bound_search.restype = i32
        lib.ska_lower_bound_splitter_bytes.argtypes = []
        lib.ska_lower_bound_splitter_bytes.restype = i32
        if lib.ska_lower_bound_splitter_bytes() != SPLITTER_BYTES:
            raise RuntimeError(
                f"lower_bound.cu holds {lib.ska_lower_bound_splitter_bytes()} "
                f"bytes of splitters, the wrapper plans {SPLITTER_BYTES}")
        _LIB = lib
    return _LIB


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


def splitter_plan(n: int, W: int):
    """(s, splitters) for a table of n rows of W limbs: the splitters are
    rows 0, 2^s, 2*2^s, ... and s is the least that leaves at most
    SPLITTER_BYTES of them."""
    most = SPLITTER_BYTES // (8 * W)
    s = max(0, (n - 1).bit_length() - (most.bit_length() - 1))
    return s, (n + (1 << s) - 1) >> s


def lower_bound(sorted_keys, queries):
    """Launch the kernel: int64 lower bounds of the queries, (M,)."""
    global lower_bound_launches
    W = check_operands(sorted_keys, queries)
    n, m = sorted_keys.shape[0], queries.shape[0]
    dev = queries.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    log_stride, n_splitters = splitter_plan(n, W)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        splitters = torch.empty((n_splitters, W), dtype=torch.int64,
                                device=dev)
        if n_splitters:
            err = lib.ska_lower_bound_splitters(
                W, sorted_keys.data_ptr(), log_stride, n_splitters,
                splitters.data_ptr(), stream)
            if err:
                raise RuntimeError(
                    f"lower bound splitter kernel launch failed: CUDA error "
                    f"{err}")
            lower_bound_launches += 1
        err = lib.ska_lower_bound_search(
            W, sorted_keys.data_ptr(), n, splitters.data_ptr(), n_splitters,
            log_stride, queries.data_ptr(), m, out.data_ptr(), stream)
        if err:
            raise RuntimeError(
                f"lower bound search kernel launch failed: CUDA error {err}")
        lower_bound_launches += 1
    return out
