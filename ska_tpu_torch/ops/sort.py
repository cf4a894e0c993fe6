"""``sort_ops``: the lax.sort-compatible sort of the port (counterpart of
ska_tpu/ops/sort.py).

Contract, as in the JAX package: (B, L) or (L,) operands, ascending along
the last axis by the first ``num_keys`` operands. Key operands are int64
limbs compared unsigned, or int32; payloads may be any integer or bool
type. Both versions here are stable: equal rows keep their input order,
so they give the same output on every operand.

There is no silent route between the two versions:

- a CPU tensor takes the plain version (``_sort_plain``): LSD passes of a
  stable torch.sort over the unsigned-biased keys, last key first,
  carrying a gather index;
- a CUDA tensor launches the hand-written radix kernel
  (csrc/radix_sort.cu), or raises on operands it does not take. It takes
  rows of 1 or 2 int64 limbs, then an int32, then one uint8 payload;
  (B, L) operands are sorted row by row. Two contracts:
  - ``num_keys == W + 1``: by (limbs, int32), the merged build's
    (key, sample id) sort;
  - ``num_keys == W``: by the limbs alone, the int32 and the uint8 ride
    along as payload and the wrapper launches no pass for the int32's
    digits. Callers carry ``int32 = arange(L)``: the sort is stable, so
    that gives the (limbs, position) order of the JAX package's rank
    sorts, and the positions gather any wider payload afterwards.
"""

import torch

from .. import kernels
from .keys import SIGN

# CUDA launches of the radix kernels, the histogram and every scatter
# pass together (10 for one (key, sample id) sort of the main path's rows
# at W=1, 9 for one sort of 62-bit whole k-mers by the limbs alone)
radix_launches = 0
# rows handed to the radix kernels, by (W, num_keys): {(W, num_keys):
# [sorts, rows]}; a (B, L) operand counts B sorts, a row of fewer than 2
# elements none
radix_sorts = {}

RADIX_BITS = 8
RADIX_THREADS = 256  # threads of a block (csrc kThreads), one per bin
RADIX_ITEMS = {1: 15, 2: 11}  # rows per thread of a scatter tile, by W
HIST_ROWS = 4  # rows per thread per histogram step (csrc kHistRows)
MAX_ROWS = 1 << 30  # the tile status word holds counts below 2^30
_LIB = None


def sort_ops(ops, num_keys: int):
    """Sort the operands together, ascending by the first num_keys."""
    ops = tuple(ops)
    if ops[0].device.type == "cpu":
        return _sort_plain(ops, num_keys)
    return _sort_cuda(ops, num_keys)


def _sort_key(x):
    return x ^ SIGN if x.dtype == torch.int64 else x


def _sort_plain(ops, num_keys: int):
    """The plain version: least significant key first, stable passes."""
    perm = None
    for x in reversed(ops[:num_keys]):
        key = _sort_key(x)
        if perm is not None:
            key = key.gather(-1, perm)
        idx = torch.sort(key, dim=-1, stable=True).indices
        perm = idx if perm is None else perm.gather(-1, idx)
    return tuple(x.gather(-1, perm) for x in ops)


def digit_plan(W: int):
    """The radix kernel's digits, least significant first, as (operand,
    shift): the 4 bytes of the int32 key (operand W, sign bit flipped),
    then the 8 bytes of each limb, last limb first. Digit index d of the
    kernel's histogram is entry d."""
    plan = [(W, RADIX_BITS * b) for b in range(4)]
    for limb in range(W - 1, -1, -1):
        plan += [(limb, RADIX_BITS * b) for b in range(8)]
    return plan


def tile_rows(W: int) -> int:
    """Rows of a scatter tile (csrc kTile<W>)."""
    return RADIX_THREADS * RADIX_ITEMS[W]


def _lib():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = kernels.load("radix_sort")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ska_radix_histogram.argtypes = [i32, p, p, p, i64, p, i32, p]
        lib.ska_radix_histogram.restype = i32
        lib.ska_radix_scatter.argtypes = ([i32] + [p] * 8
                                          + [i64, i32, i32, p, p, i64, p])
        lib.ska_radix_scatter.restype = i32
        lib.ska_radix_tile.argtypes = [i32]
        lib.ska_radix_tile.restype = i32
        for W in (1, 2):
            if lib.ska_radix_tile(W) != tile_rows(W):
                raise RuntimeError(
                    f"radix_sort.cu tiles {lib.ska_radix_tile(W)} rows at "
                    f"W={W}, the wrapper expects {tile_rows(W)}")
        _LIB = lib
    return _LIB


def _check_kernel_ops(ops, num_keys: int):
    """The limb count W of operands the kernel takes, else raise."""
    W = len(ops) - 2
    dtypes = [x.dtype for x in ops]
    if (W not in (1, 2) or num_keys not in (W, W + 1)
            or dtypes != [torch.int64] * W + [torch.int32, torch.uint8]):
        raise TypeError(
            "the CUDA radix sort takes 1 or 2 int64 key limbs, an int32 "
            "and a uint8 payload, sorted by the limbs (num_keys=W) or by "
            f"the limbs and the int32 (num_keys=W+1); got "
            f"num_keys={num_keys}, {dtypes}"
        )
    x0 = ops[0]
    if x0.dim() not in (1, 2):
        raise ValueError(f"operands must be (L,) or (B, L), got {x0.shape}")
    for x in ops:
        if x.shape != x0.shape or x.device != x0.device:
            raise ValueError("operands must share one shape and one device")
        if not x.is_contiguous():
            raise ValueError("the CUDA radix sort takes contiguous operands")
    if x0.shape[-1] >= MAX_ROWS:
        raise ValueError(
            f"the CUDA radix sort takes rows of fewer than {MAX_ROWS} "
            f"elements, got {x0.shape[-1]}")
    return W


def _sort_cuda(ops, num_keys: int):
    W = _check_kernel_ops(ops, num_keys)
    keyed = num_keys > W
    if ops[0].dim() == 1:
        return _radix_sort(ops, W, keyed)
    rows = [_radix_sort(tuple(x[b] for x in ops), W, keyed)
            for b in range(ops[0].shape[0])]
    return tuple(torch.stack([r[i] for r in rows]) for i in range(len(ops)))


def _ptrs(xs, W):
    keys = [x.data_ptr() for x in xs[:W]] + [None] * (2 - W)
    return keys + [xs[W].data_ptr(), xs[W + 1].data_ptr()]


def sort_passes(trivial, W: int, keyed: bool):
    """The scatter passes of one sort, as (digit, operand, shift): every
    digit of the plan that varies, less the int32's digits when it is a
    payload (keyed False)."""
    return [(d, op, shift) for d, (op, shift) in enumerate(digit_plan(W))
            if not trivial[d] and (keyed or op < W)]


def _radix_sort(ops, W: int, keyed: bool):
    """One (L,) row: the histogram launch, the trivial-digit flags read
    back (one small copy, which waits for the histogram), then one
    scatter launch per remaining digit between two ping-pong buffer
    sets. Returns the buffers the last pass wrote, or the inputs
    themselves when no digit varies."""
    global radix_launches
    n = ops[0].numel()
    if n < 2:
        return ops
    tally = radix_sorts.setdefault((W, W + keyed), [0, 0])
    tally[0] += 1
    tally[1] += n
    lib = _lib()
    dev = ops[0].device
    D = 4 + 8 * W
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # hist[D][256] offsets[D][256] trivial[D] done
        scratch = torch.zeros(2 * D * 256 + D + 1, dtype=torch.int32,
                              device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(-(-n // (RADIX_THREADS * HIST_ROWS)), 4 * sms)
        err = lib.ska_radix_histogram(W, *_ptrs(ops, W)[:3], n,
                                      scratch.data_ptr(), blocks, stream)
        if err:
            raise RuntimeError(
                f"radix histogram kernel launch failed: CUDA error {err}")
        radix_launches += 1
        trivial = scratch[2 * D * 256 : 2 * D * 256 + D].tolist()
        passes = sort_passes(trivial, W, keyed)
        if not passes:
            return ops
        tiles = -(-n // tile_rows(W))
        words = 1 + tiles * 256  # tile counter, then [tiles][256] status
        status = torch.zeros(len(passes) * words, dtype=torch.int32,
                             device=dev)
        bufs = [tuple(torch.empty_like(x) for x in ops)
                for _ in range(min(2, len(passes)))]
        src = ops
        for i, (d, op, shift) in enumerate(passes):
            dst = bufs[i % 2]
            err = lib.ska_radix_scatter(
                W, *_ptrs(src, W), *_ptrs(dst, W), n, op, shift,
                scratch.data_ptr() + 4 * (D + d) * 256,
                status.data_ptr() + 4 * i * words, tiles, stream)
            if err:
                raise RuntimeError(
                    f"radix scatter kernel launch failed: CUDA error {err}")
            radix_launches += 1
            src = dst
    return src
