"""``sort_ops``: the lax.sort-compatible sort of the port (counterpart of
ska_tpu/ops/sort.py).

Contract, as in the JAX package: (B, L) or (L,) operands, ascending along
the last axis by the first ``num_keys`` operands, unstable. Key operands
are int64 limbs compared unsigned, or int32; payloads may be any integer
or bool type.

There is no silent route between the two versions:

- a CPU tensor takes the plain version (``_sort_plain``): LSD passes of a
  stable torch.sort over the unsigned-biased keys, last key first,
  carrying a gather index;
- a CUDA tensor launches the hand-written bitonic kernel
  (csrc/bitonic_sort.cu), or raises on operands it does not take. It
  takes the merged build's rows: 1 or 2 int64 limbs, then an int32 key,
  then one uint8 payload.
"""

import torch

from .. import kernels
from .keys import SIGN

# CUDA launches of the bitonic kernels, tile and global passes together
# (120 for one sort of 2^25 rows: 15 tile launches and 105 global passes)
bitonic_launches = 0

TILE_LOG = 11  # rows per tile of the tile kernel: 2^11 (csrc kTileLogMax)
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


def _pad_pow2(ops, num_keys: int):
    """Pad the last axis to a power of two (at least 2). Pads carry the
    largest key of each key operand, all-ones limbs and INT32_MAX, so they
    sort after the real rows (after real all-ones sentinels too, whose
    int32 key is below INT32_MAX); payload pads are 0."""
    L = ops[0].shape[-1]
    Lp = max(2, 1 << (L - 1).bit_length())
    if Lp == L:
        return ops
    out = []
    for i, x in enumerate(ops):
        if i >= num_keys:
            fill = 0
        elif x.dtype == torch.int64:
            fill = -1
        else:
            fill = torch.iinfo(x.dtype).max
        pad = torch.full((*x.shape[:-1], Lp - L), fill, dtype=x.dtype,
                         device=x.device)
        out.append(torch.cat([x, pad], dim=-1))
    return tuple(out)


def _bitonic_plan(n: int, tlog: int = TILE_LOG):
    """Kernel launches of the bitonic network over rows of 2^n:
    ("tile", mm_lo, mm_hi) runs stages mm_lo..mm_hi over their strides
    below the tile, ("global", mm, j) one stride 2^j >= the tile."""
    t = min(tlog, n)
    plan = [("tile", 1, t)]
    for mm in range(t + 1, n + 1):
        plan += [("global", mm, j) for j in range(mm - 1, t - 1, -1)]
        plan.append(("tile", mm, mm))
    return plan


def _lib():
    global _LIB
    if _LIB is None:
        import ctypes

        lib = kernels.load("bitonic_sort")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ska_bitonic_tile.argtypes = [i32] + [p] * 8 + [i64, i64, i32, i32,
                                                         i32, p]
        lib.ska_bitonic_tile.restype = i32
        lib.ska_bitonic_global.argtypes = [i32] + [p] * 4 + [i64, i64, i32,
                                                             i32, p]
        lib.ska_bitonic_global.restype = i32
        _LIB = lib
    return _LIB


def _check_kernel_ops(ops, num_keys: int):
    W = num_keys - 1
    dtypes = [x.dtype for x in ops]
    if W not in (1, 2) or dtypes != [torch.int64] * W + [torch.int32,
                                                          torch.uint8]:
        raise TypeError(
            "the CUDA bitonic sort takes 1 or 2 int64 key limbs, an int32 "
            f"key and a uint8 payload; got num_keys={num_keys}, {dtypes}"
        )
    x0 = ops[0]
    if x0.dim() not in (1, 2):
        raise ValueError(f"operands must be (L,) or (B, L), got {x0.shape}")
    for x in ops:
        if x.shape != x0.shape or x.device != x0.device:
            raise ValueError("operands must share one shape and one device")
        if not x.is_contiguous():
            raise ValueError("the CUDA bitonic sort takes contiguous operands")
    return W


def _sort_cuda(ops, num_keys: int):
    global bitonic_launches
    W = _check_kernel_ops(ops, num_keys)
    L = ops[0].shape[-1]
    ops = _pad_pow2(ops, num_keys)
    Lp = ops[0].shape[-1]
    total = ops[0].numel()
    outs = [torch.empty_like(x) for x in ops]

    def ptrs(xs):
        keys = [x.data_ptr() for x in xs[:W]] + [None] * (2 - W)
        return keys + [xs[W].data_ptr(), xs[W + 1].data_ptr()]

    lib = _lib()
    n = Lp.bit_length() - 1
    t = min(TILE_LOG, n)
    with torch.cuda.device(ops[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        src = ops
        for step, a, b in _bitonic_plan(n):
            if step == "tile":
                err = lib.ska_bitonic_tile(W, *ptrs(src), *ptrs(outs), total,
                                           Lp, t, a, b, stream)
                src = outs
            else:
                err = lib.ska_bitonic_global(W, *ptrs(outs), total, Lp, a, b,
                                             stream)
            if err:
                raise RuntimeError(
                    f"bitonic {step} kernel launch failed: CUDA error {err}")
            bitonic_launches += 1
    return tuple(o[..., :L] for o in outs)
