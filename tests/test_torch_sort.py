"""ska_tpu_torch.ops.sort on the CPU.

- The plain version of sort_ops against ska_tpu.ops.sort.sort_ops with
  interpret=True (the Pallas kernel in interpret mode, as
  tests/test_sort.py runs it), on tie-heavy rows with sentinels: keys
  exact, payloads as multisets.
- The CUDA kernel's launch plan (_bitonic_plan), run with the kernel's
  pair and direction index math in torch, must sort: the kernel itself
  cannot run here, so this is what holds its network on the CPU.
- The wrapper's padding to a power of two and its operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu.ops import sort as JS
from ska_tpu_torch.ops import sort as SO
from ska_tpu_torch.ops.keys import SIGN

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rows(W, shape, seed):
    """W uint64 limbs (few distinct values, top bits set, ~1/8 all-ones
    sentinels), an int32 sample id and a uint8 IUPAC set."""
    rng = np.random.default_rng(seed)
    limbs = [
        rng.integers(0, 29, size=shape, dtype=np.uint64)
        * np.uint64(0x9E3779B97F4A7C15)
        for _ in range(W)
    ]
    sent = rng.random(shape) < 0.125
    for x in limbs:
        x[sent] = ALL_ONES
    sid = rng.integers(0, 6, size=shape).astype(np.int32)
    sets = rng.integers(1, 16, size=shape).astype(np.uint8)
    return limbs, sid, sets


def _tensors(limbs, sid, sets):
    return tuple(torch.from_numpy(x.view(np.int64)) for x in limbs) + (
        torch.from_numpy(sid),
        torch.from_numpy(sets),
    )


def _as_numpy(out, W):
    return [out[i].numpy().view(np.uint64) for i in range(W)] + [
        out[W].numpy(), out[W + 1].numpy()
    ]


def _multiset(cols):
    return sorted(zip(*[np.asarray(c).reshape(-1).tolist() for c in cols]))


@pytest.mark.parametrize("L", [1 << 13, 1 << 14])
@pytest.mark.parametrize("W", [1, 2])
def test_plain_matches_interpret_pallas(L, W):
    limbs, sid, sets = _rows(W, (L,), seed=L + W)
    got = _as_numpy(SO.sort_ops(_tensors(limbs, sid, sets), num_keys=W + 1), W)
    want = [
        np.asarray(x)
        for x in JS.sort_ops(
            tuple(jnp.asarray(x) for x in limbs)
            + (jnp.asarray(sid), jnp.asarray(sets.astype(np.int32))),
            num_keys=W + 1,
            interpret=True,
        )
    ]
    for g, w in zip(got[: W + 1], want[: W + 1]):
        assert np.array_equal(g, w)
    assert want[-1].max() < 16
    assert _multiset(got) == _multiset(want[:-1] + [want[-1].astype(np.uint8)])
    assert got[0][-1] == ALL_ONES  # unsigned order: sentinels last


def _emulate_kernel(ops, num_keys, tlog):
    """Every launch of _bitonic_plan as csrc/bitonic_sort.cu runs it:
    thread p of a launch takes the pair lo = p with a 0 bit inserted at
    j, hi = lo | 2^j, direction bit mm of lo's index in its row, and
    swaps when (hi < lo) differs from the direction. A tile launch does
    that for each of its (mm, j) in turn, which is the same arithmetic
    as a global pass over every tile at once."""
    xs = [x.clone() for x in ops]
    L = xs[0].shape[-1]
    p = torch.arange(L // 2)
    n = L.bit_length() - 1
    t = min(tlog, n)

    def cex(mm, j):
        lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1))
        hi = lo | (1 << j)
        desc = ((lo >> mm) & 1).bool()
        keys = [x ^ SIGN if x.dtype == torch.int64 else x for x in xs[:num_keys]]
        lt = torch.zeros(xs[0][..., lo].shape, dtype=torch.bool)
        eq = torch.ones_like(lt)
        for x in keys:
            a, b = x[..., lo], x[..., hi]
            lt |= eq & (b < a)
            eq &= b == a
        swap = lt != desc
        for x in xs:
            a, b = x[..., lo].clone(), x[..., hi].clone()
            x[..., lo] = torch.where(swap, b, a)
            x[..., hi] = torch.where(swap, a, b)

    for step, a, b in SO._bitonic_plan(n, tlog):
        if step == "tile":
            for mm in range(a, b + 1):
                for j in range(min(mm, t) - 1, -1, -1):
                    cex(mm, j)
        else:
            cex(a, b)
    return xs


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("L,tlog", [(1 << 10, 4), (1 << 9, 11), (2, 11)])
def test_kernel_plan_sorts(W, L, tlog):
    limbs, sid, sets = _rows(W, (2, L), seed=L * W + tlog)
    ops = _tensors(limbs, sid, sets)
    got = _as_numpy(_emulate_kernel(ops, W + 1, tlog), W)
    want = _as_numpy(SO.sort_ops(ops, num_keys=W + 1), W)
    for g, w in zip(got[: W + 1], want[: W + 1]):
        assert np.array_equal(g, w)
    for r in range(2):
        assert _multiset([c[r] for c in got]) == _multiset([c[r] for c in want])


def test_kernel_plan_counts():
    """At N = 2^25 and tiles of 2^11: 105 global passes, 15 tile launches,
    325 compare-exchange passes in all."""
    plan = SO._bitonic_plan(25)
    glob = [s for s in plan if s[0] == "global"]
    tiles = [s for s in plan if s[0] == "tile"]
    assert len(glob) == 105 and len(tiles) == 15
    per_tile = sum(
        min(mm, SO.TILE_LOG) for _, lo, hi in tiles for mm in range(lo, hi + 1)
    )
    assert per_tile + len(glob) == 25 * 26 // 2


@pytest.mark.parametrize("shape", [(1000,), (3, 700), (1,)])
def test_pad_pow2_sorts_pads_last(shape):
    W = 2
    limbs, sid, sets = _rows(W, shape, seed=sum(shape))
    ops = _tensors(limbs, sid, sets)
    padded = SO._pad_pow2(ops, W + 1)
    Lp = padded[0].shape[-1]
    assert Lp >= 2 and Lp & (Lp - 1) == 0 and Lp >= shape[-1]
    got = SO.sort_ops(padded, num_keys=W + 1)
    want = SO.sort_ops(ops, num_keys=W + 1)
    L = shape[-1]
    for g, w in zip(got, want):
        assert torch.equal(g[..., :L], w)


def test_cpu_takes_plain_and_kernel_checks_operands():
    limbs, sid, sets = _rows(1, (64,), seed=3)
    ops = _tensors(limbs, sid, sets)
    before = SO.bitonic_launches
    SO.sort_ops(ops, num_keys=2)
    assert SO.bitonic_launches == before
    assert SO._check_kernel_ops(ops, 2) == 1
    with pytest.raises(TypeError):
        SO._check_kernel_ops(ops[:1] + (ops[1].long(), ops[2]), 2)
    with pytest.raises(TypeError):
        SO._check_kernel_ops(ops, 1)
    with pytest.raises(ValueError):
        SO._check_kernel_ops((ops[0][::2], ops[1][::2], ops[2][::2]), 2)
    with pytest.raises(ValueError):
        SO._check_kernel_ops((ops[0], ops[1][:32], ops[2]), 2)
