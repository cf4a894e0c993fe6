"""ska_tpu_torch.ops.sort on the CPU.

- The plain version of sort_ops against ska_tpu.ops.sort.sort_ops with
  interpret=True (the Pallas kernel in interpret mode, as
  tests/test_sort.py runs it), on tie-heavy rows with sentinels: keys
  exact, payloads as multisets.
- The CUDA radix kernel's algorithm, emulated in numpy with its own
  index math (digit plan and skip rule, per-tile stable ranks, look-back
  prefixes tile by tile, scatter offsets), must equal the plain sort
  exactly on every operand: the kernel itself cannot run here, so this
  is what holds it on the CPU.
- The wrapper's operand checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu.ops import sort as JS
from ska_tpu_torch.ops import sort as SO

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


def _digits(ops, W, op, shift):
    """Digit (op, shift) of every row, as the kernel extracts it: a limb's
    byte, or a byte of the int32 key with its sign bit flipped."""
    x = ops[op]
    if op == W:
        u = (x.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
        return (u >> shift) & 0xFF
    return ((x.view(np.uint64) >> np.uint64(shift)) & np.uint64(0xFF)).astype(
        np.int64)


def _emulate_histogram(ops, W):
    """histogram_kernel: per-digit bins, exclusive scans, trivial flags
    (one non-empty bin), in digit_plan order."""
    hist = np.stack([np.bincount(_digits(ops, W, op, sh), minlength=256)
                     for op, sh in SO.digit_plan(W)])
    return np.cumsum(hist, axis=1) - hist, (hist != 0).sum(axis=1) <= 1


def _lookback(counts, wave):
    """Decoupled look-back over per-tile digit counts (T, 256), run in a
    schedule a card may take: tiles start in waves of `wave`, every tile
    of a wave publishes its aggregate, then they look back in reverse
    order, so a walk crosses aggregates of its own wave before it meets a
    published prefix. Returns each tile's exclusive prefixes."""
    T = len(counts)
    flag = np.zeros(T, np.int64)  # 0 none, 1 aggregate, 2 prefix
    value = np.zeros_like(counts)
    excl = np.zeros_like(counts)
    for w0 in range(0, T, wave):
        tiles = range(w0, min(w0 + wave, T))
        for t in tiles:
            if t == 0:
                flag[t], value[t] = 2, counts[t]
            else:
                flag[t], value[t] = 1, counts[t]
        for t in reversed(tiles):
            if t == 0:
                continue
            j, acc = t - 1, np.zeros(256, np.int64)
            while True:
                assert flag[j], "a started tile has published"
                acc += value[j]
                if flag[j] == 2:
                    break
                j -= 1
            excl[t] = acc
            flag[t], value[t] = 2, acc + counts[t]
    return excl


def _emulate_pass(ops, W, op, shift, offsets, wave):
    """One scatter_kernel launch over (L,) rows, with its index math:
    warp w of a tile owns rows [w*32*I, (w+1)*32*I) (I rows per thread),
    lane l of round k row k*32+l; rank = earlier peers of the round + the warp's running count;
    slot = tile digit start + warp prefix + rank; slot q goes to
    offsets[d] + look-back prefix[d] - tile start[d] + q."""
    n = len(ops[0])
    dig = _digits(ops, W, op, shift)
    warps = SO.RADIX_THREADS // 32
    items = SO.RADIX_ITEMS[W]
    warp_rows = 32 * items
    tile_rows = SO.tile_rows(W)
    T = -(-n // tile_rows)
    lane = np.arange(32)
    tiles = []
    for tile in range(T):
        base = tile * tile_rows
        n_tile = min(tile_rows, n - base)
        wcount = np.zeros((warps, 256), np.int64)
        slot = np.full(tile_rows, -1)
        sdig = np.zeros(tile_rows, np.int64)
        for w in range(warps):
            for k in range(items):
                local = w * warp_rows + k * 32 + lane
                valid = base + local < n
                d = np.where(valid, dig[np.minimum(base + local, n - 1)], 256)
                below = np.tril(d[:, None] == d[None, :], -1).sum(axis=1)
                prev = wcount[w, np.minimum(d, 255)]
                np.add.at(wcount[w], d[valid], 1)
                slot[local[valid]] = (prev + below)[valid]
                sdig[local[valid]] = d[valid]
        count = wcount.sum(axis=0)
        wprefix = np.cumsum(wcount, axis=0) - wcount
        start = np.cumsum(count) - count
        rows = np.arange(n_tile)
        slot[rows] += start[sdig[rows]] + wprefix[rows // warp_rows, sdig[rows]]
        tiles.append((base, n_tile, slot, sdig, count, start))
    excl = _lookback(np.stack([t[4] for t in tiles]), wave)
    out = [np.empty_like(x) for x in ops]
    for (base, n_tile, slot, sdig, _, start), ex in zip(tiles, excl):
        rows = np.arange(n_tile)
        gdst = offsets + ex - start
        q_dig = np.empty(n_tile, np.int64)
        q_dig[slot[rows]] = sdig[rows]
        for x, o in zip(ops, out):
            sb = np.empty(n_tile, x.dtype)
            sb[slot[rows]] = x[base + rows]  # reorder in shared memory
            o[gdst[q_dig] + rows] = sb  # contiguous runs per digit
    return out


def _emulate_radix(ops, W, wave=3, keyed=True):
    """The wrapper's launches on one (L,) row: the histogram, then one
    scatter pass per digit that is not trivial (and, when the int32 is a
    payload, keyed False, none for its digits), ping-ponging."""
    offsets, trivial = _emulate_histogram(ops, W)
    passes = SO.sort_passes(trivial, W, keyed)
    for d, op, sh in passes:
        ops = _emulate_pass(ops, W, op, sh, offsets[d], wave)
    return ops, len(passes)


def _radix_rows(W, shape, seed):
    """_rows with negative int32 keys among the sample ids."""
    limbs, sid, sets = _rows(W, shape, seed)
    sid = np.random.default_rng(seed + 1).integers(
        -4, 12, size=shape).astype(np.int32)
    return limbs, sid, sets


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("shape", [(1,), (1000,), "a tile + 7", (3, 700)])
def test_radix_emulation_matches_plain(W, shape):
    """Every operand, the payload included, equals the stable plain sort."""
    if shape == "a tile + 7":
        shape = (SO.tile_rows(W) + 7,)
    limbs, sid, sets = _radix_rows(W, shape, seed=sum(shape) + W)
    ops = _tensors(limbs, sid, sets)
    want = _as_numpy(SO.sort_ops(ops, num_keys=W + 1), W)
    cols = [x.view(np.int64) for x in limbs] + [sid, sets]
    rows = [cols] if len(shape) == 1 else [[c[b] for c in cols]
                                           for b in range(shape[0])]
    got = [_emulate_radix(r, W, wave=1 + sum(shape) % 4)[0] for r in rows]
    for i, w in enumerate(want):
        g = np.stack([r[i] for r in got]).reshape(shape)
        assert np.array_equal(g.view(w.dtype), w), i


def _whole_kmer_rows(W, n, seed):
    """Rows as the reads build sorts them by the limbs alone: whole
    k-mer limbs of 62 (W=1) or 126 (W=2) bits, each key about 24 times,
    1/8 all-ones sentinels, the positions as the int32 and a uint8 of
    flags."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 62, size=(max(n // 24, 1), W), dtype=np.uint64)
    if W == 2:
        pool[:, 1] = rng.integers(0, 1 << 63, size=len(pool),
                                  dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    limbs = pool[rng.integers(0, len(pool), size=n)]
    limbs[rng.random(n) < 0.125] = ALL_ONES
    return ([limbs[:, i].copy() for i in range(W)],
            np.arange(n, dtype=np.int32),
            rng.integers(0, 32, size=n).astype(np.uint8))


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("n", [1, 1000, "a tile + 7"])
def test_radix_emulation_limbs_only_matches_plain(W, n):
    """The num_keys == W contract: the int32 rides along as payload, so
    the sort is by the limbs, stable, and every operand equals the plain
    sort's; the positions carried are the (limbs, position) order."""
    if n == "a tile + 7":
        n = SO.tile_rows(W) + 7
    limbs, pos, flags = _whole_kmer_rows(W, n, seed=n + W)
    ops = _tensors(limbs, pos, flags)
    want = _as_numpy(SO.sort_ops(ops, num_keys=W), W)
    cols = [x.view(np.int64) for x in limbs] + [pos, flags]
    got, _ = _emulate_radix(cols, W, wave=1 + n % 4, keyed=False)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(w.dtype), w)
    order = np.lexsort([pos] + [x for x in limbs[::-1]])
    assert np.array_equal(want[W], pos[order])


@pytest.mark.parametrize("W,passes", [(1, 8), (2, 16)])
def test_digit_plan_passes_limbs_only(W, passes):
    """Sorted by the limbs alone, 62- and 126-bit whole k-mers need 8 and
    16 scatter passes (9 and 17 launches with the histogram): none for
    the int32 payload, whose low bytes vary."""
    limbs, pos, flags = _whole_kmer_rows(W, 1 << 14, seed=W)
    cols = [x.view(np.int64) for x in limbs] + [pos, flags]
    _, trivial = _emulate_histogram(cols, W)
    assert not trivial[:2].any()  # the positions' low bytes vary
    assert len(SO.sort_passes(trivial, W, keyed=False)) == passes
    assert len(SO.sort_passes(trivial, W, keyed=True)) == passes + 2


@pytest.mark.parametrize("wave", [1, 3, 8])
def test_lookback_prefixes(wave):
    """Each tile's look-back prefix is the sum of all earlier tiles'
    counts, whatever order the tiles publish in."""
    counts = np.random.default_rng(wave).integers(0, 20, size=(9, 256))
    excl = _lookback(counts, wave)
    assert np.array_equal(excl, np.cumsum(counts, axis=0) - counts)


@pytest.mark.parametrize("W,passes", [(1, 9), (2, 17)])
def test_digit_plan_passes_at_main_path_shapes(W, passes):
    """Rows as the merged build sorts them (chip_smoke.py's sort rows):
    random key limbs (a small hi limb at W=2), 1/8 all-ones sentinels and
    16 sample ids, whose top 3 bytes never vary. The plan runs 9 scatter
    passes at W=1 and 17 at W=2, plus the histogram launch."""
    rng = np.random.default_rng(W)
    n = 1 << 14
    limbs = [rng.integers(0, 4096, size=n, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15)]
    if W == 2:
        limbs.insert(0, rng.integers(0, 3, size=n, dtype=np.uint64))
    sent = rng.random(n) < 0.125
    for x in limbs:
        x[sent] = ALL_ONES
    sid = rng.integers(0, 16, size=n).astype(np.int32)
    cols = [x.view(np.int64) for x in limbs] + [sid, np.zeros(n, np.uint8)]
    _, trivial = _emulate_histogram(cols, W)
    assert len(SO.digit_plan(W)) == 4 + 8 * W
    assert int((~trivial).sum()) == passes
    assert trivial[1:4].all() and not trivial[0]  # sample id: low byte only


def test_cpu_takes_plain_and_kernel_checks_operands():
    limbs, sid, sets = _rows(1, (64,), seed=3)
    ops = _tensors(limbs, sid, sets)
    before = SO.radix_launches
    SO.sort_ops(ops, num_keys=2)
    assert SO.radix_launches == before
    assert SO._check_kernel_ops(ops, 2) == 1
    assert SO._check_kernel_ops(ops, 1) == 1  # the int32 as payload
    with pytest.raises(TypeError):
        SO._check_kernel_ops(ops[:1] + (ops[1].long(), ops[2]), 2)
    with pytest.raises(TypeError):
        SO._check_kernel_ops(ops, 3)
    with pytest.raises(TypeError):
        SO._check_kernel_ops(ops[:1] + ops[2:], 1)
    with pytest.raises(ValueError):
        SO._check_kernel_ops((ops[0][::2], ops[1][::2], ops[2][::2]), 2)
    with pytest.raises(ValueError):
        SO._check_kernel_ops((ops[0], ops[1][:32], ops[2]), 2)
