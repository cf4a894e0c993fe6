"""ska_tpu_torch.ops.keys against ska_tpu.ops.keys, exactly, for W=1 and
W=2, on random limbs with the top bit set and the all-ones sentinel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu.ops import keys as JK
from ska_tpu_torch.ops import keys as TK

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _limbs(W, n=600, seed=0):
    rng = np.random.default_rng(seed + W)
    x = rng.integers(0, 2**64 - 1, size=(n, W), dtype=np.uint64, endpoint=True)
    x[: n // 4] |= np.uint64(1 << 63)  # top bit set
    x[n // 4 : n // 4 + 8] = ALL_ONES
    x[n // 4 + 8 : n // 4 + 16] = 0
    return x


def _port(fn, x, *args):
    return TK.to_numpy_keys(fn(TK.from_numpy_keys(x), *args))


def _jax(fn, x, *args):
    return np.asarray(fn(jnp.asarray(x), *args))


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("fn", ["shl", "shr"])
def test_shifts(W, fn):
    x = _limbs(W)
    for s in [0, 1, 2, 4, 31, 32, 60, 63, 64, 65, 100, 124, 127, 128]:
        if W == 1 and s > 64:
            continue
        got = _port(getattr(TK, fn), x, s)
        want = _jax(getattr(JK, fn), x, s)
        assert np.array_equal(got, want), (fn, W, s)


def test_rev64():
    x = _limbs(1)[:, 0]
    got = TK.to_numpy_keys(TK._rev64(TK.from_numpy_keys(x)))
    assert np.array_equal(got, _jax(JK._rev64, x))


@pytest.mark.parametrize("W", [1, 2])
def test_rev_comp(W):
    rng = np.random.default_rng(5)
    for n_bases in ([1, 4, 15, 30, 31] if W == 1 else [16, 31, 32, 40, 62, 63]):
        # the value sits in the low 2*n_bases bits, as rev_comp requires
        x = _limbs(W, seed=n_bases)
        bits = 2 * n_bases
        if W == 1:
            x[:, 0] &= np.uint64((1 << bits) - 1)
        else:
            x[:, 0] &= np.uint64((1 << max(bits - 64, 0)) - 1)
        x[rng.integers(0, len(x), 20)] = 0
        got = _port(TK.rev_comp, x, n_bases)
        want = _jax(JK.rev_comp, x, n_bases)
        assert np.array_equal(got, want), (W, n_bases)


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("fn", ["greater", "equal"])
def test_compares(W, fn):
    a = _limbs(W, seed=1)
    b = _limbs(W, seed=2)
    b[::3] = a[::3]  # ties
    if W == 2:
        b[1::3, 0] = a[1::3, 0]  # hi ties, lo decides
    got = getattr(TK, fn)(TK.from_numpy_keys(a), TK.from_numpy_keys(b)).numpy()
    want = np.asarray(getattr(JK, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("W", [1, 2])
def test_from_scalar(W):
    for x in [0, 5, (1 << 63) + 7, (1 << 64) - 1, (1 << 100) + 3, (1 << 128) - 1]:
        got = TK.to_numpy_keys(TK.from_scalar(x, W))
        assert np.array_equal(got, np.asarray(JK.from_scalar(x, W))), (W, x)


def test_numpy_round_trip_is_a_view():
    x = _limbs(2)
    t = TK.from_numpy_keys(x)
    assert t.dtype == torch.int64 and t.shape == x.shape
    assert np.shares_memory(TK.to_numpy_keys(t), t.numpy())
    assert np.array_equal(TK.to_numpy_keys(t), x)
    # unsigned order: the all-ones sentinel is the largest key
    s = TK.from_numpy_keys(np.array([[ALL_ONES], [np.uint64(1)]]))
    assert bool(TK.greater(s[0], s[1]))
