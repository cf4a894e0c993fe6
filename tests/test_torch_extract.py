"""ska_tpu_torch.ops.extract.extract_windows against the JAX function,
exactly: odd k from 5 to 63, rc on and off, N runs and IUPAC letters,
multi-record samples (record-final windows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu.io import fastx
from ska_tpu.ops import extract as JX
from ska_tpu.ops.npkeys import width_for_k
from ska_tpu_torch.ops import extract as TX
from ska_tpu_torch.ops import keys as TK

ALPHABET = np.frombuffer(b"ACGTNRY", np.uint8)
P = [0.24, 0.24, 0.24, 0.24, 0.02, 0.01, 0.01]


def _batch(k, S=2, L=768, seed=0):
    """(S, L) padded flat record batches with N runs and several records."""
    rng = np.random.default_rng(seed + k)
    seq = np.zeros((S, L), np.uint8)
    rec_last = np.zeros((S, L), bool)
    for s in range(S):
        recs = []
        for _ in range(int(rng.integers(2, 5))):
            r = rng.choice(ALPHABET, size=int(rng.integers(k - 2, 200)), p=P)
            if rng.random() < 0.5:  # an N run
                a = int(rng.integers(0, len(r)))
                r[a : a + int(rng.integers(1, 12))] = ord("N")
            recs.append(r.tobytes())
        b = fastx.build_batch(recs, [None] * len(recs))
        seq[s, : len(b.seq)] = b.seq
        rec_last[s, : len(b.seq)] = b.rec_last
    valid = ((seq & 0xF) != 14) & (seq != 0)
    return seq, valid, rec_last


@pytest.mark.parametrize(
    "k,rc", [(k, rc) for k in (5, 9, 17, 31, 33, 63) for rc in (True, False)]
)
def test_extract_windows_matches_jax(k, rc):
    W = width_for_k(k)
    seq, valid, rec_last = _batch(k)
    got = TX.extract_windows(
        torch.from_numpy(seq), torch.from_numpy(valid),
        torch.from_numpy(rec_last), k, rc, W, want_whole=True,
    )
    assert got["emit"].any()
    for s in range(seq.shape[0]):
        want = JX.extract_windows(
            jnp.asarray(seq[s]), jnp.asarray(valid[s]), jnp.asarray(rec_last[s]),
            k, rc, W, want_whole=True,
        )
        for name in ("key", "whole"):
            assert np.array_equal(
                TK.to_numpy_keys(got[name][s]), np.asarray(want[name])
            ), (name, s)
        for name in ("mid", "is_rc", "pal", "emit"):
            assert np.array_equal(got[name][s].numpy(), np.asarray(want[name])), (
                name, s,
            )


def test_shift_and_window_beyond_length():
    """Shifts and windows longer than the batch give all-zero / all-False."""
    a = torch.arange(6, dtype=torch.int64).reshape(1, 6) + 1
    assert not TX._shift_left_arr(a, 7).any()
    assert TX._shift_left_arr(a, 2).tolist() == [[3, 4, 5, 6, 0, 0]]
    valid = torch.ones((1, 6), dtype=torch.bool)
    assert not TX.window_all(valid, 7).any()
    assert TX.window_all(valid, 3).tolist() == [[True] * 4 + [False] * 2]
