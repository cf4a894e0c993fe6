"""ska_tpu_torch.ops.pipeline.merged_build_from_raw, on the JAX
package's raw staging (ska_tpu.sample._stage_raw) of a batch, against
the JAX merged_build_from_packed on its packed staging
(ska_tpu.sample._stage_packed) of the same batch: ukeys[:n],
variants4[:n], counts[:n] and n_rows exactly, for S in {1, 2, 5}, k in
{9, 31, 33, 63}, rc on and off; and merged_to_host, the batch's copy-out,
against the host unpack, count and presence scan of the same outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu.io import fastx
from ska_tpu.ops import pipeline as JP
from ska_tpu.ops.npkeys import width_for_k
from ska_tpu.sample import _bucket, _stage_packed, _stage_raw
from ska_tpu_torch.ops import pipeline as TP
from ska_tpu_torch.ops.keys import to_numpy_keys

ALPHABET = np.frombuffer(b"ACGTNRYK", np.uint8)
P = [0.24, 0.24, 0.24, 0.24, 0.01, 0.01, 0.01, 0.01]


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var in ("SKA_NATIVE_BUILD", "SKA_NATIVE_CMDS", "SKA_DISTRIBUTED"):
        monkeypatch.setenv(var, "0")


def _cohort(S, k, seed):
    """S related samples: one random base sequence with per-sample SNPs,
    N runs and a second record, so rows are shared across samples."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ALPHABET[:4], size=900)
    batches = []
    for _ in range(S):
        g = base.copy()
        snp = rng.random(len(g)) < 0.02
        g[snp] = rng.choice(ALPHABET, size=int(snp.sum()), p=P)
        a = int(rng.integers(0, len(g) - 10))
        g[a : a + int(rng.integers(1, 8))] = ord("N")
        cut = int(rng.integers(k + 5, 600))
        recs = [g[:cut].tobytes(), g[cut:].tobytes()]
        batches.append(fastx.build_batch(recs, [None, None]))
    return batches


@pytest.mark.parametrize(
    "S,k,rc",
    [
        (1, 9, True), (2, 31, True), (5, 33, True), (2, 63, False),
        (5, 9, False), (1, 63, True), (2, 33, False), (5, 31, False),
    ],
)
def test_merged_build_from_raw_matches_jax(S, k, rc):
    W = width_for_k(k)
    batches = _cohort(S, k, seed=S * 100 + k)
    Lp = _bucket(max(len(b.seq) for b in batches) + k + 1)
    packed = _stage_packed(batches, Lp, 0)
    seqs, qb, re_, has_qual = _stage_raw(batches, Lp, 0)
    args = (k, rc, W, False, False, 1, False, has_qual)
    want = JP.merged_build_from_packed(*(jnp.asarray(x) for x in packed[:4]),
                                       *args)
    got = TP.merged_build_from_raw(
        torch.from_numpy(seqs), torch.from_numpy(qb), torch.from_numpy(re_),
        *args,
    )
    n = int(np.asarray(want[3]))
    assert n > 0 and int(got[3]) == n
    assert np.array_equal(to_numpy_keys(got[0][:n]), np.asarray(want[0])[:n])
    assert np.array_equal(got[1][:n].numpy(), np.asarray(want[1])[:n])
    assert np.array_equal(got[2][:n].numpy(), np.asarray(want[2])[:n])
    # samples share rows, and some rows miss some samples
    if S > 1:
        counts = got[2][:n].numpy()
        assert counts.max() == S and counts.min() < S


def test_fastq_and_oversized_batches_raise():
    """A reads batch builds (an empty one to no rows); an oversized
    batch raises."""
    seqs = torch.zeros((1, 1024), dtype=torch.uint8)
    bits = torch.zeros((1, 128), dtype=torch.uint8)
    ends = torch.full((1, 16), 1024, dtype=torch.int32)
    out = TP.merged_build_from_raw(seqs, bits, ends, 9, True, 1, True, True,
                                   3, True, True)
    assert int(out[3]) == 0
    big = torch.zeros((1 << 11, 1 << 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="SKA_MAX_BATCH"):
        TP._merged_impl(big, big.bool(), big.bool(), big.bool(), 9, True, 1,
                        False, False, 1)


def test_unpack_variants4_matches_jax():
    rng = np.random.default_rng(0)
    vp = rng.integers(0, 256, size=(50, 3), dtype=np.uint8)
    for n_cols in (5, 6):
        assert np.array_equal(
            TP.unpack_variants4(vp, n_cols), JP.unpack_variants4(vp, n_cols)
        )


@pytest.mark.parametrize(
    "S,k,empty",
    [(S, k, False) for S in (1, 2, 5, 16, 21) for k in (31, 63)]
    + [(3, 31, True)],
)
def test_merged_to_host_matches_host_unpack(S, k, empty):
    """merged_to_host's keys, ASCII matrix, int64 counts and presence
    equal to_numpy_keys + unpack_variants4 + the count and the presence
    scan of that matrix on the host, on the same merged_build_from_raw
    outputs; a batch of all-N samples has no rows and no sample
    present."""
    W = width_for_k(k)
    batches = _cohort(S, k, seed=S * 1000 + k)
    if empty:
        batches = [fastx.build_batch([b"N" * 300], [None]) for _ in range(S)]
    Lp = _bucket(max(len(b.seq) for b in batches) + k + 1)
    seqs, qb, re_, has_qual = _stage_raw(batches, Lp, 0)
    ukeys, v4, counts, n_rows = TP.merged_build_from_raw(
        torch.from_numpy(seqs), torch.from_numpy(qb), torch.from_numpy(re_),
        k, True, W, False, False, 1, False, has_qual,
    )
    n = int(n_rows)
    assert (n == 0) == empty
    keys, var, cnt, present, nbytes = TP.merged_to_host(ukeys, v4, counts, n,
                                                        S)
    want_var = TP.unpack_variants4(v4[:n].numpy(), S)
    assert np.array_equal(keys, to_numpy_keys(ukeys[:n]))
    assert keys.dtype == np.uint64 and keys.shape == (n, W)
    assert var.dtype == np.uint8 and var.flags["C_CONTIGUOUS"]
    assert np.array_equal(var, want_var)
    assert cnt.dtype == np.int64
    assert np.array_equal(cnt, (want_var != ord("-")).sum(axis=1))
    assert present.dtype == bool
    assert np.array_equal(present, (want_var != ord("-")).any(axis=0))
    assert present.all() != empty
    assert nbytes == n * (8 * W + S + 8) + S
