"""The port's `ska distance` on the CPU, against the JAX package.

- distance.class_gram (one int8 route) equals
  ska_tpu.distance.class_gram(on_host=False) as int64 by both of the JAX
  package's routes, its deduplicated weighted f32 one and its int8 one
  (DEDUP_MAX_SITES forced to 0 there), in one chunk and in several
  (GRAM_SCRATCH_BYTES shrunk in both packages), where K == width pads
  with class 0, and with no sites, one site or one sample;
- the chunk Gram, whose one-hot is padded to the sizes torch._int_mm
  takes, equals the unpadded product;
- api.distance_mode writes the TSV of ska_tpu.api.distance_mode with and
  without --min-freq and --allow-ambiguous, and `python -m ska_tpu_torch
  distance --device cpu` prints the stdout of `./ska.py distance`,
  importing neither jax nor ska_tpu.
"""

import importlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_tpu import api as japi
from ska_tpu.io import skf as jskf
from ska_tpu_torch import api as tapi
from ska_tpu_torch import distance as tdist
from ska_tpu_torch.io import skf as tskf

jdist = importlib.import_module("ska_tpu.distance")
jarray = importlib.import_module("ska_tpu.array")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


def _variants(seed, S, n, alphabet=b"ACGT-", ambig=0.0):
    """A related cohort's sites: one majority base per site, ~10% other
    bases, and IUPAC letters at rate `ambig`."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    major = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(S, 1))
    v = np.repeat(major, n, axis=1)
    other = rng.random((S, n)) < 0.1
    v[other] = rng.choice(letters, size=int(other.sum()))
    amb = rng.random((S, n)) < ambig
    v[amb] = rng.choice(np.frombuffer(b"RYKMSWN", np.uint8), size=int(amb.sum()))
    return v


@pytest.mark.parametrize("route", ["weighted", "int8"])
@pytest.mark.parametrize("case", ["one_chunk", "chunks", "pad_class0"])
def test_class_gram_matches_jax(monkeypatch, route, case):
    if case == "pad_class0":
        # K == width == 8 with '-' present: class 0 pads the tail
        v = _variants(3, 2500, 5, alphabet=b"ACGTRY-")
        v[:8, 0] = np.frombuffer(b"ACGTRYK-", np.uint8)
    else:
        v = _variants(1, 3000, 7, ambig=0.01)
    compact, present, K, width, pad = tdist.compact_classes(v)
    if case == "pad_class0":
        assert K == width == 8 and pad == 0
    if route == "int8":
        monkeypatch.setattr(jdist, "DEDUP_MAX_SITES", 0)
    if case == "chunks":
        for mod in (tdist, jdist):
            monkeypatch.setattr(mod, "GRAM_SCRATCH_BYTES", 4096)
    got = tdist.class_gram(v, device="cpu")
    want = jdist.class_gram(v, on_host=False)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    # the diagonal blocks count each sample's classes over all sites
    G = got.reshape(7 if case != "pad_class0" else 5, 16, -1, 16)
    assert G[0, :, 0, :].trace() == len(v)


@pytest.mark.parametrize("n,width", [(1, 4), (3, 4), (5, 8), (2, 16)])
def test_gram_chunk_padding(n, width):
    """The one-hot is padded with zero columns to >= 24 and a multiple of
    8 (torch._int_mm's sizes on a card); the result equals the unpadded
    numpy product."""
    rng = np.random.default_rng(n * width)
    c = rng.integers(0, width, size=(1024, n)).astype(np.int8)
    X = np.zeros((1024, n * width), np.int64)
    X[np.arange(1024)[:, None], np.arange(n) * width + c] = 1
    got = tdist.gram_chunk(torch.from_numpy(c), n, width)
    assert got.dtype == torch.int32 and got.shape == (n * width, n * width)
    assert np.array_equal(got.numpy(), X.T @ X)


@pytest.mark.parametrize("S,n", [(0, 4), (1, 4), (50, 1)])
def test_class_gram_edge_sizes_match_jax(S, n):
    """No sites (an empty Gram), one site (a chunk that is all padding
    but one row) and one sample."""
    v = _variants(5, S, n, alphabet=b"ACGT-")
    got = tdist.class_gram(v, device="cpu")
    assert got.shape == (16 * n, 16 * n)
    assert np.array_equal(got, jdist.class_gram(v, on_host=False))
    assert got.reshape(n, 16, n, 16)[0, :, 0, :].trace() == S


def _skf(tmp_path, seed=4, S=4000, n=6):
    """A .skf of n samples with gaps, IUPAC letters and constant rows."""
    rng = np.random.default_rng(seed)
    v = _variants(seed, S, n, alphabet=b"ACGT--", ambig=0.005)
    v[: S // 10] = v[: S // 10, :1]  # constant rows
    keys = np.unique(rng.integers(0, 1 << 60, size=2 * S, dtype=np.uint64))
    keys = np.sort(rng.choice(keys, S, replace=False))[:, None]
    keep = (v != ord("-")).any(axis=1)
    arr = jarray.SkaArray(
        k=31, rc=True, names=[f"sample_{i}" for i in range(n)], keys=keys[keep],
        variants=v[keep], counts=(v[keep] != ord("-")).sum(axis=1))
    return jskf.save(arr, str(tmp_path / "d"))


@pytest.mark.parametrize("min_freq,allow_ambig", [
    (0.0, False), (0.5, False), (0.0, True), (0.5, True),
])
def test_distance_tsv_matches_jax(tmp_path, min_freq, allow_ambig):
    path = _skf(tmp_path)
    outs = []
    for mod, sk, kw in ((tapi, tskf, {"device": "cpu"}), (japi, jskf, {})):
        fh = io.StringIO()
        mod.distance_mode(sk.load(path), fh, min_freq, not allow_ambig, **kw)
        outs.append(fh.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) == 1 + 6 * 5 // 2


def test_cli_distance_matches_ska_py_without_jax(tmp_path):
    path = _skf(tmp_path, seed=8)
    env = dict(os.environ, **PIN)
    port = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ska_tpu_torch", "distance",
         path, "-m", "0.3", "--device", "cpu"],
        cwd=REPO, capture_output=True, timeout=600, env=env)
    assert port.returncode == 0, port.stderr.decode()[-2000:]
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "ska.py"), "distance", path, "-m",
         "0.3", "-o", str(tmp_path / "ref.tsv")],
        cwd=tmp_path, capture_output=True, timeout=600,
        env=dict(env, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr.decode()[-2000:]
    assert port.stdout == (tmp_path / "ref.tsv").read_bytes()
    assert port.stdout.startswith(b"Sample1\tSample2\tDistance\t")
    imported = re.findall(r"\|\s+([\w.]+)\s*$", port.stderr.decode(), re.M)
    assert "ska_tpu_torch.distance" in imported
    assert not [m for m in imported if m in ("jax", "ska_tpu")
                or m.startswith(("jax.", "ska_tpu."))]
