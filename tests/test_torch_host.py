"""The port's own host code against the JAX package's, on the CPU.

ska_tpu_torch keeps copies of the host code that `build`, `load` and
`align` call (the .skf codec, the batch union, the site filters, built
from its own C++ host library), and imports nothing of ska_tpu:

- io.skf.save writes the bytes of ska_tpu.io.skf.save, and io.skf.load
  reads them back, at W=1 and W=2 (u128 keys) with 1 and 5 samples;
  with 21 samples over many framing chunks, and empty, at SKA_THREADS
  1, 2 and 8; and from two threads at once;
- merge.extend_arrays equals ska_tpu.merge.extend_arrays;
- api.align writes the bytes of ska_tpu.api.align for every filter;
- kernels.build_host rebuilds the library when a header is newer;
- no module of the port, and no line of chip_smoke.py, imports ska_tpu,
  jax or __graft_entry__.
"""

import ast
import ctypes
import io
import os
import shutil
import sys
import threading

import numpy as np
import pytest

from ska_tpu import api as japi
from ska_tpu import array as jarray
from ska_tpu import merge as jmerge
from ska_tpu.io import skf as jskf
from ska_tpu_torch import api as tapi
from ska_tpu_torch import kernels
from ska_tpu_torch import array as tarray
from ska_tpu_torch import merge as tmerge
from ska_tpu_torch.io import skf as tskf
from ska_tpu_torch.io import snappy as tsnappy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGTACGTACGTRYKMSWN--------", np.uint8)


def _keys(rng, n, W):
    """n sorted unique (n, W) uint64 keys; at W=2 about half have a zero
    hi limb (plain CBOR uints) and the rest are bignums."""
    cols = [rng.integers(0, 1 << 63, size=n * 2, dtype=np.uint64)
            * np.uint64(2) + np.uint64(1) for _ in range(W)]
    keys = np.stack(cols, axis=-1)
    if W == 2:
        keys[rng.random(len(keys)) < 0.5, 0] = 0
    keys = np.unique(keys, axis=0)
    return keys[np.sort(rng.choice(len(keys), n, replace=False))]


def _arrays(seed, n, W, S):
    """The same random array as a port and as a JAX SkaArray."""
    rng = np.random.default_rng(seed)
    keys = _keys(rng, n, W)
    variants = rng.choice(BASES, size=(len(keys), S))
    variants[np.arange(len(keys)), rng.integers(0, S, len(keys))] = ord("A")
    counts = (variants != ord("-")).sum(axis=1).astype(np.int64)
    names = [f"sample_{i}" for i in range(S)]
    k = 31 if W == 1 else 63
    args = dict(k=k, rc=True, names=names, keys=keys, variants=variants,
                counts=counts)
    return tarray.SkaArray(**args), jarray.SkaArray(**args)


@pytest.mark.parametrize("W,S", [(1, 1), (1, 5), (2, 1), (2, 5)])
def test_skf_save_bytes_match_jax(tmp_path, W, S):
    port, ref = _arrays(W * 10 + S, 3000, W, S)
    a = tskf.save(port, str(tmp_path / "port"))
    b = jskf.save(ref, str(tmp_path / "ref"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("threads", ["1", "2", "8"])
@pytest.mark.parametrize("W,n", [(1, 60000), (2, 60000), (1, 0), (2, 0)])
def test_skf_save_many_chunks_match_jax(tmp_path, monkeypatch, W, n, threads):
    """The writer encodes and compresses on SKA_THREADS threads and
    writes the JAX package's serial bytes at any count: 60,000 rows of
    21 samples fill ~50 framing chunks, the last one partial, and an
    empty array one."""
    monkeypatch.setenv("SKA_THREADS", threads)
    port, ref = _arrays(W * 100 + n % 7, n, W, 21)
    a = tskf.save(port, str(tmp_path / "port"))
    b = jskf.save(ref, str(tmp_path / "ref"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got = fa.read()
        assert got == fb.read()
    cbor_len = len(tsnappy.frame_decompress(got))
    if n:
        assert cbor_len > 40 * 65536 and cbor_len % 65536
    else:
        assert cbor_len < 65536


def test_skf_saves_in_two_threads_at_once(tmp_path, monkeypatch):
    """Two Python threads save different arrays at once, each on a pool
    of its own (ctypes drops the GIL), four times each: every file holds
    the JAX package's bytes of its array, and the writer's file counter
    loses no update."""
    monkeypatch.setenv("SKA_THREADS", "4")
    pairs = [_arrays(200 + W, 20000, W, 21) for W in (1, 2)]
    want = []
    for t, (_, ref) in enumerate(pairs):
        with open(jskf.save(ref, str(tmp_path / f"ref{t}")), "rb") as f:
            want.append(f.read())
    reps = 4
    errors = []

    def saver(t):
        try:
            for r in range(reps):
                path = tskf.save(pairs[t][0], str(tmp_path / f"port{t}_{r}"))
                with open(path, "rb") as f:
                    if f.read() != want[t]:
                        errors.append(f"thread {t}, save {r}: bytes differ")
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(repr(e))

    files_before = tskf.saved_files
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saver, args=(t,)) for t in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert tskf.saved_files - files_before == 2 * reps


@pytest.mark.parametrize("W,S", [(1, 1), (1, 5), (2, 1), (2, 5)])
def test_skf_load_round_trips(tmp_path, W, S):
    port, _ = _arrays(W * 20 + S, 2000, W, S)
    path = tskf.save(port, str(tmp_path / "a"))
    got = tskf.load(path)
    want = jskf.load(path)
    for arr in (got, want):
        assert (arr.k, arr.rc, arr.names) == (port.k, port.rc, port.names)
        assert np.array_equal(arr.keys, port.keys)
        assert np.array_equal(arr.variants, port.variants)
        assert np.array_equal(arr.counts.astype(np.int64), port.counts)
    assert got.ska_version == want.ska_version == "0.5.2"
    assert got.kbits == 64 * W


@pytest.mark.parametrize("W", [1, 2])
def test_extend_arrays_matches_jax(W):
    pairs = [_arrays(100 + W * 10 + b, 800 + 300 * b, W, 1 + b)
             for b in range(3)]
    # an unsorted input takes the per-array sort first
    port2, ref2 = pairs[2]
    perm = np.random.default_rng(W).permutation(port2.ksize)
    for arr in (port2, ref2):
        arr._take_rows(perm)
    got = tmerge.extend_arrays([p for p, _ in pairs])
    want = jmerge.extend_arrays([r for _, r in pairs])
    assert got.names == want.names
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.variants, want.variants)
    assert np.array_equal(got.counts, want.counts)


@pytest.mark.parametrize("filter_type,ambig_mask,const_gaps,ambig_missing", [
    ("no-filter", False, False, False),
    ("no-const", False, False, False),
    ("no-const", True, True, False),
    ("no-ambig", False, False, True),
    ("no-ambig-or-const", False, False, False),
    ("no-ambig-or-const", True, True, True),
])
def test_align_bytes_match_jax(filter_type, ambig_mask, const_gaps,
                               ambig_missing):
    port, ref = _arrays(7, 4000, 1, 6)
    out = []
    for mod, arr in ((tapi, port), (japi, ref)):
        fh = io.BytesIO()
        mod.align(arr, fh, filter_type=filter_type, ambig_mask=ambig_mask,
                  ignore_const_gaps=const_gaps, min_freq=0.5,
                  filter_ambig_as_missing=ambig_missing)
        out.append(fh.getvalue())
    assert out[0] == out[1]
    assert out[0].count(b">") == 6


def test_build_host_rebuilds_when_a_header_changes(tmp_path, monkeypatch):
    """A header in csrc/host counts among the files that decide a
    rebuild, though g++ is given the .cpp files alone."""
    src = tmp_path / "src"
    src.mkdir()
    header = src / "pool.h"
    header.write_text("#pragma once\ninline int ska_one() { return 1; }\n")
    (src / "a.cpp").write_text(
        '#include "pool.h"\nextern "C" int ska_probe() { return ska_one(); }\n')
    monkeypatch.setattr(kernels, "HOST_SRC_DIR", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))

    def probe(so, tag):
        # a copy under a new name: dlopen hands back a loaded path as is
        copy = str(tmp_path / f"lib{tag}.so")
        shutil.copy(so, copy)
        return ctypes.CDLL(copy).ska_probe()

    so = kernels.build_host()
    assert probe(so, "first") == 1
    built = os.path.getmtime(so)
    assert kernels.build_host() == so and os.path.getmtime(so) == built
    header.write_text("#pragma once\ninline int ska_one() { return 2; }\n")
    os.utime(header, (built + 10, built + 10))
    assert kernels.build_host() == so and os.path.getmtime(so) > built
    assert probe(so, "second") == 2


def _port_sources():
    root = os.path.join(REPO, "ska_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_ska_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names
                    if n in ("ska_tpu", "jax", "__graft_entry__")
                    or n.startswith(("ska_tpu.", "jax."))]
    assert not bad, bad
