"""The port's `ska build` / `ska align` end to end on the CPU:

- ska_tpu_torch.api.build writes the same .skf bytes as ska_tpu.api.build
  (the JAX pipeline) on a random cohort and on tests/data/bubble_*.fa,
  and in merged batches of 3 and 2 rows under SKA_MAX_BATCH=3;
- an all-N sample in a merged batch raises the JAX package's "has no
  valid sequence" error; the merged build's counters count the batches
  copied out, their rows and the only bytes turned into host arrays;
- `python -m ska_tpu_torch build` then `align --device cpu` in a
  subprocess give the bytes of `./ska.py build` / `align`, and import
  neither jax nor ska_tpu.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_tpu import api as japi
from ska_tpu.io import skf
from ska_tpu.sampletypes import QualOpts
from ska_tpu_torch import api as tapi
from ska_tpu_torch.torchinit import get_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
QUAL = QualOpts(min_count=5, min_qual=20, qual_filter=2)


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


def _random_cohort(tmp_path, seed=0, short=1200):
    """Related genomes of two lengths (two length groups, so batches
    permute the columns; one group when short is 3000) with SNPs, IUPAC
    letters, N runs, 2 records."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(alphabet, size=3000)
    paths = []
    for s in range(5):
        g = base[: 3000 if s % 2 else short].copy()
        snp = rng.random(len(g)) < 0.01
        g[snp] = rng.choice(alphabet, size=int(snp.sum()))
        g[rng.integers(0, len(g), 3)] = ord("R")
        a = int(rng.integers(0, len(g) - 20))
        g[a : a + 15] = ord("N")
        p = tmp_path / f"g{s}.fa"
        p.write_bytes(b">chrom\n" + g[:900].tobytes() + b"\n>plasmid\n"
                      + g[900:].tobytes() + b"\n")
        paths.append(str(p))
    return paths


def _bubbles():
    return sorted(
        os.path.join(DATA, f) for f in os.listdir(DATA)
        if f.startswith("bubble_s") and f.endswith(".fa")
    )


def _input_files(paths):
    return [(os.path.basename(p)[:-3], p, None) for p in paths]


@pytest.mark.parametrize("cohort,k,rc", [
    ("random", 31, True), ("random", 41, False), ("bubbles", 17, True),
])
def test_api_build_skf_bytes_match_jax(tmp_path, cohort, k, rc):
    paths = _random_cohort(tmp_path) if cohort == "random" else _bubbles()
    files = _input_files(paths)
    port = tapi.build(files, k, rc, QUAL, device="cpu")
    ref = japi.build(files, k, rc, QUAL)
    assert port.names == ref.names
    out_p = skf.save(port, str(tmp_path / "port"))
    out_r = skf.save(ref, str(tmp_path / "ref"))
    with open(out_p, "rb") as a, open(out_r, "rb") as b:
        assert a.read() == b.read()


def test_api_build_unpadded_batches_match_jax(tmp_path, monkeypatch):
    """Five samples of one length group under SKA_MAX_BATCH=3: the port
    runs batches of exactly 3 and 2 rows (the JAX package pads the first
    to 4), unions them, and writes the JAX package's .skf bytes."""
    from ska_tpu_torch.ops import pipeline as TP

    merged, rows = TP.merged_build_from_raw, []

    def counted(seqs, *args):
        rows.append(seqs.shape[0])
        return merged(seqs, *args)

    monkeypatch.setattr(TP, "merged_build_from_raw", counted)
    monkeypatch.setenv("SKA_MAX_BATCH", "3")
    files = _input_files(_random_cohort(tmp_path, seed=3, short=3000))
    port = tapi.build(files, 21, True, QUAL, device="cpu")
    ref = japi.build(files, 21, True, QUAL)
    assert rows == [3, 2]
    out_p = skf.save(port, str(tmp_path / "port"))
    out_r = skf.save(ref, str(tmp_path / "ref"))
    with open(out_p, "rb") as a, open(out_r, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("where,k", [(0, 31), (2, 63), ("alone", 31)])
def test_all_n_sample_in_merged_batch_raises(tmp_path, where, k):
    """A merged batch holding an all-N FASTA raises "<path> has no valid
    sequence" naming that input, from the batch's presence vector, with
    the JAX package's message; also where the all-N sample is alone in
    its batch, which then has no rows."""
    paths = _random_cohort(tmp_path, seed=5, short=3000)[:3]
    bad = tmp_path / "alln.fa"
    bad.write_bytes(b">n\n" + b"N" * (200 if where == "alone" else 3000)
                    + b"\n")
    paths.insert(len(paths) if where == "alone" else where, str(bad))
    files = _input_files(paths)
    with pytest.raises(ValueError) as got:
        tapi.build(files, k, True, QUAL, device="cpu")
    with pytest.raises(ValueError) as want:
        japi.build(files, k, True, QUAL)
    assert str(got.value) == str(want.value) == f"{bad} has no valid sequence"


@pytest.mark.parametrize("k,max_batch", [(31, None), (63, "2")])
def test_merged_counters(tmp_path, monkeypatch, k, max_batch):
    """merged_counts() holds the merged batches copied out, their rows
    and the bytes those rows took, n * (8W + S + 8) + S a batch of S
    samples: the bytes of every tensor the build turns into a numpy
    array, so no padded output reaches the host and the host unpacks no
    variants; reset_launch_counts zeroes them."""
    from ska_tpu_torch import sample as tsample
    from ska_tpu_torch import torchinit
    from ska_tpu_torch.ops import pipeline as TP

    sizes = []  # bytes of every tensor turned into a numpy array
    numpy = torch.Tensor.numpy

    def recorded(t, *args, **kwargs):
        sizes.append(t.numel() * t.element_size())
        return numpy(t, *args, **kwargs)

    def unpacked(*args):
        raise AssertionError("the variants were unpacked on the host")

    monkeypatch.setattr(torch.Tensor, "numpy", recorded)
    monkeypatch.setattr(TP, "unpack_variants4", unpacked)
    if max_batch:
        monkeypatch.setenv("SKA_MAX_BATCH", max_batch)
    files = _input_files(_random_cohort(tmp_path, seed=4))
    torchinit.reset_launch_counts()
    batches = tsample.build_samples_merged(files, k, True, QUAL, device="cpu")
    W = 1 if k <= 31 else 2
    # two length groups of 3 and 2 samples; batches of at most 2 split
    # the first
    assert [len(b[0]) for b in batches] == ([3, 2] if max_batch is None
                                           else [2, 1, 2])
    want_bytes = sum(len(b[2]) * (8 * W + len(b[0]) + 8) + len(b[0])
                     for b in batches)
    assert torchinit.merged_counts() == {
        "merged_batches": len(batches),
        "merged_rows": sum(len(b[2]) for b in batches),
        "merged_copy_bytes": want_bytes}
    assert sum(sizes) == want_bytes
    torchinit.reset_launch_counts()
    assert torchinit.merged_counts() == {
        "merged_batches": 0, "merged_rows": 0, "merged_copy_bytes": 0}


def test_load_array_builds_fasta_inputs(tmp_path):
    """`align` given several FASTA files builds them with the defaults."""
    paths = _random_cohort(tmp_path, seed=2)[:3]
    port = tapi.load_array(paths, device="cpu")
    ref = japi.load_array(paths)
    assert port.k == ref.k and port.names == ref.names
    assert np.array_equal(port.keys, ref.keys)
    assert np.array_equal(port.variants, ref.variants)
    assert np.array_equal(port.counts, ref.counts)


def _run(args, cwd, **env):
    r = subprocess.run(args, cwd=cwd, capture_output=True, timeout=600,
                       env=dict(os.environ, **PIN, **env))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r


def test_cli_build_align_match_ska_py_without_jax(tmp_path):
    paths = _random_cohort(tmp_path, seed=1)
    port = [sys.executable, "-X", "importtime", "-m", "ska_tpu_torch"]
    ref = [sys.executable, os.path.join(REPO, "ska.py")]
    r = _run(port + ["build", "-k", "21", "-o", str(tmp_path / "port"),
                     "--device", "cpu", *paths], REPO)
    imported = re.findall(r"\|\s+([\w.]+)\s*$", r.stderr.decode(), re.M)
    assert "ska_tpu_torch.ops.sort" in imported
    r = _run(port + ["align", str(tmp_path / "port.skf"), "-o",
                     str(tmp_path / "port.aln"), "--device", "cpu"], REPO)
    imported += re.findall(r"\|\s+([\w.]+)\s*$", r.stderr.decode(), re.M)
    assert "ska_tpu_torch.io.skf" in imported
    assert not [m for m in imported
                if m in ("jax", "ska_tpu") or m.startswith(("jax.", "ska_tpu."))]
    _run(ref + ["build", "-k", "21", "-o", str(tmp_path / "ref"), *paths],
         tmp_path, JAX_PLATFORMS="cpu")
    _run(ref + ["align", str(tmp_path / "ref.skf"), "-o",
                str(tmp_path / "ref.aln")], tmp_path, JAX_PLATFORMS="cpu")
    for ext in ("skf", "aln"):
        port_bytes = (tmp_path / f"port.{ext}").read_bytes()
        assert port_bytes == (tmp_path / f"ref.{ext}").read_bytes(), ext
    assert port_bytes.count(b">") == 5


def test_build_steps_are_profiler_spans(tmp_path):
    """Each step of a build runs inside a ska:: span, and the command
    inside ska::command, which is how chip_smoke.py's profile phase
    splits the build's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ska_tpu_torch import cli

    paths = _random_cohort(tmp_path, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cli.main(["build", "-k", "17", "-o", str(tmp_path / "p"),
                  "--device", "cpu", *paths])
    # a library built at first use (ska::compile) is no step of the build
    spans = {e.name for e in prof.events()
             if e.name.startswith("ska::")} - {"ska::compile"}
    steps = ("command", "parse", "stage", "to_device", "device_pass",
             "to_host", "union", "save")
    assert spans == {f"ska::{s}" for s in steps}


def test_device_choice(monkeypatch):
    monkeypatch.setenv("SKA_DEVICE", "cpu")
    assert get_device() == torch.device("cpu")
    assert get_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            get_device("cuda")
        monkeypatch.delenv("SKA_DEVICE")
        with pytest.raises(RuntimeError, match="no CUDA"):
            get_device()

