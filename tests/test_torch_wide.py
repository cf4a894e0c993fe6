"""The port's 128-bit key route (k > 31, two int64 limbs) against the
benchmark's plain 128-bit reference, on the CPU:

- skabench/reference/kmers_wide.py at k <= 31 agrees row for row with
  kmers.py, its high limb 0, for assemblies and for reads under the
  quality and count filters;
- `python -m ska_tpu_torch build --device cpu` at k = 33 and 63, both
  strands and --single-strand, on generated FASTA with N runs, IUPAC
  letters and a palindrome, equals build_wide.expected (all four
  numbers 0), its .skf bytes equal `./ska.py build`'s, the benchmark's
  wide reader decodes it as skf.read does, and SKA_DISPATCH_STATS's
  `wide_keys` counts the rows whose high limb is not 0.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from skabench.reference import build_wide, kmers, kmers_wide, skf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _genome(rng, n):
    """n random bases with 8 IUPAC letters and one N run."""
    g = rng.choice(ACGT, size=n)
    g[rng.integers(0, n, 8)] = rng.choice(np.frombuffer(b"RYKMSW", np.uint8), size=8)
    a = int(rng.integers(0, n - 60))
    g[a : a + int(rng.integers(5, 40))] = ord("N")
    return g


def _palindrome(rng, k):
    """k bases whose split k-mer is its own reverse complement."""
    left = rng.choice(ACGT, size=(k - 1) // 2).tobytes()
    return np.frombuffer(left + b"G" + left[::-1].translate(_COMP), np.uint8)


@pytest.mark.parametrize("k", [17, 31])
@pytest.mark.parametrize("kind", ["fasta", "fasta_single_strand", "reads"])
def test_kmers_wide_agrees_with_kmers(k, kind):
    rng = np.random.default_rng(k)
    seqs = [_genome(rng, 4000), _palindrome(rng, k), _genome(rng, 700)]
    if kind == "reads":
        reads = [bytes(seqs[0][i : i + 100]) for i in rng.integers(0, 3900, 600)]
        # 1% of bases under the quality gate
        quals = [np.where(rng.random(100) < 0.01, 33 + 5, 33 + 35)
                 .astype(np.uint8).tobytes() for _ in reads]
        args = dict(quals=quals, min_qual=20, qual_filter="strict", min_count=3)
        want = kmers.sample_dict(reads, k, True, **args)
        got = kmers_wide.sample_dict(reads, k, True, **args)
    else:
        rc = kind == "fasta"
        want = kmers.sample_dict(seqs, k, rc)
        got = kmers_wide.sample_dict(seqs, k, rc)
    assert len(want[0]) > 100
    assert got[0].shape == (len(want[0]), 2)
    assert not got[0][:, 0].any()
    assert np.array_equal(got[0][:, 1], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Three related 3 kb genomes of two records, with SNPs, IUPAC
    letters, an N run, and a palindrome of k = 33 and one of k = 63."""
    d = tmp_path_factory.mktemp("wide")
    rng = np.random.default_rng(63)
    base = _genome(rng, 3000)
    paths = []
    for i in range(3):
        g = base.copy()
        snp = rng.random(len(g)) < 0.02
        g[snp] = rng.choice(ACGT, size=int(snp.sum()))
        g = np.concatenate([g[:900], _palindrome(rng, 33), g[900:1800],
                            _palindrome(rng, 63), g[1800:]])
        p = d / f"g{i}.fa"
        p.write_bytes(b">chrom\n" + g[:2500].tobytes() + b"\n>plasmid\n"
                      + g[2500:].tobytes() + b"\n")
        paths.append(str(p))
    return paths


def _stats(stderr: str) -> dict:
    (line,) = [ln for ln in stderr.splitlines() if ln.startswith("SKA_DISPATCH_STATS ")]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("k", [33, 63])
@pytest.mark.parametrize("strands", ["both", "single"])
def test_cpu_build_matches_wide_reference(cohort, tmp_path, k, strands):
    flag = ["--single-strand"] if strands == "single" else []
    port = tmp_path / "port"
    r = subprocess.run(
        [sys.executable, "-m", "ska_tpu_torch", "build", "-k", str(k), "-o",
         str(port), "--device", "cpu", *flag, *cohort],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, SKA_DISPATCH_STATS="1", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    cfg = {"build": {"k": k, "rc": strands == "both"}}
    samples = [(os.path.basename(p)[:-3], p, None) for p in cohort]
    exp = build_wide.expected(cfg, {"samples": samples})
    exp["names"] = skf.read(str(port) + ".skf")["names"]
    assert build_wide.compare(exp, str(port) + ".skf") == {
        "skf_unreadable": 0, "header_differing": 0, "rows_unsorted": 0,
        "rows_differing": 0}
    assert len(exp["keys"]) > 1000
    # the palindromes carry both middle bases
    assert (exp["variants"] == ord("S")).any() == (strands == "both")
    a, b = skf.read(str(port) + ".skf"), build_wide.read(str(port) + ".skf")
    assert np.array_equal(a["keys"], b["keys"]) and b["k_bits"] == 128
    wide = int(np.count_nonzero(exp["keys"][:, 0]))
    assert (wide > 0) == (k == 63)
    stats = _stats(r.stderr)
    assert stats["save"]["wide_keys"] == wide and stats["save"]["files"] == 1
    assert stats["radix_sorts"] == {}  # the CPU takes the plain sort
    ref = tmp_path / "ref"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "ska.py"), "build", "-k", str(k),
         "-o", str(ref), *flag, *cohort],
        cwd=tmp_path, capture_output=True, timeout=600,
        env=dict(os.environ, **PIN, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert (tmp_path / "port.skf").read_bytes() == (tmp_path / "ref.skf").read_bytes()
