"""The port's `ska cov` and `build --min-count auto` on the CPU, against
the JAX package's device path (SKA_NATIVE_BUILD=0: its native counting
branch is not ported).

- CoverageHistogram's counts, fitted cutoff and table equal
  ska_tpu.coverage's, in one dispatch and chunked over
  SKA_MAX_CHUNK_BASES;
- `python -m ska_tpu_torch cov` prints the stdout of `./ska.py cov`, and
  `build --min-count auto` writes its .skf bytes and stdout, in
  subprocesses that import neither jax nor ska_tpu.
"""

import argparse
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from ska_tpu import coverage as jcov
from ska_tpu_torch import cli as tcli
from ska_tpu_torch import coverage as tcov
from test_torch_fastq import PIN, _genome, _read_pairs, _write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


def _pair(tmp_path, seed, glen=3000, depth=40, tag="x"):
    """A FASTQ pair of one genome at `depth`x, 2 x 100 bp reads."""
    rng = np.random.default_rng(seed)
    fwd, rev = _read_pairs(rng, _genome(rng, glen), glen * depth // 200, 100,
                           repeat=0)
    return (_write_fastq(tmp_path / f"{tag}_1.fastq", fwd),
            _write_fastq(tmp_path / f"{tag}_2.fastq", rev))


def _table(cov):
    out = io.StringIO()
    cov.plot_hist(out)
    return out.getvalue()


@pytest.mark.parametrize("k,rc,cap", [
    (17, True, None), (41, True, None), (31, False, None),
    (17, True, 16384), (41, True, 16384),
])
def test_coverage_histogram_matches_jax(tmp_path, monkeypatch, k, rc, cap):
    fwd, rev = _pair(tmp_path, seed=k)
    if cap:
        monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    port = tcov.CoverageHistogram(fwd, rev, k, rc, device="cpu")
    ref = jcov.CoverageHistogram(fwd, rev, k, rc)
    assert port.counts.dtype == np.int64
    assert np.array_equal(port.counts, np.asarray(ref.counts))
    if cap:
        monkeypatch.delenv("SKA_MAX_CHUNK_BASES")
        whole = tcov.CoverageHistogram(fwd, rev, k, rc, device="cpu")
        assert np.array_equal(port.counts, whole.counts)
    assert port.fit_histogram() == ref.fit_histogram() > 1
    assert _table(port) == _table(ref)


def test_fit_histogram_unit():
    """coverage.rs:365-413's hardcoded histogram fits to cutoff 9, and
    the table equals the JAX package's."""
    example = [
        44633459, 950672, 104410, 44137, 24170, 21232, 21699, 24145, 30696,
        39210, 49878, 63683, 77690, 95147, 112416, 130307, 146531, 160932,
        175130, 185113, 193149, 197468, 199189, 198235, 192150, 185565,
        176362, 165455, 152487, 139495, 127036, 112803, 103080, 90425, 80637,
        70960, 62698, 54949, 46744, 41240, 35591, 30025, 25856, 22105, 19405,
        16668, 14780, 12620, 11074, 9807, 8517, 7731, 7112, 6846, 6126, 5696,
        5233, 4779, 4288, 3873, 3519, 3406, 2994, 2859, 2650, 2394, 2376,
        2260, 2233, 2050, 1859, 1863, 1792, 1777, 1773, 1738, 1648,
    ]
    tables = []
    for mod in (tcov, jcov):
        cov = mod.CoverageHistogram.__new__(mod.CoverageHistogram)
        cov.counts = np.array(example, dtype=np.int64)
        cov.w0, cov.c, cov.cutoff, cov.fitted = mod.INIT_W0, mod.INIT_C, 0, False
        assert cov.fit_histogram() == 9
        tables.append(_table(cov))
    assert tables[0] == tables[1]
    assert tables[0].splitlines()[1].startswith("1\t44633459\t")


def test_coverage_refuses_fasta(tmp_path):
    fa = tmp_path / "a.fa"
    fa.write_bytes(b">a\nACGTACGTAC\n")
    with pytest.raises(ValueError, match="FASTA"):
        tcov.CoverageHistogram(str(fa), str(fa), 9, True, device="cpu")


def test_min_count_auto_needs_two_fastq_samples(tmp_path):
    """With fewer than two paired samples, auto falls back to 5."""
    fwd, rev = _pair(tmp_path, seed=3, glen=500, depth=5)
    args = argparse.Namespace(min_count="auto", k=17, verbose=False)
    files = [("a", fwd, rev), ("b", fwd, None)]
    assert tcli._resolve_min_count(args, files, True, "cpu") == 5
    args.min_count = None
    assert tcli._resolve_min_count(args, files, True, "cpu") == 5


def _run(args, cwd, **env):
    r = subprocess.run(args, cwd=cwd, capture_output=True, timeout=600,
                       env=dict(os.environ, **PIN, **env))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r


def _imports(r):
    return re.findall(r"\|\s+([\w.]+)\s*$", r.stderr.decode(), re.M)


def _no_jax(imported):
    return not [m for m in imported if m in ("jax", "ska_tpu")
                or m.startswith(("jax.", "ska_tpu."))]


PORT = [sys.executable, "-X", "importtime", "-m", "ska_tpu_torch"]
REF = [sys.executable, os.path.join(REPO, "ska.py")]


def test_cli_cov_matches_ska_py_without_jax(tmp_path):
    fwd, rev = _pair(tmp_path, seed=5)
    port = _run(PORT + ["cov", fwd, rev, "-k", "21", "--device", "cpu"], REPO)
    ref = _run(REF + ["cov", fwd, rev, "-k", "21"], tmp_path,
               JAX_PLATFORMS="cpu")
    assert port.stdout == ref.stdout
    assert port.stdout.startswith(b"Count\tK_mers\tMixture_density\tComponent\n")
    cutoff = re.findall(rb"Estimated cutoff\t(\d+)", port.stderr)
    assert cutoff == re.findall(rb"Estimated cutoff\t(\d+)", ref.stderr)
    assert len(cutoff) == 1
    imported = _imports(port)
    assert "ska_tpu_torch.coverage" in imported and _no_jax(imported)


def test_cli_build_min_count_auto_matches_ska_py_without_jax(tmp_path):
    lines = []
    for s in range(3):
        fwd, rev = _pair(tmp_path, seed=10 + s, glen=2000, depth=30,
                         tag=f"s{s}")
        lines.append(f"s{s}\t{fwd}\t{rev}\n")
    tsv = tmp_path / "samples.tsv"
    tsv.write_text("".join(lines))
    common = ["build", "-f", str(tsv), "-k", "31", "--min-count", "auto"]
    port = _run(PORT + common + ["-o", str(tmp_path / "port"), "--device",
                                 "cpu"], REPO)
    ref = _run(REF + common + ["-o", str(tmp_path / "ref")], tmp_path,
               JAX_PLATFORMS="cpu")
    assert port.stdout == ref.stdout
    assert port.stdout.startswith(b"Count\tK_mers\t")
    assert ((tmp_path / "port.skf").read_bytes()
            == (tmp_path / "ref.skf").read_bytes())
    imported = _imports(port)
    assert "ska_tpu_torch.coverage" in imported and _no_jax(imported)
