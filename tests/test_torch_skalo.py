"""The port's `ska lo` on the CPU, against the JAX package's C++ route.

Each input is built once with ska_tpu.api.build (the JAX pipeline), and
the same SkaArray goes to ska_tpu.skalo.run_skalo (SKA_SKALO_CORE=native:
the JAX package's pure-Python graph is never the oracle, it costs a
minute a case) and to ska_tpu_torch.skalo.run_skalo. All four output
files must be byte-equal, and a file absent on one side absent on the
other:

- k = 31, 41 and 63, with a single-record reference and without;
- k=7 with dense SNPs (the entry-is-exit wrap of read_graph.rs:205);
- 66 samples (two sample-mask limbs);
- planted 1-10 bp indels (a non-empty _indels.vcf, the path filter at
  work), with the default -m/-d/-n and with other values;
- SKA_THREADS 1 and 4 in the port, and a reference shorter than k;
- the "no entry node" and the two-record reference exits, with equal
  messages;
- `python -m ska_tpu_torch lo --device cpu` against `./ska.py lo`, and
  the port CLI's clean MemoryError on a bubble explosion.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ska_tpu import api as japi
from ska_tpu.io import skf as jskf
from ska_tpu.sampletypes import QualOpts
from ska_tpu.skalo import SkaloConfig as JConfig
from ska_tpu.skalo import run_skalo as jrun
from ska_tpu_torch.skalo import SkaloConfig as TConfig
from ska_tpu_torch.skalo import run_skalo as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0",
       "SKA_DISTRIBUTED": "0", "SKA_SKALO_CORE": "native"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
SUFFIXES = ("_snps.fas", "_snps.vcf", "_indels.vcf", "_pseudo_genomes.fas")


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)
    monkeypatch.delenv("SKA_THREADS", raising=False)


def _write(path, name, seq):
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n" + seq.tobytes() + b"\n")


def _snp(rng, g, n):
    pos = rng.choice(len(g), size=n, replace=False)
    g[pos] = ACGT[(np.searchsorted(ACGT, g[pos]) + rng.integers(1, 4, n)) % 4]


def _cohort(d, n_samples, L, n_snps, seed, n_indels=0):
    """A random reference and n_samples copies with n_snps SNPs each and,
    with n_indels, 1-10 bp insertions and deletions 400 bases apart, each
    carried by sample 0, not by the last sample and by about half of the
    others. Returns (reference path, [(name, path, None)])."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(ACGT, size=L)
    ref_f = os.path.join(d, "ref.fa")
    _write(ref_f, b"ref", ref)
    sites = np.sort(rng.choice(np.arange(200, L - 200, 400), n_indels,
                               replace=False))
    edits = []
    for p in sites:
        carriers = rng.random(n_samples) < 0.5
        carriers[0], carriers[-1] = True, False
        edits.append((int(p), int(rng.integers(1, 11)), rng.random() < 0.5,
                      carriers))
    files = []
    for s in range(n_samples):
        g = ref.copy()
        _snp(rng, g, n_snps)
        for p, n, is_del, carriers in edits[::-1]:
            if carriers[s]:
                g = (np.delete(g, np.arange(p, p + n)) if is_del
                     else np.insert(g, p, rng.choice(ACGT, size=n)))
        path = os.path.join(d, f"s{s}.fa")
        _write(path, b"s%d" % s, g)
        files.append((f"s{s}", path, None))
    return ref_f, files


def _build(files, k):
    return japi.build(files, k, True, QualOpts())


def _outputs(prefix):
    out = {}
    for suffix in SUFFIXES:
        p = prefix + suffix
        out[suffix] = open(p, "rb").read() if os.path.exists(p) else None
    return out


def _both(arr, d, tag, **cfg):
    """run_skalo of both packages on arr; returns the port's outputs
    after checking them against the JAX package's."""
    jrun(arr, JConfig(output_name=os.path.join(d, f"{tag}_jax"), **cfg))
    trun(arr, TConfig(output_name=os.path.join(d, f"{tag}_port"), **cfg))
    want = _outputs(os.path.join(d, f"{tag}_jax"))
    got = _outputs(os.path.join(d, f"{tag}_port"))
    assert got == want
    assert got["_snps.fas"] is not None
    return got


@pytest.fixture(scope="module")
def snp_cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("snps"))
    ref_f, files = _cohort(d, 4, 20000, 20, seed=9)
    return d, ref_f, {k: _build(files, k) for k in (31, 41, 63)}


@pytest.fixture(scope="module")
def indel_cohort(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("indels"))
    ref_f, files = _cohort(d, 4, 8000, 8, seed=5, n_indels=8)
    return d, ref_f, {k: _build(files, k) for k in (31, 41)}


@pytest.mark.parametrize("with_ref", [True, False])
@pytest.mark.parametrize("k", [31, 41, 63])
def test_lo_matches_jax(snp_cohort, k, with_ref):
    d, ref_f, arrays = snp_cohort
    got = _both(arrays[k], d, f"k{k}{with_ref}",
                reference_genome=ref_f if with_ref else None)
    assert (got["_snps.vcf"] is not None) == with_ref
    assert (got["_pseudo_genomes.fas"] is not None) == with_ref
    assert got["_snps.fas"].count(b"\n") == 8


def test_lo_small_k_dense_snps_matches_jax(tmp_path):
    _, files = _cohort(str(tmp_path), 3, 200, 30, seed=14)
    _both(_build(files, 7), str(tmp_path), "k7")


def test_lo_two_mask_limbs_matches_jax(tmp_path):
    ref_f, files = _cohort(str(tmp_path), 66, 800, 6, seed=3)
    got = _both(_build(files, 31), str(tmp_path), "s66", reference_genome=ref_f)
    assert got["_snps.fas"].count(b">") == 66


@pytest.mark.parametrize("k,cfg", [
    (31, {}),
    (41, {"max_missing": 0.5, "max_depth": 2, "max_indel_kmers": 0}),
])
def test_lo_indels_match_jax(indel_cohort, k, cfg):
    d, ref_f, arrays = indel_cohort
    got = _both(arrays[k], d, f"indel{k}", reference_genome=ref_f, **cfg)
    records = [ln for ln in got["_indels.vcf"].split(b"\n")
               if ln and not ln.startswith(b"#")]
    assert records, "no indel called"
    assert all(b"before=" in r for r in records)


def test_lo_thread_count_keeps_bytes(indel_cohort, monkeypatch):
    d, ref_f, arrays = indel_cohort
    outs = []
    for nt in ("1", "4"):
        monkeypatch.setenv("SKA_THREADS", nt)
        prefix = os.path.join(d, f"threads{nt}")
        trun(arrays[31], TConfig(output_name=prefix, reference_genome=ref_f))
        outs.append(_outputs(prefix))
    assert outs[0] == outs[1]
    jrun(arrays[31], JConfig(output_name=os.path.join(d, "threads_jax"),
                             reference_genome=ref_f))
    assert outs[0] == _outputs(os.path.join(d, "threads_jax"))


def test_lo_reference_shorter_than_k_matches_jax(tmp_path):
    """No window of the reference, so no group finds a position (the
    JAX package runs its Python SNP loop here, the port its C++ stage
    on an empty map)."""
    d = str(tmp_path)
    _, files = _cohort(d, 3, 2000, 10, seed=2)
    short = os.path.join(d, "short.fa")
    _write(short, b"short", ACGT[np.arange(20) % 4])
    got = _both(_build(files, 31), d, "short", reference_genome=short)
    assert got["_snps.vcf"].count(b"\n") == 2  # the header alone


def _exit_message(run, arr, cfg):
    with pytest.raises(SystemExit) as e:
        run(arr, cfg)
    return str(e.value.code)


def test_lo_exits_match_jax(snp_cohort, tmp_path):
    d, ref_f, arrays = snp_cohort
    # one sample: no bubble, so no entry node
    _, files = _cohort(str(tmp_path), 1, 2000, 0, seed=1)
    one = _build(files, 31)
    msgs = [_exit_message(run, one, C(output_name=str(tmp_path / "one")))
            for run, C in ((jrun, JConfig), (trun, TConfig))]
    assert msgs[0] == msgs[1]
    assert "no entry node" in msgs[0]
    two = str(tmp_path / "two.fa")
    with open(ref_f, "rb") as f:
        seq = f.read()
    with open(two, "wb") as f:
        f.write(seq + b">plasmid\nACGTACGT\n")
    msgs = [_exit_message(run, arrays[31], C(output_name=str(tmp_path / "two"),
                                              reference_genome=two))
            for run, C in ((jrun, JConfig), (trun, TConfig))]
    assert msgs[0] == msgs[1]
    assert "more than one sequence" in msgs[0]


def test_cli_lo_matches_ska_py(snp_cohort, tmp_path):
    d, ref_f, arrays = snp_cohort
    skf = jskf.save(arrays[31], str(tmp_path / "x"))
    env = dict(os.environ, **PIN, JAX_PLATFORMS="cpu")
    for prefix, cmd in (
        ("port", [sys.executable, "-m", "ska_tpu_torch"]),
        ("ref", [sys.executable, os.path.join(REPO, "ska.py")]),
    ):
        r = subprocess.run(
            cmd + ["lo", skf, str(tmp_path / prefix), "-r", ref_f, "-v"]
            + (["--device", "cpu"] if prefix == "port" else []),
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    got = _outputs(str(tmp_path / "port"))
    assert got == _outputs(str(tmp_path / "ref"))
    assert all(v is not None for v in got.values())


def test_cli_lo_bubble_explosion_clean_memoryerror(tmp_path):
    """A repeat-dense graph (66 samples, k=7, depth 6) grows kept paths
    combinatorially; under a limit of 1 GiB above what the process holds
    once torch and the host library are loaded, the port's CLI reports
    the core's guidance and exits 1."""
    samples = sorted(os.path.join(REPO, "tests", "data", f)
                     for f in os.listdir(os.path.join(REPO, "tests", "data"))
                     if f.startswith("bubble_s") and f.endswith(".fa"))
    assert len(samples) == 66
    files = [(os.path.basename(p)[:-3], p, None) for p in samples]
    skf = jskf.save(_build(files, 7), str(tmp_path / "bub"))
    child = (
        "import resource, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from ska_tpu_torch import cli, kernels\n"
        "from ska_tpu_torch.skalo import core\n"
        "import ska_tpu_torch.api, torch.profiler\n"
        "kernels.build_host(); core._lib()\n"
        "vm = [int(l.split()[1]) for l in open('/proc/self/status')\n"
        "      if l.startswith('VmSize:')][0] * 1024\n"
        "resource.setrlimit(resource.RLIMIT_AS, (vm + (1 << 30),) * 2)\n"
        f"cli.main(['lo', {skf!r}, {str(tmp_path / 'bubout')!r}, '-d', '6',\n"
        "          '--device', 'cpu'])\n"
    )
    r = subprocess.run([sys.executable, "-c", child], cwd=REPO,
                       env=dict(os.environ, **PIN), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 1, (r.returncode, r.stderr[-500:])
    assert "Error: ska lo: graph traversal exceeded available memory" in r.stderr
