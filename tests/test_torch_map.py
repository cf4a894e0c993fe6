"""The port's `ska map` and `ska weed` on the CPU, against the JAX package.

- ops.keys.searchsorted_via_sort equals ska_tpu.ops.keys.searchsorted_via_sort
  and np.searchsorted (side="left") at W=1 and W=2, with duplicates, an
  empty table, no queries, more queries than keys and the other way
  round; the port's binary search, ops.keys.searchsorted, too;
- ref.RefSka lists the JAX RefSka's kmers, pos, chrom, krc and
  repeat_coors on a multi-record reference (an empty record, one shorter
  than k, an N run, IUPAC letters, repeats) at k=17 and k=41, on one
  strand and both, whole and sliced by SKA_MAX_CHUNK_BASES;
- api.map_mode writes the aln and VCF bytes of ska_tpu.api.map_mode with
  and without the ambiguity and repeat masks, for a .skf whose keys are
  not sorted, and raises the same error for an all-weeded .skf;
- api.weed_mode writes the .skf bytes of ska_tpu.api.weed_mode;
- `python -m ska_tpu_torch map|weed --device cpu` write the bytes of
  `./ska.py map|weed`, importing neither jax nor ska_tpu.
"""

import importlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu import api as japi
from ska_tpu.io import skf as jskf
from ska_tpu.ops import keys as JK
from ska_tpu.sampletypes import QualOpts
from ska_tpu_torch import api as tapi
from ska_tpu_torch.io import skf as tskf
from ska_tpu_torch.ops import keys as TK
from ska_tpu_torch.ops import sort as SO
from ska_tpu_torch.ref import RefSka as TRefSka

jref = importlib.import_module("ska_tpu.ref")
jarray = importlib.import_module("ska_tpu.array")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)
    monkeypatch.delenv("SKA_THREADS", raising=False)
    monkeypatch.delenv("SKA_MAX_CHUNK_BASES", raising=False)


# ------------------------------------------------------------ lookups


def _lookup_case(W, N, M, seed):
    """A sorted (N, W) table with repeated keys and the all-ones key, and
    M queries, most of them from the table, some all-ones."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64 - 1, size=(max(N, 8) // 2 + 8, W),
                        dtype=np.uint64, endpoint=True)
    pool[:2] = ALL_ONES
    pool[2:4, 0] = 0  # a zero hi limb (or a zero key at W=1)
    table = pool[rng.integers(0, len(pool), N)]
    table = table[np.lexsort(table.T[::-1])] if N else table
    queries = pool[rng.integers(0, len(pool), M)]
    fresh = rng.random(M) < 0.3
    queries[fresh] = rng.integers(0, 2**64 - 1, size=(int(fresh.sum()), W),
                                  dtype=np.uint64, endpoint=True)
    return table, queries


def _np_lower_bound(table, queries):
    if table.shape[1] == 1:
        return np.searchsorted(table[:, 0], queries[:, 0], side="left")
    return np.searchsorted(jarray._combine128(table),
                           jarray._combine128(queries), side="left")


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("N,M", [(600, 900), (0, 50), (300, 0), (40, 900),
                                 (900, 40)])
def test_searchsorted_via_sort_matches_jax(W, N, M):
    table, queries = _lookup_case(W, N, M, seed=N + 7 * M + W)
    got = TK.searchsorted_via_sort(TK.from_numpy_keys(table),
                                   TK.from_numpy_keys(queries))
    assert got.dtype == torch.int64
    want = _np_lower_bound(table, queries)
    assert np.array_equal(got.numpy(), want)
    jax_got = np.asarray(JK.searchsorted_via_sort(jnp.asarray(table),
                                                  jnp.asarray(queries)))
    assert np.array_equal(got.numpy(), jax_got)
    bs = TK.searchsorted(TK.from_numpy_keys(table), TK.from_numpy_keys(queries))
    assert np.array_equal(bs.numpy(), want)


def test_lookup_sort_operands(monkeypatch):
    """The lookup sorts [queries; table] by the limbs alone (the radix
    kernel's num_keys == W layout): int32 positions, a uint8 query flag;
    it refuses N + M rows at the kernel's limit."""
    table, queries = _lookup_case(2, 50, 30, seed=1)
    ops = TK.lookup_operands(TK.from_numpy_keys(table),
                             TK.from_numpy_keys(queries))
    assert [x.dtype for x in ops] == [torch.int64] * 2 + [torch.int32, torch.uint8]
    assert all(x.is_contiguous() and x.shape == (80,) for x in ops)
    assert ops[3].tolist() == [1] * 30 + [0] * 50
    assert np.array_equal(TK.to_numpy_keys(torch.stack(ops[:2], -1)),
                          np.concatenate([queries, table]))
    monkeypatch.setattr(SO, "MAX_ROWS", 80)  # the kernel's row limit
    with pytest.raises(ValueError, match="fewer than 80 rows"):
        TK.lookup_operands(TK.from_numpy_keys(table), TK.from_numpy_keys(queries))


# ------------------------------------------------------------ reference scan


def _genome(rng, n):
    return rng.choice(ACGT, size=n)


def _reference(tmp_path, seed=0):
    """A multi-record reference: a chromosome with an N run, IUPAC
    letters and a repeated block, an empty record, a record of 9 bases,
    a plasmid that repeats a block of the chromosome, and a short tail.
    Returns (path, base chromosome, base plasmid)."""
    rng = np.random.default_rng(seed)
    chrom = _genome(rng, 2400)
    plasmid = _genome(rng, 700)
    chrom[1500:1560] = chrom[300:360]
    plasmid[100:160] = chrom[900:960]
    ref_chrom = chrom.copy()
    ref_chrom[2000:2015] = ord("N")
    ref_chrom[[50, 800, 1200, 2300]] = np.frombuffer(b"RYKM", np.uint8)
    path = tmp_path / "ref.fa"
    path.write_bytes(
        b">chr1 the chromosome\n" + ref_chrom.tobytes() + b"\n>empty\n\n"
        b">short\nACGTACGTA\n>plasmid\n" + plasmid.tobytes()
        + b"\n>tail\n" + _genome(rng, 300).tobytes() + b"\n")
    return str(path), chrom, plasmid


@pytest.mark.parametrize("k", [17, 41])
@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("cap", [None, 600])
def test_refska_matches_jax(tmp_path, monkeypatch, k, rc, cap):
    path, _, _ = _reference(tmp_path, seed=k)
    if cap:  # chr1 and the plasmid extract in k-1-overlap slices
        monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    got = TRefSka(k, path, rc, False, True, device="cpu")
    want = jref.RefSka(k, path, rc, False, True)
    for name in ("kmers", "pos", "chrom", "krc", "repeat_coors"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert got.chrom_names == want.chrom_names
    assert len(got.repeat_coors) > 0
    assert set(got.chrom.tolist()) == {0, 3, 4}


# ------------------------------------------------------------ map


def _cohort(tmp_path, chrom, plasmid, seed, n=4):
    rng = np.random.default_rng(seed)
    files = []
    for s in range(n):
        recs = []
        for g in (chrom, plasmid):
            g = g.copy()
            snp = rng.random(len(g)) < 0.01
            g[snp] = rng.choice(ACGT, size=int(snp.sum()))
            g[rng.integers(0, len(g), 2)] = np.frombuffer(b"SW", np.uint8)
            recs.append(g)
        p = tmp_path / f"s{s}.fa"
        p.write_bytes(b">c\n" + recs[0].tobytes() + b"\n>p\n"
                      + recs[1].tobytes() + b"\n")
        files.append((f"s{s}", str(p), None))
    return files


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """The reference, and .skf files of a 4-sample cohort at k=17 and
    k=41, built by the JAX package (its keys are stored sorted)."""
    d = tmp_path_factory.mktemp("map")
    path, chrom, plasmid = _reference(d)
    files = _cohort(d, chrom, plasmid, seed=3)
    qual = QualOpts(min_count=5, min_qual=20, qual_filter=2)
    skfs = {}
    with pytest.MonkeyPatch.context() as mp:
        for var, val in PIN.items():
            mp.setenv(var, val)
        for k in (17, 41):
            skfs[k] = jskf.save(japi.build(files, k, True, qual), str(d / f"c{k}"))
    return d, path, skfs, files


def _map_both(skf_path, ref, fmt, ambig_mask, repeat_mask, edit=None):
    outs = []
    for mod, sk, kw in ((tapi, tskf, {"device": "cpu"}), (japi, jskf, {})):
        arr = sk.load(skf_path)
        if edit:
            edit(arr)
        fh = io.BytesIO() if fmt == "aln" else io.StringIO()
        mod.map_mode(arr, ref, fh, fmt, ambig_mask, repeat_mask, **kw)
        outs.append(fh.getvalue())
    return outs


@pytest.mark.parametrize("k,fmt,ambig_mask,repeat_mask", [
    (17, "aln", False, False), (17, "vcf", False, False),
    (17, "aln", True, True), (17, "vcf", True, True),
    (41, "aln", False, True), (41, "vcf", True, False),
])
def test_map_bytes_match_jax(mapped, k, fmt, ambig_mask, repeat_mask):
    _, ref, skfs, _ = mapped
    got, want = _map_both(skfs[k], ref, fmt, ambig_mask, repeat_mask)
    assert got == want
    if fmt == "aln":
        assert got.count(b">") == 4 and got.count(b"\n") == 8
    else:
        assert got.startswith("##fileformat=VCFv4.4\n##contig=<ID=chr1>\n")
        assert len(got.splitlines()) > 7  # variant records


@pytest.mark.parametrize("fmt", ["aln", "vcf"])
def test_map_unsorted_skf_matches_jax(mapped, fmt):
    """Rows stored out of key order take sorted_view's permutation."""
    _, ref, skfs, _ = mapped

    def shuffle(arr):
        perm = np.random.default_rng(5).permutation(arr.ksize)
        arr._take_rows(perm)
        assert arr.sorted_view()[1] is not None

    got, want = _map_both(skfs[17], ref, fmt, False, True, shuffle)
    assert got == want
    assert got == _map_both(skfs[17], ref, fmt, False, True)[0]


def test_map_all_weeded_raises_as_jax(mapped):
    _, ref, skfs, _ = mapped

    def weed_all(arr):
        arr._take_rows(np.zeros(arr.ksize, bool))

    for mod, sk, kw in ((tapi, tskf, {"device": "cpu"}), (japi, jskf, {})):
        arr = sk.load(skfs[17])
        weed_all(arr)
        with pytest.raises(ValueError, match="No split k-mers mapped to reference"):
            mod.map_mode(arr, ref, io.BytesIO(), "aln", **kw)


def test_map_threads_keep_bytes(mapped, monkeypatch):
    _, ref, skfs, _ = mapped
    one = _map_both(skfs[41], ref, "aln", True, True)[0]
    monkeypatch.setenv("SKA_THREADS", "3")
    arr = tskf.load(skfs[41])
    fh = io.BytesIO()
    tapi.map_mode(arr, ref, fh, "aln", True, True, device="cpu")
    assert fh.getvalue() == one


# ------------------------------------------------------------ weed


@pytest.mark.parametrize("use_weed,reverse,min_freq,filt,ambig_mask,const_gaps", [
    (True, False, 0.0, "no-filter", False, False),
    (True, True, 0.0, "no-filter", False, False),
    (True, False, 0.5, "no-const", True, False),
    (False, False, 0.9, "no-ambig-or-const", False, True),
])
def test_weed_bytes_match_jax(mapped, tmp_path, use_weed, reverse, min_freq,
                              filt, ambig_mask, const_gaps):
    d, ref, skfs, _ = mapped
    outs = []
    for mod, sk, kw in ((tapi, tskf, {"device": "cpu"}), (japi, jskf, {})):
        arr = sk.load(skfs[17])
        out = str(tmp_path / f"{mod.__name__}.skf")
        mod.weed_mode(arr, ref if use_weed else None, reverse, min_freq, False,
                      filt, ambig_mask, const_gaps, out, **kw)
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    weeded = tskf.load(str(tmp_path / f"{tapi.__name__}.skf"))
    assert 0 < weeded.ksize < tskf.load(skfs[17]).ksize


# ------------------------------------------------------------ CLI


def _run(args, cwd, **env):
    r = subprocess.run(args, cwd=cwd, capture_output=True, timeout=600,
                       env=dict(os.environ, **PIN, **env))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r


def _no_jax(r):
    import re

    imported = re.findall(r"\|\s+([\w.]+)\s*$", r.stderr.decode(), re.M)
    assert "ska_tpu_torch.ref" in imported
    return not [m for m in imported if m in ("jax", "ska_tpu")
                or m.startswith(("jax.", "ska_tpu."))]


PORT = [sys.executable, "-X", "importtime", "-m", "ska_tpu_torch"]
REF = [sys.executable, os.path.join(REPO, "ska.py")]


def test_cli_map_matches_ska_py_without_jax(mapped, tmp_path):
    _, ref, skfs, _ = mapped
    args = ["map", ref, skfs[17], "-f", "vcf", "--repeat-mask"]
    port = _run(PORT + args + ["--device", "cpu", "--threads", "2"], REPO)
    want = _run(REF + args, tmp_path, JAX_PLATFORMS="cpu")
    assert port.stdout == want.stdout and port.stdout.startswith(b"##file")
    assert _no_jax(port)
    _run(PORT + ["map", ref, skfs[41], "-o", str(tmp_path / "p.aln"),
                 "--device", "cpu"], REPO)
    _run(REF + ["map", ref, skfs[41], "-o", str(tmp_path / "r.aln")], tmp_path,
         JAX_PLATFORMS="cpu")
    assert (tmp_path / "p.aln").read_bytes() == (tmp_path / "r.aln").read_bytes()


def test_cli_weed_matches_ska_py_without_jax(mapped, tmp_path):
    _, ref, skfs, _ = mapped
    args = [skfs[17], ref, "--reverse", "--filter", "no-const", "-m", "0.25"]
    port = _run(PORT + ["weed", *args, "-o", str(tmp_path / "p.skf"),
                        "--device", "cpu"], REPO)
    _run(REF + ["weed", *args, "-o", str(tmp_path / "r.skf")], tmp_path,
         JAX_PLATFORMS="cpu")
    assert (tmp_path / "p.skf").read_bytes() == (tmp_path / "r.skf").read_bytes()
    assert _no_jax(port)
