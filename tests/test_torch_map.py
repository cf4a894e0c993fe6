"""The port's `ska map` and `ska weed` on the CPU, against the JAX package.

- ops.keys.lower_bound (on the CPU its plain version, the binary search
  ops.keys.searchsorted) equals ska_tpu.ops.keys.searchsorted_via_sort
  and np.searchsorted (side="left") at W=1 and W=2, with duplicates, an
  empty table, no queries, more queries than keys and the other way
  round, runs of equal keys, all-ones keys and queries, one key, and W=2
  keys whose first limbs tie; a numpy emulation of the lookup kernel's
  algorithm (csrc/lower_bound.cu: splitters, then the window) equals
  np.searchsorted on the same cases; the kernel's wrapper refuses what
  the kernel does not take without launching;
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
from ska_tpu_torch.ops import lookup as LU
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
    table = _sorted(table)
    queries = pool[rng.integers(0, len(pool), M)]
    fresh = rng.random(M) < 0.3
    queries[fresh] = rng.integers(0, 2**64 - 1, size=(int(fresh.sum()), W),
                                  dtype=np.uint64, endpoint=True)
    return table, queries


def _sorted(keys):
    return keys[np.lexsort(keys.T[::-1])] if len(keys) else keys


def _near(keys, rng, M):
    """M queries drawn from keys, each moved by -1, 0 or +1 in its last
    limb (wrapping), so they fall just below, on and just above keys."""
    q = keys[rng.integers(0, len(keys), M)].copy()
    q[:, -1] += rng.integers(-1, 2, M).astype(np.uint64)
    return q


def _edge_case(kind, W, seed):
    """The lookup's edge cases: long runs of equal keys ("runs"), a
    table that is mostly all-ones with all-ones queries ("ones"), one key
    ("one"), and at W=2 runs of tied first limbs ("hi_ties")."""
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):
        if kind == "runs":
            distinct = rng.integers(0, 2**64 - 1, size=(40, W),
                                    dtype=np.uint64, endpoint=True)
            table = _sorted(np.repeat(distinct, rng.integers(1, 60, 40),
                                      axis=0))
            return table, _near(table, rng, 700)
        if kind == "ones":
            low = rng.integers(0, 2**64 - 1, size=(12, W), dtype=np.uint64,
                               endpoint=True)
            table = _sorted(np.concatenate(
                [low, np.full((300, W), ALL_ONES, np.uint64)]))
            queries = _near(table, rng, 400)
            queries[::3] = ALL_ONES
            return table, queries
        if kind == "one":
            table = rng.integers(0, 2**64 - 1, size=(1, W), dtype=np.uint64,
                                 endpoint=True)
            queries = np.concatenate([
                _near(table, rng, 30),
                np.zeros((1, W), np.uint64),
                np.full((1, W), ALL_ONES, np.uint64)])
            return table, queries
        assert kind == "hi_ties" and W == 2
        hi = rng.integers(0, 2**64 - 1, size=4, dtype=np.uint64,
                          endpoint=True)
        hi[0] = ALL_ONES
        table = np.stack([rng.choice(hi, 900), rng.integers(
            0, 2**64 - 1, size=900, dtype=np.uint64, endpoint=True)], -1)
        table[:40, 1] = 0
        table[40:80, 1] = ALL_ONES
        table = _sorted(table)
        queries = _near(table, rng, 500)
        queries[::7, 1] = rng.integers(0, 2**64 - 1, size=len(queries[::7]),
                                       dtype=np.uint64, endpoint=True)
        return table, queries


LOOKUP_CASES = (
    [(W, N, M) for W in (1, 2) for N, M in [(600, 900), (0, 50), (300, 0),
                                            (40, 900), (900, 40)]]
    + [(W, kind, None) for W in (1, 2) for kind in ("runs", "ones", "one")]
    + [(2, "hi_ties", None)])


def _case(W, N, M):
    if isinstance(N, str):
        return _edge_case(N, W, seed=len(N) + W)
    return _lookup_case(W, N, M, seed=N + 7 * M + W)


def _np_lower_bound(table, queries):
    if table.shape[1] == 1:
        return np.searchsorted(table[:, 0], queries[:, 0], side="left")
    return np.searchsorted(jarray._combine128(table),
                           jarray._combine128(queries), side="left")


@pytest.mark.parametrize("W,N,M", LOOKUP_CASES)
def test_lower_bound_matches_jax(W, N, M):
    table, queries = _case(W, N, M)
    got = TK.lower_bound(TK.from_numpy_keys(table), TK.from_numpy_keys(queries))
    assert got.dtype == torch.int64
    want = _np_lower_bound(table, queries)
    assert np.array_equal(got.numpy(), want)
    jax_got = np.asarray(JK.searchsorted_via_sort(jnp.asarray(table),
                                                  jnp.asarray(queries)))
    assert np.array_equal(got.numpy(), jax_got)


def _less(a, b):
    """Unsigned lexicographic a < b over rows of uint64 limbs."""
    lt = a[..., 0] < b[..., 0]
    if a.shape[-1] == 2:
        lt |= (a[..., 0] == b[..., 0]) & (a[..., 1] < b[..., 1])
    return lt


def _emulate_lower_bound(table, queries):
    """The lookup kernel's algorithm in numpy, step for step: the
    wrapper's splitter plan, the lifting over the splitters, then the
    lifting over the window of rows after the last splitter below."""
    n = len(table)
    s, n_split = LU.splitter_plan(n, table.shape[1])
    split = table[(np.arange(n_split) << s)]
    c = np.zeros(len(queries), np.int64)
    step = 1 << (n_split.bit_length() - 1) if n_split else 0
    while step:
        j = c + step
        r = np.minimum(j, n_split) - 1
        c = np.where((j <= n_split) & _less(split[r], queries), j, c)
        step >>= 1
    lo = np.where(c > 0, (c - 1) << s, -1)
    step = (1 << s) >> 1
    while step:
        j = lo + step
        key = table[np.minimum(j, n - 1)]
        lo = np.where((j < n) & _less(key, queries), j, lo)
        step >>= 1
    return lo + 1


@pytest.mark.parametrize("W,N,M", LOOKUP_CASES)
def test_lower_bound_kernel_algorithm(W, N, M, monkeypatch):
    """With 64 bytes of splitters in place of 128 KiB (8 at W=1, 4 at
    W=2), every case of more than 8 keys ends in windows of several
    rows."""
    monkeypatch.setattr(LU, "SPLITTER_BYTES", 64)
    table, queries = _case(W, N, M)
    s, n_split = LU.splitter_plan(len(table), W)
    assert n_split <= 8 // W and (n_split << s) >= len(table)
    assert np.array_equal(_emulate_lower_bound(table, queries),
                          _np_lower_bound(table, queries))


def _bad_operands(kind):
    keys = torch.arange(12, dtype=torch.int64).reshape(6, 2)
    if kind == "dtype":
        return keys.to(torch.int32), keys.to(torch.int32)
    if kind == "w3":
        keys = torch.arange(18, dtype=torch.int64).reshape(6, 3)
        return keys, keys
    if kind == "w_mismatch":
        return keys, keys[:, :1].contiguous()
    if kind == "strided":
        return keys, keys.t().contiguous().t()
    if kind == "one_dim":
        return keys[:, 0].contiguous(), keys[:, 0].contiguous()
    assert kind == "cpu"
    return keys, keys


@pytest.mark.parametrize("kind,error,match", [
    ("dtype", TypeError, "int64"),
    ("w3", ValueError, "1 or 2 limbs"),
    ("w_mismatch", ValueError, "do not compare"),
    ("strided", ValueError, "contiguous"),
    ("one_dim", ValueError, r"\(rows, W\)"),
    ("cpu", ValueError, "one CUDA device"),
])
def test_lower_bound_wrapper_refuses(kind, error, match):
    """The kernel's wrapper raises on what the kernel does not take,
    before it loads or launches anything."""
    keys, queries = _bad_operands(kind)
    before = LU.lower_bound_launches
    with pytest.raises(error, match=match):
        LU.check_operands(keys, queries)
    with pytest.raises(error, match=match):
        LU.lower_bound(keys, queries)
    assert LU.lower_bound_launches == before and LU._LIB is None


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
