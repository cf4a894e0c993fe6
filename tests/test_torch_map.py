"""The port's `ska map` and `ska weed` on the CPU, against the JAX package.

- ops.keys.lower_bound (on the CPU its plain version, the binary search
  ops.keys.searchsorted) equals ska_tpu.ops.keys.searchsorted_via_sort
  and np.searchsorted (side="left") at W=1 and W=2, with duplicates, an
  empty table, no queries, more queries than keys and the other way
  round, runs of equal keys, all-ones keys and queries, one key, and W=2
  keys whose first limbs tie; a numpy emulation of the lookup kernel's
  algorithm (csrc/lower_bound.cu: the plan, the splitters and levels,
  the lifting over the splitters, then each level's lines read by teams
  of lanes and counted from ballots) equals np.searchsorted on the same
  cases and on ragged last lines, a table viewed at an odd int64
  offset, W=2 runs of tied first limbs and queries outside the keys,
  with shrunk and with full 128-byte lines; the plan at the kernel's
  own sizes; the kernel's wrapper refuses what the kernel does not take
  without loading, preparing or launching;
- ref.RefSka lists the JAX RefSka's kmers, pos, chrom, krc and
  repeat_coors on a multi-record reference (an empty record, one shorter
  than k, an N run, IUPAC letters, repeats) at k=17 and k=41, on one
  strand and both, whole and sliced by SKA_MAX_CHUNK_BASES;
- api.map_mode writes the aln and VCF bytes of ska_tpu.api.map_mode with
  and without the ambiguity and repeat masks, for a .skf whose keys are
  not sorted, and raises the same error for an all-weeded .skf;
- RefSka._vcf_records, the host library's VCF writer
  (csrc/host/vcf_write.cpp), writes the text of the per-column loop it
  replaced on hand-built alignments (ALT order, IUPAC codes folded to
  one N, non-ACGT and lowercase reference bytes, gaps, POS restarting
  at each contig, no variant, 1, 40 and 616 samples), whole and in
  blocks of the binding's block_bytes;
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
from ska_tpu_torch.io import native as tnative
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


POP8 = np.array([bin(i).count("1") for i in range(256)])


def _count_below(read, first, valid, q, lines, W):
    """count_below of csrc/lower_bound.cu for every lane of every warp:
    teams of LINE_BYTES / 16 lanes read 16 bytes each of the windows of
    lanes rd * teams + team, round by round, and each lane counts its
    team's bits in the ballot of its own round. read(idx) gives entries
    of the level; entries a lane may not read are all-ones."""
    R = LU.line_rows(W)
    team = LU.LINE_BYTES // 16
    teams, per = 32 // team, 2 // W
    lane = np.arange(32)
    F, V = first.reshape(-1, 32), valid.reshape(-1, 32)
    Q = q.reshape(-1, 32, W)
    shift_own = (lane % teams) * team
    count = np.zeros_like(F)
    for k in range(lines):
        e0 = k * R + (lane % team) * per
        for rd in range(team):
            src = rd * teams + lane // team
            f, avail, sq = F[:, src], V[:, src] - e0, Q[:, src]
            for j in range(per):
                ok = avail > j
                key = np.full(sq.shape, ALL_ONES, np.uint64)
                key[ok] = read((f + e0 + j)[ok])
                ballot = (_less(key, sq).astype(np.int64) << lane).sum(axis=1)
                n_below = POP8[(ballot[:, None] >> shift_own)
                               & ((1 << team) - 1)]
                count += np.where(lane // teams == rd, n_below, 0)
    return count.ravel()


def _emulate_lower_bound(flat, start, n, W, queries):
    """The lookup kernel's algorithm in numpy, step for step: the table
    is the n rows of W limbs from element `start` of the uint64 array
    `flat`, read as the kernel reads a view (rows counted from its
    start). The wrapper's plan; levels_kernel's splitters and levels in
    one buffer of lines (its padding garbage); search_kernel's lifting
    over the splitters in warps of 32 lanes, then count_below from the
    top level (2^log_lines lines) down to the table's line."""
    p = LU.plan(n, W)
    R = LU.line_rows(W)
    r = R.bit_length() - 1
    pad = lambda x: -(-x // R) * R  # noqa: E731

    def table(rows):
        return flat[start + rows[..., None] * W + np.arange(W)]

    rng = np.random.default_rng(n)
    buf = rng.integers(0, 2**64 - 1, size=(p.rows, W), dtype=np.uint64,
                       endpoint=True)
    rows = np.arange(-(-n // R)) * R
    keys = table(rows)
    at = rows % (1 << p.shift) == 0
    buf[rows[at] >> p.shift] = keys[at]
    offs, off = {}, pad(p.splitters)
    for l in range(p.levels, 0, -1):
        at = rows % (1 << (r * l)) == 0
        buf[off + (rows[at] >> (r * l))] = keys[at]
        offs[l] = off
        off += pad(-(-n // (1 << (r * l))))
    assert off == p.rows

    m = len(queries)
    q = np.zeros((-(-m // 32) * 32, W), np.uint64)
    q[:m] = queries
    live = np.arange(len(q)) < m
    split = buf[:p.splitters]
    c = np.zeros(len(q), np.int64)
    step = 1 << (p.splitters.bit_length() - 1) if p.splitters else 0
    while step:
        j = c + step
        s = np.minimum(j, p.splitters) - 1
        c = np.where((j <= p.splitters) & _less(split[s], q), j, c)
        step >>= 1
    searching = live & (c > 0)
    row = np.where(searching, (c - 1) << p.shift, 0)
    for l in range(p.levels, -1, -1):
        s = r * l
        first = row >> s
        lines = 1 << p.log_lines if l == p.levels else 1
        valid = np.where(searching,
                         np.minimum(lines * R, -(-n // (1 << s)) - first), 0)
        read = (lambda idx, o=offs.get(l): buf[o + idx]) if l else table
        below = _count_below(read, first, valid, q, lines, W)
        assert (below[searching] >= 1).all()
        row = np.where(searching, row + ((below - 1) << s), row)
    return np.where(searching, row + 1, 0)[:m]


def _kernel_case(W, N, M):
    """A case of the kernel's algorithm as (flat, start, n, queries):
    LOOKUP_CASES, and the ones of KERNEL_CASES: a table as a view at an
    odd int64 offset ("offset"), W=2 runs of tied first limbs across
    level boundaries ("hi_runs"), queries below and above every key
    ("outside")."""
    if N not in ("offset", "hi_runs", "outside"):
        table, queries = _case(W, N, M)
        return table.reshape(-1), 0, len(table), queries
    rng = np.random.default_rng(len(N) + 10 * W)
    if N == "offset":
        table, queries = _lookup_case(W, 700, 600, seed=11 + W)
        flat = rng.integers(0, 2**64 - 1, size=table.size + 8,
                            dtype=np.uint64, endpoint=True)
        flat[3 : 3 + table.size] = table.reshape(-1)
        return flat, 3, len(table), queries
    if N == "hi_runs":  # ~37 rows a first limb; lines of 2-8 rows
        hi = np.sort(rng.integers(0, 2**64 - 1, size=30, dtype=np.uint64,
                                  endpoint=True))
        table = _sorted(np.stack([rng.choice(hi, 1100), rng.integers(
            0, 2**64 - 1, size=1100, dtype=np.uint64, endpoint=True)], -1))
        table[500:540, 0] = table[500, 0]
        table = _sorted(table)
        queries = _near(table, rng, 600)
        queries[::5, 1] = rng.integers(0, 2**64 - 1, size=len(queries[::5]),
                                       dtype=np.uint64, endpoint=True)
        queries[1::5, 1] = 0
        queries[2::5, 1] = ALL_ONES
        return table.reshape(-1), 0, len(table), queries
    table = _sorted(rng.integers(1 << 20, 1 << 62, size=(800, W),
                                 dtype=np.uint64))
    lo, hi = table[0].copy(), table[-1].copy()
    queries = np.stack([np.zeros(W, np.uint64), lo - np.uint64(1), lo,
                        hi, hi + np.uint64(1), np.full(W, ALL_ONES)]
                       * 50)
    return table.reshape(-1), 0, len(table), queries


# the ragged last lines: N = 1 and 15 (mod 16) at W=1, 1 and 7 (mod 8) at
# W=2 (so also mod the shrunk lines' 4 and 2 rows)
KERNEL_CASES = LOOKUP_CASES + (
    [(1, 593, 700), (1, 607, 700), (2, 601, 700), (2, 607, 700)]
    + [(W, kind, None) for W in (1, 2) for kind in ("offset", "outside")]
    + [(2, "hi_runs", None)])


def _check_kernel_algorithm(W, N, M, most):
    flat, start, n, queries = _kernel_case(W, N, M)
    p = LU.plan(n, W)
    assert p.splitters <= most and (p.splitters << p.shift) >= n
    table = flat[start : start + n * W].reshape(n, W)
    assert np.array_equal(_emulate_lower_bound(flat, start, n, W, queries),
                          _np_lower_bound(table, queries))
    return p, n


@pytest.mark.parametrize("W,N,M", KERNEL_CASES)
def test_lower_bound_kernel_algorithm(W, N, M, monkeypatch):
    """With 64 bytes of splitters in place of 128 KiB (8 at W=1, 4 at
    W=2) and lines of 32 bytes (4 rows at W=1, 2 at W=2, teams of 2
    lanes), every case of more than 64 keys (W=1) or 16 (W=2) searches
    levels below the splitters, two lines wide at the top or one."""
    monkeypatch.setattr(LU, "SPLITTER_BYTES", 64)
    monkeypatch.setattr(LU, "LINE_BYTES", 32)
    p, n = _check_kernel_algorithm(W, N, M, 8 // W)
    assert (p.levels >= 1) == (n > 2 * (8 // W) * LU.line_rows(W))


@pytest.mark.parametrize("W,N,M", KERNEL_CASES)
def test_lower_bound_kernel_algorithm_full_lines(W, N, M, monkeypatch):
    """The kernel's own 128-byte lines (16 rows at W=1, 8 at W=2, teams
    of 8 lanes) with 64 bytes of splitters: tables of more than 256 keys
    (W=1) or 64 (W=2) search levels below the splitters."""
    monkeypatch.setattr(LU, "SPLITTER_BYTES", 64)
    p, n = _check_kernel_algorithm(W, N, M, 8 // W)
    assert (p.levels >= 1) == (n > 2 * (8 // W) * LU.line_rows(W))


@pytest.mark.parametrize("n,W,want", [
    (0, 1, (0, 0, 4, 0)), (1, 1, (0, 0, 4, 1)),
    (1 << 18, 1, (0, 0, 4, 16384)), ((1 << 18) + 1, 1, (0, 1, 5, 8193)),
    (6_447_824, 1, (1, 1, 9, 12594)), (1 << 23, 1, (1, 1, 9, 16384)),
    ((1 << 23) + 1, 1, (2, 0, 12, 2049)), (1 << 24, 1, (2, 0, 12, 4096)),
    (1 << 22, 2, (2, 0, 9, 8192)), (1 << 23, 2, (2, 1, 10, 8192)),
])
def test_lower_bound_plan(n, W, want):
    """The plan at the kernel's own sizes: (levels, log_lines, shift,
    splitters); the levels take every 16th row (W=1) or 8th (W=2), and
    the buffer holds the splitters and levels in whole lines."""
    p = LU.plan(n, W)
    assert (p.levels, p.log_lines, p.shift, p.splitters) == want
    R = LU.line_rows(W)
    level_rows = [-(-n // R**l) for l in range(1, p.levels + 1)]
    assert p.rows % R == 0 and p.rows >= p.splitters + sum(level_rows)
    assert p.rows < p.splitters + sum(level_rows) + R * (p.levels + 1)


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
    before it loads, prepares a device or launches anything."""
    keys, queries = _bad_operands(kind)
    before = LU.lower_bound_launches
    with pytest.raises(error, match=match):
        LU.check_operands(keys, queries)
    with pytest.raises(error, match=match):
        LU.lower_bound(keys, queries)
    assert LU.lower_bound_launches == before and LU._LIB is None
    assert LU._SMS == {}


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
    for fmt in ("aln", "vcf"):
        one = _map_both(skfs[41], ref, fmt, True, True)[0]
        with monkeypatch.context() as mp:
            mp.setenv("SKA_THREADS", "3")
            arr = tskf.load(skfs[41])
            fh = io.BytesIO() if fmt == "aln" else io.StringIO()
            tapi.map_mode(arr, ref, fh, fmt, True, True, device="cpu")
        assert fh.getvalue() == one, fmt


# ------------------------------------------------------------ VCF records


def _vcf_loop(seqs, names, aln):
    """The records as the per-column loop the host library replaced
    wrote them (ska_ref.rs:707-750)."""
    ref = np.concatenate(seqs)
    lens = [len(s) for s in seqs]
    starts = np.cumsum([0] + lens[:-1])
    chrom_of = np.repeat(np.arange(len(seqs)), lens)
    fold = lambda b: chr(b) if chr(b) in "ACGT" else "N"  # noqa: E731
    out = []
    for col in np.nonzero((aln != ref[None, :]).any(axis=0))[0]:
        ci, rb = chrom_of[col], ref[col]
        gts, alts = [], []
        for mb in aln[:, col]:
            if mb == rb:
                gts.append("0")
            elif mb == ord("-"):
                gts.append(".")
            else:
                if fold(mb) not in alts:
                    alts.append(fold(mb))
                gts.append(str(alts.index(fold(mb)) + 1))
        out.append(f"{names[ci]}\t{col - starts[ci] + 1}\t.\t{fold(rb)}\t"
                   f"{','.join(alts) or '.'}\t.\t.\t.\tGT\t"
                   + "\t".join(gts) + "\n")
    return "".join(out)


def _random_vcf_case(n_samples, lens, seed):
    """Contigs of random ACGT with some lowercase and IUPAC bytes, and
    samples that mostly keep the reference's byte."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"ACGTN-RYKMacgtn", np.uint8)
    seqs = [rng.choice(pool[[0, 1, 2, 3, 3, 2, 1, 0, 4, 6, 10]], n) for n in lens]
    ref = np.concatenate(seqs)
    aln = np.repeat(ref[None, :], n_samples, axis=0)
    hit = rng.random(aln.shape) < 0.02
    aln[hit] = rng.choice(pool, int(hit.sum()))
    return ([s.tobytes() for s in seqs], [f"ctg{i}" for i in range(len(lens))],
            [r.tobytes() for r in aln], None, 1)


# each case: contigs, their names, the samples' rows, the text expected
# (or None: the loop's alone), and the binding's block_bytes
VCF_CASES = {
    "alt_order": lambda: (
        [b"ACGTA"], ["chr"], [b"TCGTA", b"GCGTC", b"TCGTG", b"CCGT-"],
        "chr\t1\t.\tA\tT,G,C\t.\t.\t.\tGT\t1\t2\t1\t3\n"
        "chr\t5\t.\tA\tC,G\t.\t.\t.\tGT\t0\t1\t2\t.\n", 1),
    "iupac_fold_to_one_n": lambda: (
        [b"ACGT"], ["c"], [b"RCGT", b"YCGT", b"ACGN", b"NCGT"],
        "c\t1\t.\tA\tN\t.\t.\t.\tGT\t1\t1\t0\t1\n"
        "c\t4\t.\tT\tN\t.\t.\t.\tGT\t0\t0\t1\t0\n", 1),
    "ref_not_acgt": lambda: (
        [b"NaRcG"], ["c"], [b"AaYCG", b"NAR-g"],
        "c\t1\t.\tN\tA\t.\t.\t.\tGT\t1\t0\n"
        "c\t2\t.\tN\tA\t.\t.\t.\tGT\t0\t1\n"
        "c\t3\t.\tN\tN\t.\t.\t.\tGT\t1\t0\n"
        "c\t4\t.\tN\tC\t.\t.\t.\tGT\t1\t.\n"
        "c\t5\t.\tG\tN\t.\t.\t.\tGT\t0\t1\n", 1),
    "all_gap_column": lambda: (
        [b"ACGT"], ["c"], [b"A-GT"] * 3,
        "c\t2\t.\tC\t.\t.\t.\t.\tGT\t.\t.\t.\n", 1),
    "pos_restarts_per_contig": lambda: (
        [b"ACG", b"", b"TTAA", b"G"], ["c1", "empty", "c3", "c4"],
        [b"CCTATAAC", b"ACGTTAGG"],
        "c1\t1\t.\tA\tC\t.\t.\t.\tGT\t1\t0\n"
        "c1\t3\t.\tG\tT\t.\t.\t.\tGT\t1\t0\n"
        "c3\t1\t.\tT\tA\t.\t.\t.\tGT\t1\t0\n"
        "c3\t4\t.\tA\tG\t.\t.\t.\tGT\t0\t1\n"
        "c4\t1\t.\tG\tC\t.\t.\t.\tGT\t1\t0\n", 1),
    "no_variant": lambda: ([b"ACGTN", b"ac"], ["a", "b"], [b"ACGTNac"] * 2, "", 1),
    "one_sample": lambda: (
        [b"ACGTACGT"], ["c"], [b"AGGTAC-T"],
        "c\t2\t.\tC\tG\t.\t.\t.\tGT\t1\n"
        "c\t7\t.\tG\t.\t.\t.\t.\tGT\t.\n", 1),
    "forty_samples": lambda: _random_vcf_case(40, [700, 0, 300], 1),
    "616_samples": lambda: _random_vcf_case(616, [900, 100], 2),
    # past one block of text and past the writer's 8,192-column tiles
    "block_boundary": lambda: _random_vcf_case(3, [12000, 9000], 3)[:4] + (4096,),
}


@pytest.mark.parametrize("case", list(VCF_CASES))
def test_vcf_records_match_loop(case):
    seqs, names, rows, want, block_bytes = VCF_CASES[case]()
    seqs = [np.frombuffer(s, np.uint8) for s in seqs]
    aln = np.array([np.frombuffer(r, np.uint8) for r in rows])
    loop = _vcf_loop(seqs, names, aln)
    if want is not None:
        assert loop == want
    ref = TRefSka.__new__(TRefSka)
    ref.seq, ref.chrom_names = seqs, names
    got = []
    ref._vcf_records(got.append, aln)
    assert "".join(got) == loop
    assert len(got) == (1 if loop else 0)  # one block at the default size

    lens = np.array([len(s) for s in seqs])
    blocks = list(tnative.vcf_write(aln, np.concatenate(seqs),
                                    np.cumsum(lens) - lens, names,
                                    block_bytes=block_bytes))
    assert "".join(blocks) == loop
    assert all(b.endswith("\n") for b in blocks)
    if block_bytes == 1:  # no room beyond one record a block
        assert len(blocks) == loop.count("\n")
    else:
        assert len(blocks) > 2
        assert all(len(b) <= block_bytes for b in blocks)


def test_vcf_write_refuses_what_does_not_fit():
    aln = np.frombuffer(b"ACGT", np.uint8)[None, :]
    ref = np.frombuffer(b"ACG", np.uint8)
    with pytest.raises(ValueError, match="does not span"):
        list(tnative.vcf_write(aln, ref, [0], ["c"]))
    with pytest.raises(ValueError, match="differ in length"):
        list(tnative.vcf_write(aln, np.frombuffer(b"ACGA", np.uint8), [0, 2], ["c"]))
    with pytest.raises(ValueError, match="NUL"):
        list(tnative.vcf_write(aln, np.frombuffer(b"ACGA", np.uint8), [0], ["c\x00d"]))


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
