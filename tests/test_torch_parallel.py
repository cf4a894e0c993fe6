"""The port's sharded build, map lookup and distance Gram on gloo process
groups of 2 and 4 ranks, against the serial port and the JAX package.

A module fixture launches each world once: this file runs itself as

    python tests/test_torch_parallel.py <rank> <world> <port> <dir>

in one process per rank (``mp.spawn`` cannot re-import a pytest module),
joined by ska_tpu_torch.parallel.init_multihost on gloo. Every rank runs
every scenario of SCENARIOS with SKA_DISTRIBUTED=1 and rank 0 writes its
results to <dir>/w<world>/<scenario>.npz. The tests then hold each
scenario, exactly (the results are integers and bytes), to

- the serial port on the CPU (``device="cpu"``, no process group), and
- for build, lookup and Gram, the JAX package's own mesh functions on
  ``build_mesh(world)`` of the conftest's 8 virtual CPU devices.

The scenarios are those of tests/test_parallel.py: build over k and a
sample count that does not divide the world, repeats and IUPAC, FASTQ
min-count 1-3, the middle-quality gate, skewed keys (and one whose ranks
are left with empty buckets), lookup at W=1 and W=2, the class Gram over
one chunk and several, oversized samples, mixed lengths in one exchange,
`map`/`distance` end to end, and dryrun_step (graft_entry's dry run). Two `python -m ska_tpu_torch` processes
joined by SKA_COORDINATOR run `build`, `map`, `distance` and `align` of
FASTA files; rank 0 alone writes, byte for byte ./ska.py's pinned
serial output.

The rank processes import neither jax nor ska_tpu; the tests do, lazily.
"""

import datetime
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_tpu_torch import api as tapi
from ska_tpu_torch import distance as TD
from ska_tpu_torch import sample as tsample
from ska_tpu_torch.array import SkaArray
from ska_tpu_torch.io import fastx as tfastx
from ska_tpu_torch.ops import keys as TK
from ska_tpu_torch.ops import pipeline as TP
from ska_tpu_torch.parallel import build as PB
from ska_tpu_torch.parallel import comm
from ska_tpu_torch.parallel import postbuild as PP
from ska_tpu_torch.sampletypes import QualOpts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
WORLDS = (2, 4)
TIMEOUT_S = 240


# ---- inputs, made from seeds (both the ranks and the tests make them) ----


def _fasta_rows(seed, n, L=300, n_frac=0.02):
    """(n, L) random bases with ~2% N, one record each (mask staging)."""
    rng = np.random.default_rng(seed)
    seqs = rng.choice(ACGT, size=(n, L))
    seqs[rng.random((n, L)) < n_frac] = ord("N")
    return _fasta_call(seqs)


def _fasta_call(seqs):
    rec_last = np.zeros(seqs.shape, bool)
    rec_last[:, -1] = True
    return dict(seqs=seqs, valid=(seqs & 0xF) != 14,
                qual=np.ones(seqs.shape, bool), rec_last=rec_last,
                sids=np.arange(len(seqs), dtype=np.int32),
                is_reads=False, use_mq=False)


def _repeat_iupac():
    # flanks equal, middles differ: one split k-mer, an IUPAC union
    seq = b"AATTGGGACCCTTAA" + b"AATTGGGTCCCTTAA" + b"A" * 10
    return _fasta_call(np.frombuffer(seq, np.uint8)[None].repeat(2, 0))


def _fastq_rows(min_count, n_samples=5, n_reads=24, RL=60):
    """Reads that repeat, so that some k-mers pass the count filter."""
    rng = np.random.default_rng(7)
    base_reads = rng.choice(ACGT, size=(4, RL))
    batches = []
    for _ in range(n_samples):
        reads = [base_reads[rng.integers(0, 4)].tobytes() for _ in range(n_reads)]
        batches.append(tfastx.build_batch(reads))
    L = max(len(b.seq) for b in batches)
    c = dict(seqs=np.zeros((n_samples, L), np.uint8),
             valid=np.zeros((n_samples, L), bool),
             qual=np.zeros((n_samples, L), bool),
             rec_last=np.zeros((n_samples, L), bool),
             sids=np.arange(n_samples, dtype=np.int32),
             is_reads=True, use_mq=False)
    for i, b in enumerate(batches):
        n = len(b.seq)
        c["seqs"][i, :n] = b.seq
        c["valid"][i, :n] = ((b.seq & 0xF) != 14) & (b.seq != 0)
        c["qual"][i, :n] = True
        c["rec_last"][i, :n] = b.rec_last
    return c


def _mid_qual_rows(n_samples=3, L=240, min_qual=20):
    rng = np.random.default_rng(11)
    c = _fasta_call(rng.choice(ACGT, size=(n_samples, L)))
    squal = rng.integers(33, 75, size=(n_samples, L), dtype=np.uint8)
    c.update(qual=(squal.astype(np.int16) - 33) > min_qual, is_reads=True,
             use_mq=True)
    return c


def _skewed_rows():
    """Identical samples: every rank sends the same key ranges."""
    one = np.random.default_rng(3).choice(ACGT, size=300)
    return _fasta_call(np.broadcast_to(one, (8, 300)).copy())


def _two_key_rows():
    """Homopolymers: two split k-mers in all (poly-A/T, poly-C/G), so at
    world 4 most ranks receive an empty bucket."""
    return _fasta_call(np.stack([np.full(300, b, np.uint8)
                                 for b in b"ACAGTCA"]))


# name: (calls maker, k, min_count)
BUILD_CASES = {
    "build_k17_n8": (lambda: _fasta_rows(42, 8), 17, 0),
    "build_k17_n11": (lambda: _fasta_rows(43, 11), 17, 0),
    "build_k41_n8": (lambda: _fasta_rows(44, 8), 41, 0),
    "build_k41_n11": (lambda: _fasta_rows(45, 11), 41, 0),
    "repeat_iupac": (_repeat_iupac, 7, 0),
    "fastq_mc1": (lambda: _fastq_rows(1), 17, 1),
    "fastq_mc2": (lambda: _fastq_rows(2), 17, 2),
    "fastq_mc3": (lambda: _fastq_rows(3), 17, 3),
    "mid_qual": (_mid_qual_rows, 17, 0),
    "skewed": (_skewed_rows, 17, 0),
    "two_keys": (_two_key_rows, 17, 0),
}


def _lookup_case(W):
    """Sorted unique keys, then queries: table keys (hits, duplicates),
    random keys (mostly misses), the smallest and largest keys, zero and
    a key above most."""
    rng = np.random.default_rng(42 + W)
    R, Q = 1000, 700
    keys = rng.integers(0, 1 << 60, size=(R + 200, W), dtype=np.uint64)
    keys = np.unique(keys, axis=0)[:R]
    qs = np.concatenate([
        keys[rng.integers(0, len(keys), size=Q // 2)],
        rng.integers(0, 1 << 60, size=(Q - Q // 2, W), dtype=np.uint64),
        keys[:1], keys[-1:], np.zeros((1, W), np.uint64),
        np.full((1, W), (1 << 60) - 1, np.uint64),
    ])
    return keys, qs


def _gram_case(name):
    """(variants, scratch bytes): one chunk, several chunks, and a pad
    that is a real class ('-' when every width slot is taken)."""
    alpha, shape, scratch = {
        "gram_one": (b"-ACGTRYSN", (5000, 6), TD.GRAM_SCRATCH_BYTES),
        "gram_many": (b"-ACGTN", (60000, 10), 1 << 16),
        "gram_pad": (b"-ACG", (3001, 5), TD.GRAM_SCRATCH_BYTES),
    }[name]
    rng = np.random.default_rng(len(name) + shape[1])
    letters = np.frombuffer(alpha, np.uint8)
    return letters[rng.integers(0, len(letters), size=shape)], scratch


GRAM_CASES = ("gram_one", "gram_many", "gram_pad")


def _write_fasta(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")
    return str(path)


def _write_fastq(path, reads):
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, q)
                         for i, (s, q) in enumerate(reads)))
    return str(path)


def _write_inputs(d):
    """The file cohorts of the file scenarios, under d; returns nothing
    (_files reads them back by name)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(17)
    for i, size in enumerate((600, 5000, 700)):  # oversized: 5000 > cap
        _write_fasta(os.path.join(d, f"m{i}.fa"), [(f"m{i}", rng.choice(ACGT, size))])
    rng = np.random.default_rng(23)
    ref = rng.choice(ACGT, size=2900 + 11 * 7)
    for i in range(24):  # three padded-length buckets, one exchange
        g = ref[: (600, 1500, 2900)[i % 3] + 11 * (i // 3)].copy()
        pos = rng.choice(len(g), size=5, replace=False)
        g[pos] = ACGT[(np.searchsorted(ACGT, g[pos]) + 1) % 4]
        _write_fasta(os.path.join(d, f"x{i}.fa"), [(f"x{i}", g)])
    rng = np.random.default_rng(31)
    ref = rng.choice(ACGT, size=8000)
    _write_fasta(os.path.join(d, "ref.fa"), [("ref", ref)])
    for i in range(4):  # map and distance end to end
        g = ref.copy()
        pos = rng.choice(len(g), size=80, replace=False)
        g[pos] = ACGT[(np.searchsorted(ACGT, g[pos]) + 1 + i % 3) % 4]
        _write_fasta(os.path.join(d, f"s{i}.fa"), [(f"s{i}", g)])
    rng = np.random.default_rng(41)
    base = rng.choice(ACGT, size=700)
    for s in range(3):  # read pairs, one over the cap of its scenario
        g = base.copy()
        g[rng.random(len(g)) < 0.01] = rng.choice(ACGT)
        for mate in (1, 2):
            reads = []
            for _ in range(120 if s != 1 else 300):
                a = int(rng.integers(0, len(g) - 80))
                r = g[a : a + 80].copy()
                r[rng.random(80) < 0.005] = ord("N")
                q = rng.integers(33 + 15, 33 + 41, size=80).astype(np.uint8)
                reads.append((r.tobytes(), q.tobytes()))
                if rng.random() < 0.2:
                    reads.append(reads[-1])
            _write_fastq(os.path.join(d, f"q{s}_{mate}.fastq"), reads)


def _files(d, scenario):
    """(name, path, path or None) input triples of a file scenario, and
    its k, QualOpts keyword arguments and extra environment."""
    fa = lambda p, n: [(f"{p}{i}", os.path.join(d, f"{p}{i}.fa"), None)  # noqa: E731
                       for i in range(n)]
    if scenario == "oversized":
        return fa("m", 3), 31, {}, {"SKA_MAX_CHUNK_BASES": "2048"}
    if scenario == "mixed":
        # 4 samples of the 1024 bucket a local call: several calls, one
        # exchange
        return fa("x", 24), 31, {}, {"SKA_MAX_HOST_BATCH_BYTES": "4096"}
    if scenario == "reads":
        return ([(f"q{s}", os.path.join(d, f"q{s}_1.fastq"),
                  os.path.join(d, f"q{s}_2.fastq")) for s in range(3)],
                17, dict(min_count=2, min_qual=20, qual_filter=2),
                {"SKA_MAX_CHUNK_BASES": "40000"})
    return fa("s", 4), 31, dict(min_count=0, min_qual=0, qual_filter=2), {}


FILE_CASES = ("oversized", "mixed", "reads")


class _env:
    """os.environ[name] = value for the block."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _arr_result(arr):
    return dict(keys=arr.keys, variants=arr.variants, counts=arr.counts,
                names=np.array(arr.names))


def _map_outputs(arr, ref, device="cpu"):
    """(aln bytes, VCF text, distance TSV text) of an array."""
    m, v, t = io.BytesIO(), io.StringIO(), io.StringIO()
    tapi.map_mode(_copy(arr), ref, m, fmt="aln", device=device)
    tapi.map_mode(_copy(arr), ref, v, fmt="vcf", device=device)
    tapi.distance_mode(_copy(arr), t, 0.0, True, device=device)
    return m.getvalue(), v.getvalue(), t.getvalue()


def _copy(arr):
    return SkaArray(k=arr.k, rc=arr.rc, names=list(arr.names),
                    keys=arr.keys.copy(), variants=arr.variants.copy(),
                    counts=arr.counts.copy())


# ---- what every rank runs --------------------------------------------


def _run_scenarios(d, out):
    """Every scenario on this rank; rank 0 writes out/<scenario>.npz."""
    D, rank = comm.world()
    results = {}
    from ska_tpu_torch.parallel import is_primary, use_distributed

    with _env(SKA_DISTRIBUTED="auto"):
        auto = (use_distributed("cpu"), use_distributed("cuda"))
    results["policy"] = dict(
        on=use_distributed("cpu"), auto_cpu=auto[0], auto_cuda=auto[1],
        primary=np.array(comm.all_gather_object(is_primary())))

    for name, (make, k, min_count) in BUILD_CASES.items():
        blocks = []
        merge = PB._merge_shard

        def spy(*a):
            out_ = merge(*a)
            blocks.append(len(out_[0]))
            return out_

        PB._merge_shard = spy
        c = make()
        try:
            if c["is_reads"]:
                keys, var, cnts, _ = PB.distributed_merged_build(
                    c["seqs"], c["valid"], c["qual"], c["rec_last"], k, True,
                    is_reads=True, use_mid_qual=c["use_mq"],
                    min_count=min_count, device="cpu")
            else:
                keys, var, cnts, _ = PB.distributed_build(
                    c["seqs"], c["valid"], c["rec_last"], k, True, device="cpu")
        finally:
            PB._merge_shard = merge
        results[name] = dict(keys=keys, variants=var, counts=cnts,
                             block_rows=np.array(comm.all_gather_object(blocks[0])))

    for W in (1, 2):
        keys, qs = _lookup_case(W)
        found, rows = PP.distributed_lookup(keys, qs, device="cpu")
        results[f"lookup_w{W}"] = dict(found=found, rows=rows)

    for name in GRAM_CASES:
        variants, scratch = _gram_case(name)
        saved, TD.GRAM_SCRATCH_BYTES = TD.GRAM_SCRATCH_BYTES, scratch
        try:
            results[name] = dict(G=PP.distributed_class_gram(variants, "cpu"))
        finally:
            TD.GRAM_SCRATCH_BYTES = saved

    for name in FILE_CASES:
        files, k, qual, env = _files(d, name)
        with _env(**env):
            batches = tsample.build_samples_distributed(
                files, k, True, QualOpts(**qual), device="cpu")
        results[name] = _arr_result(tapi.assemble(batches, k, True))
        results[name]["n_batches"] = len(batches)

    # dryrun_step through graft_entry, in place in the joined group
    from ska_tpu_torch.graft_entry import dryrun_multichip

    results["dryrun"] = dict(n_rows=dryrun_multichip(D, "cpu"))

    files, k, qual, _ = _files(d, "map")
    arr = tapi.build(files, k, True, QualOpts(**qual), device="cpu")
    ref = os.path.join(d, "ref.fa")
    aln, vcf, tsv = _map_outputs(arr, ref)
    from ska_tpu_torch.ref import RefSka

    kmers = RefSka(k, ref, True, False, False, device="cpu").kmers
    found, rows = PP.distributed_lookup(arr.sorted_view()[0], kmers, "cpu")
    results["map"] = dict(aln=np.frombuffer(aln, np.uint8),
                          vcf=np.array(vcf), tsv=np.array(tsv),
                          found=found, rows=rows, **_arr_result(arr))
    if rank == 0:
        for name, res in results.items():
            np.savez(os.path.join(out, f"{name}.npz"), **res)


def _rank_main(rank, world, port, d):
    import torch.distributed as dist

    from ska_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    os.environ["SKA_DISTRIBUTED"] = "1"
    assert init_multihost(f"localhost:{port}", world, rank, device="cpu",
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        _run_scenarios(os.path.join(d, "in"), os.path.join(d, f"w{world}"))
    finally:
        dist.destroy_process_group()


# ---- the tests ---------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_all(procs):
    """Wait for every process (each within TIMEOUT_S), kill leftovers;
    returns the failures as text."""
    failed = []
    try:
        for name, p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode:
                failed.append(f"{name}: exit {p.returncode}\n{err.decode()[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return failed


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run at once; returns the directory of their results."""
    d = str(tmp_path_factory.mktemp("worlds"))
    _write_inputs(os.path.join(d, "in"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        os.makedirs(os.path.join(d, f"w{world}"))
        port = _free_port()
        procs += [(f"world {world} rank {r}", subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), d], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)) for r in range(world)]
    failed = _wait_all(procs)
    assert not failed, "\n".join(failed)
    return d


def _result(worlds, world, name):
    with np.load(os.path.join(worlds, f"w{world}", f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _serial_port(call, k, min_count):
    """The port's serial merged build of one masks call, on the CPU."""
    W = 1 if k <= 31 else 2
    t = {n: torch.from_numpy(np.asarray(call[n]))
         for n in ("seqs", "valid", "qual", "rec_last")}
    ukeys, v4, _, n = TP._merged_impl(
        t["seqs"], t["valid"], t["qual"], t["rec_last"], k, True, W,
        bool(call["is_reads"]), bool(call["use_mq"]), min_count)
    n = int(n)
    var = TP.unpack_variants4(v4[:n].numpy(), len(call["seqs"]))
    return TK.to_numpy_keys(ukeys[:n]), var, (var != ord("-")).sum(axis=1)


def _jax_mesh(world):
    from ska_tpu.parallel import build_mesh

    return build_mesh(world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(BUILD_CASES))
def test_build_matches_serial_and_jax_mesh(worlds, world, name):
    from ska_tpu.parallel import build as JB

    make, k, min_count = BUILD_CASES[name]
    got = _result(worlds, world, name)
    want = _serial_port(make(), k, min_count)
    jax = JB.distributed_build_multi([make()], k, True, _jax_mesh(world),
                                     min_count=min_count)
    assert len(want[0]) > 0
    for g, w, j in zip((got["keys"], got["variants"], got["counts"]), want, jax):
        assert np.array_equal(g, w)
        assert np.array_equal(g, j)
    rows = got["block_rows"]
    assert rows.sum() == len(want[0]) and len(rows) == world
    if name == "two_keys":
        assert (rows == 0).sum() >= world - 2  # ranks with an empty bucket


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("W", [1, 2])
def test_lookup_matches_serial_and_jax_mesh(worlds, world, W):
    from ska_tpu.parallel.postbuild import distributed_lookup

    keys, qs = _lookup_case(W)
    got = _result(worlds, world, f"lookup_w{W}")
    table = TK.from_numpy_keys(keys)
    idx = TK.lower_bound(table, TK.from_numpy_keys(qs)).clamp(0, len(keys) - 1)
    found = TK.equal(table[idx], TK.from_numpy_keys(qs)).numpy()
    rows = np.where(found, idx.numpy(), -1)
    j_found, j_rows = distributed_lookup(keys, qs, _jax_mesh(world))
    assert 0 < found.sum() < len(qs)
    assert np.array_equal(got["found"], found) and np.array_equal(got["rows"], rows)
    assert np.array_equal(j_found, found) and np.array_equal(j_rows[found], rows[found])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", GRAM_CASES)
def test_class_gram_matches_serial_and_jax_mesh(worlds, world, name, monkeypatch):
    from ska_tpu.parallel.postbuild import distributed_class_gram

    variants, scratch = _gram_case(name)
    monkeypatch.setattr(TD, "GRAM_SCRATCH_BYTES", scratch)
    got = _result(worlds, world, name)["G"]
    assert got.dtype == np.int64
    assert np.array_equal(got, TD.class_gram(variants, "cpu"))
    assert np.array_equal(got, distributed_class_gram(variants, _jax_mesh(world)))


def _jax_build(files, k, qual, world, monkeypatch):
    """ska_tpu.api.build on the JAX package's mesh path over
    build_mesh(world)."""
    import ska_tpu.parallel as jpar
    from ska_tpu import api as japi
    from ska_tpu.sampletypes import QualOpts as JQual

    mesh = _jax_mesh(world)
    monkeypatch.setattr(jpar, "build_mesh", lambda: mesh)
    monkeypatch.setenv("SKA_DISTRIBUTED", "1")
    return japi.build(files, k, True, JQual(**qual))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", FILE_CASES)
def test_file_cohort_matches_serial_and_jax_mesh(worlds, world, name, monkeypatch):
    """Oversized samples (chunked, round robin over the ranks, host
    union), 24 samples in three length buckets staged in several calls
    through ONE exchange, and read pairs with the count filter and a
    chunked sample."""
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)
    files, k, qual, env = _files(os.path.join(worlds, "in"), name)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    got = _result(worlds, world, name)
    want = tapi.build(files, k, True, QualOpts(**qual), device="cpu")
    jax = _jax_build(files, k, qual, world, monkeypatch)
    assert got["names"].tolist() == want.names == jax.names
    for f in ("keys", "variants", "counts"):
        assert np.array_equal(got[f], getattr(want, f))
        assert np.array_equal(got[f], getattr(jax, f))
    n_big = {"oversized": 1, "mixed": 0, "reads": 1}[name]
    assert int(got["n_batches"]) == 1 + n_big


@pytest.mark.parametrize("world", WORLDS)
def test_map_and_distance_match_serial(worlds, world, monkeypatch):
    """api.build, map (aln, VCF) and distance in a process group: bytes of
    the serial port; the map's lookup rows those of the serial lookup and
    of the JAX package's mesh lookup."""
    from ska_tpu.parallel.postbuild import distributed_lookup
    from ska_tpu_torch.ref import RefSka

    for var, val in PIN.items():
        monkeypatch.setenv(var, val)
    d = os.path.join(worlds, "in")
    files, k, qual, _ = _files(d, "map")
    got = _result(worlds, world, "map")
    arr = tapi.build(files, k, True, QualOpts(**qual), device="cpu")
    assert np.array_equal(got["keys"], arr.keys)
    assert np.array_equal(got["variants"], arr.variants)
    aln, vcf, tsv = _map_outputs(arr, os.path.join(d, "ref.fa"))
    assert got["aln"].tobytes() == aln and len(aln) > 0
    assert str(got["vcf"]) == vcf and str(got["tsv"]) == tsv
    kmers = RefSka(k, os.path.join(d, "ref.fa"), True, False, False,
                   device="cpu").kmers
    sorted_keys = arr.sorted_view()[0]
    j_found, j_rows = distributed_lookup(sorted_keys, kmers, _jax_mesh(world))
    assert j_found.sum() > 0
    assert np.array_equal(got["found"], j_found)
    assert np.array_equal(got["rows"][j_found], j_rows[j_found])


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_step_matches_jax_mesh(worlds, world):
    """The port's dryrun_step (through graft_entry.dryrun_multichip in
    the joined group) against the JAX package's on a mesh of `world`
    virtual CPU devices: the same inputs, the same row count."""
    from ska_tpu.parallel import dryrun_step

    got = int(_result(worlds, world, "dryrun")["n_rows"])
    assert got == dryrun_step(world) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_policy_in_a_group(worlds, world):
    """SKA_DISTRIBUTED=1 is on in a group of several ranks, auto only for
    a card; rank 0 alone is primary."""
    got = _result(worlds, world, "policy")
    assert bool(got["on"]) and not bool(got["auto_cpu"]) and bool(got["auto_cuda"])
    assert got["primary"].tolist() == [True] + [False] * (world - 1)


def test_init_multihost_noop_without_config(monkeypatch):
    from ska_tpu_torch.parallel import init_multihost, is_primary

    for var in ("SKA_COORDINATOR", "SKA_NUM_PROCESSES", "SKA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost() is False
    assert init_multihost("localhost:1", num_processes=1, process_id=0) is False
    assert init_multihost("localhost:1", num_processes=2) is False  # no id
    assert is_primary() is True


@pytest.mark.parametrize("flag", ["0", "auto", "1"])
def test_use_distributed_reads_the_environment(monkeypatch, flag):
    """Without a group the policy is off under every flag, and it never
    asks CUDA."""
    from ska_tpu_torch.parallel import use_distributed

    def no_cuda(*a, **kw):
        raise AssertionError("use_distributed touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    monkeypatch.setenv("SKA_DISTRIBUTED", flag)
    assert use_distributed() is False
    assert use_distributed("cuda") is False


CLI_CMDS = ("build", "map", "distance", "align")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each command run by ./ska.py's code (ska_tpu.cli, pinned serial)
    into want/, and by two `python -m ska_tpu_torch` processes joined by
    SKA_COORDINATOR (gloo, SKA_DISTRIBUTED=1) into <cmd>/, the three
    pairs at once. Returns (directory, {cmd: output name})."""
    from ska_tpu import cli as jcli

    d = str(tmp_path_factory.mktemp("cli"))
    rng = np.random.default_rng(5)
    ref = rng.choice(ACGT, size=3000)
    fas = [_write_fasta(os.path.join(d, "ref.fa"), [("ref", ref)])]
    for i in range(3):
        g = ref.copy()
        g[rng.choice(3000, 40, replace=False)] = rng.choice(ACGT, 40)
        fas.append(_write_fasta(os.path.join(d, f"s{i}.fa"), [(f"s{i}", g)]))
    skf = os.path.join(d, "in.skf")
    argv = {
        "build": lambda o: ["build", "-k", "17", "-o", o, *fas[1:]],
        "map": lambda o: ["map", fas[0], skf, "-f", "vcf", "-o", o],
        "distance": lambda o: ["distance", skf, "-o", o],
        # FASTA files: align builds them first, a collective build
        "align": lambda o: ["align", *fas[1:], "-o", o],
    }
    out = {"build": "out.skf", "map": "out", "distance": "out", "align": "out"}
    saved = {var: os.environ.get(var) for var in PIN}
    os.environ.update(PIN)
    try:
        jcli.main(argv["build"](skf[:-4]))
        for cmd in CLI_CMDS:
            os.makedirs(os.path.join(d, "want", cmd))
            jcli.main(argv[cmd](os.path.join(d, "want", cmd, "out")))
    finally:
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var)
            else:
                os.environ[var] = val
    procs = []
    for cmd in CLI_CMDS:
        os.makedirs(os.path.join(d, cmd))
        env = dict(os.environ, PYTHONPATH=REPO, SKA_DISTRIBUTED="1",
                   SKA_COORDINATOR=f"localhost:{_free_port()}",
                   SKA_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
        procs += [(f"{cmd} rank {r}", subprocess.Popen(
            [sys.executable, "-m", "ska_tpu_torch",
             *argv[cmd](os.path.join(d, cmd, "out")), "--device", "cpu"],
            env=dict(env, SKA_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)) for r in range(2)]
    failed = _wait_all(procs)
    assert not failed, "\n".join(failed)
    return d, out


@pytest.mark.parametrize("cmd", CLI_CMDS)
def test_two_process_cli_matches_ska_py(cli_runs, cmd):
    """Rank 0 alone writes, and its bytes equal ./ska.py's pinned serial
    output."""
    d, out = cli_runs
    assert os.listdir(os.path.join(d, cmd)) == [out[cmd]]
    with open(os.path.join(d, cmd, out[cmd]), "rb") as a, \
            open(os.path.join(d, "want", cmd, out[cmd]), "rb") as b:
        assert a.read() == b.read()


# ---- batched_pipeline against the JAX package ---------------------------


@pytest.mark.parametrize("kind,k,min_count", [
    ("fasta", 17, 0), ("fasta", 41, 0), ("reads", 17, 1), ("reads", 17, 2),
    ("reads", 17, 3), ("reads", 41, 2), ("mid_qual", 17, 0), ("mid_qual", 41, 0),
])
def test_batched_pipeline_matches_jax(kind, k, min_count):
    """The local stage's per-sample pipelines, array for array."""
    import jax.numpy as jnp

    from ska_tpu.ops import pipeline as JP

    c = {"fasta": lambda: _fasta_rows(7, 3), "reads": lambda: _fastq_rows(min_count),
         "mid_qual": _mid_qual_rows}[kind]()
    W = 1 if k <= 31 else 2
    args = (k, True, W, bool(c["is_reads"]), bool(c["use_mq"]), min_count)
    names = ("seqs", "valid", "qual", "rec_last")
    want = JP.batched_pipeline(*(jnp.asarray(c[n]) for n in names), *args)
    got = TP.batched_pipeline(*(torch.from_numpy(c[n]) for n in names), *args)
    assert np.array_equal(TK.to_numpy_keys(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[3].sum()) > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
