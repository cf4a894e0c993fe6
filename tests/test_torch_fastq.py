"""The port's FASTQ build on the CPU, against the JAX package.

- ska_tpu_torch.api.build writes the same .skf bytes as ska_tpu.api.build
  for paired read sets (plain and .gz FASTQ with random qualities, Ns and
  reads that repeat) over counts, quality filters and k, for a single
  strand, for a cohort that mixes FASTA and FASTQ samples, for a
  FASTQ/FASTA mate pair, and with SKA_MAX_CHUNK_BASES forcing samples
  through the chunked build;
- the port's _stage_raw stages the arrays of the JAX package's, for
  FASTA rows, FASTQ rows with a record without qualities and a chunk's
  slice of a sample;
- the port's batched_from_raw (one row), chunk_count_pipeline and the
  reads branch of the merged build equal the JAX functions on the same
  numpy inputs (the merged build's on the JAX package's packed staging
  of the same batches), compared after unpacking (the JAX sorts there
  are unstable, so only what they fix is compared);
- a record-final window at a chunk boundary is still emitted.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_tpu import api as japi
from ska_tpu import sample as jsample
from ska_tpu.io import fastx as jfastx
from ska_tpu.io import skf
from ska_tpu.ops import pipeline as JP
from ska_tpu.sampletypes import QualOpts
from ska_tpu_torch import api as tapi
from ska_tpu_torch import sample as tsample
from ska_tpu_torch.ops import keys as TK
from ska_tpu_torch.ops import pipeline as TP

PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


def _genome(rng, n):
    return rng.choice(ACGT, size=n)


def _read_pairs(rng, genome, n_pairs, rlen, repeat=0.1):
    """Paired reads of fragments of 1.5-2.5 read lengths, from both
    strands, with 1% substitutions, a few Ns, PHRED+33 qualities mostly
    high with ~4% low bases, and ~`repeat` of the pairs repeated."""
    mates = ([], [])
    for _ in range(n_pairs):
        ins = int(rng.integers(3 * rlen // 2, 5 * rlen // 2))
        a = int(rng.integers(0, len(genome) - ins))
        frag = genome[a : a + ins]
        pair = [frag[:rlen].copy(), COMP[frag[-rlen:][::-1]]]
        if rng.random() < 0.5:
            pair = pair[::-1]
        for mate, r in zip(mates, pair):
            err = rng.random(rlen) < 0.01
            r[err] = rng.choice(ACGT, size=int(err.sum()))
            r[rng.random(rlen) < 0.003] = ord("N")
            q = rng.integers(33 + 25, 33 + 41, size=rlen).astype(np.uint8)
            q[rng.random(rlen) < 0.04] = 33 + int(rng.integers(2, 20))
            mate.append((r.tobytes(), q.tobytes()))
        if rng.random() < repeat:
            for mate in mates:
                mate.append(mate[-1])
    return mates


def _write_fastq(path, reads, gz=False):
    data = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, q)
                    for i, (s, q) in enumerate(reads))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)
    return str(path)


def _fastq_cohort(tmp_path, seed, n_samples=3, glen=700, n_pairs=120,
                  rlen=80):
    """Related samples as paired FASTQ; odd samples are gzipped."""
    rng = np.random.default_rng(seed)
    base = _genome(rng, glen)
    files = []
    for s in range(n_samples):
        g = base.copy()
        snp = rng.random(glen) < 0.01
        g[snp] = rng.choice(ACGT, size=int(snp.sum()))
        fwd, rev = _read_pairs(rng, g, n_pairs, rlen)
        ext = ".fastq.gz" if s % 2 else ".fastq"
        files.append((f"s{s}",
                      _write_fastq(tmp_path / f"s{s}_1{ext}", fwd, s % 2),
                      _write_fastq(tmp_path / f"s{s}_2{ext}", rev, s % 2)))
    return files


def _skf_bytes_equal(tmp_path, files, k, rc, qual):
    port = tapi.build(files, k, rc, qual, device="cpu")
    ref = japi.build(files, k, rc, qual)
    assert port.names == ref.names
    a = skf.save(port, str(tmp_path / "port"))
    b = skf.save(ref, str(tmp_path / "ref"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    return port


@pytest.mark.parametrize("k,min_count,qual_filter", [
    (7, 1, 2), (9, 2, 1), (9, 3, 0), (17, 5, 2), (63, 3, 2),
])
def test_api_build_fastq_matches_jax(tmp_path, k, min_count, qual_filter):
    files = _fastq_cohort(tmp_path, seed=k * 10 + min_count,
                          rlen=120 if k > 31 else 80)
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=qual_filter)
    port = _skf_bytes_equal(tmp_path, files, k, True, qual)
    assert port.ksize > 0


def test_api_build_fastq_single_strand_matches_jax(tmp_path):
    files = _fastq_cohort(tmp_path, seed=5)
    qual = QualOpts(min_count=2, min_qual=20, qual_filter=2)
    _skf_bytes_equal(tmp_path, files, 11, False, qual)


def test_api_build_mixed_fasta_fastq_cohort_matches_jax(tmp_path):
    """FASTA and FASTQ samples of one cohort build in separate groups,
    and api.build puts the columns back in input order."""
    files = _fastq_cohort(tmp_path, seed=6, n_samples=2)
    rng = np.random.default_rng(6)
    for s in range(2):
        p = tmp_path / f"a{s}.fa"
        p.write_bytes(b">c\n" + _genome(rng, 500 + 300 * s).tobytes() + b"\n")
        files.insert(2 * s, (f"a{s}", str(p), None))
    qual = QualOpts(min_count=2, min_qual=20, qual_filter=2)
    port = _skf_bytes_equal(tmp_path, files, 15, True, qual)
    assert port.names == ["a0", "s0", "a1", "s1"]


def test_api_build_fastq_fasta_mate_pair_matches_jax(tmp_path):
    """A pair that mixes a FASTQ with a FASTA mate: the mate's records
    carry quality bytes of 0xFF, which always pass."""
    files = _fastq_cohort(tmp_path, seed=7, n_samples=2)
    rng = np.random.default_rng(7)
    fa = tmp_path / "mate.fa"
    fa.write_bytes(b">m\n" + _genome(rng, 400).tobytes() + b"\n")
    files[1] = (files[1][0], files[1][1], str(fa))
    qual = QualOpts(min_count=1, min_qual=20, qual_filter=2)
    _skf_bytes_equal(tmp_path, files, 17, True, qual)


@pytest.mark.parametrize("input_kind,min_count", [
    ("fasta", 0), ("fastq", 0), ("fastq", 2), ("fastq", 3),
])
def test_api_build_chunked_matches_jax(tmp_path, monkeypatch, input_kind,
                                       min_count):
    """SKA_MAX_CHUNK_BASES=1024 sends the larger samples through the
    chunked build (dict_from_batch_chunked): the .skf equals JAX's under
    the same cap and the port's own unchunked build."""
    if input_kind == "fasta":
        rng = np.random.default_rng(11)
        files = []
        for s, n in enumerate((3000, 700, 2500)):
            g = _genome(rng, n)
            g[rng.choice(n, 10, replace=False)] = ord("N")
            p = tmp_path / f"c{s}.fa"
            p.write_bytes(b">c\n" + g[: n // 2].tobytes() + b"\n>d\n"
                          + g[n // 2 :].tobytes() + b"\n")
            files.append((f"c{s}", str(p), None))
    else:
        files = _fastq_cohort(tmp_path, seed=12 + min_count, n_samples=2,
                              n_pairs=60)
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=2)
    whole = tapi.build(files, 17, True, qual, device="cpu")
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", "1024")
    port = _skf_bytes_equal(tmp_path, files, 17, True, qual)
    assert np.array_equal(port.keys, whole.keys)
    assert np.array_equal(port.variants, whole.variants)


def test_chunked_build_steps_are_profiler_spans(tmp_path, monkeypatch):
    """The chunked build's device calls run inside the same ska:: spans
    as the merged build's (chip_smoke.py's profile reads them)."""
    from torch.profiler import ProfilerActivity, profile

    from ska_tpu_torch import cli

    files = _fastq_cohort(tmp_path, seed=8, n_samples=2, n_pairs=40)
    tsv = tmp_path / "s.tsv"
    tsv.write_text("".join("\t".join(f) + "\n" for f in files))
    argv = ["build", "-f", str(tsv), "-k", "17", "--min-count", "2", "-o",
            str(tmp_path / "p"), "--device", "cpu"]

    def spans():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cli.main(argv)
        # a library built at first use (ska::compile) is no step of the build
        return [e.name for e in prof.events()
                if e.name.startswith("ska::") and e.name != "ska::compile"]

    whole = spans()
    assert "ska::chunk_merge" not in whole
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", "4096")
    chunked = spans()
    steps = ("command", "parse", "stage", "to_device", "device_pass",
             "to_host", "chunk_merge", "union", "save")
    assert set(chunked) == {f"ska::{s}" for s in steps}
    assert chunked.count("ska::device_pass") >= 2 * 2  # one per chunk
    assert chunked.count("ska::chunk_merge") == 2  # one per chunked sample


@pytest.mark.parametrize("min_count", [5, 0])
def test_chunk_counters(tmp_path, monkeypatch, min_count):
    """chunk_counts() holds the chunked samples, the chunks the build cut
    and the rows those chunks handed to the host merge; a sample under
    the cap counts nothing, and reset_launch_counts zeroes them."""
    from ska_tpu_torch import torchinit

    rng = np.random.default_rng(9)
    files = []
    # small: ~10x of 300 bases, under the cap
    for name, glen, n_pairs in (("big", 700, 80), ("small", 300, 20)):
        fwd, rev = _read_pairs(rng, _genome(rng, glen), n_pairs, 80)
        files.append((name, _write_fastq(tmp_path / f"{name}_1.fastq", fwd),
                      _write_fastq(tmp_path / f"{name}_2.fastq", rev)))
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=2)
    cap, k = 4096, 17
    batch, is_reads = tsample.prepare_sample(files[0][1:])
    valid = tsample._masks(batch, qual, is_reads)
    n_chunks = len(list(tsample._chunk_views(batch, k, cap, valid)))
    handed = []  # rows of each chunk's device compaction
    rows_to_host = TP.rows_to_host

    def counted(sel, *xs):
        out = rows_to_host(sel, *xs)
        handed.append(len(out[0][0]))
        return out

    monkeypatch.setattr(TP, "rows_to_host", counted)
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    torchinit.reset_launch_counts()
    tapi.build(files, k, True, qual, device="cpu")
    assert n_chunks >= 3 and len(handed) == n_chunks
    # whole key, count (int32), packed split pair; or split pair, set
    row_bytes = 16 + 4 if min_count > 1 else 8 + 1
    assert torchinit.chunk_counts() == {
        "chunked_samples": 1, "chunks": n_chunks, "chunk_rows": sum(handed),
        "chunk_copy_bytes": sum(handed) * row_bytes}
    torchinit.reset_launch_counts()
    assert torchinit.chunk_counts() == {
        "chunked_samples": 0, "chunks": 0, "chunk_rows": 0,
        "chunk_copy_bytes": 0}


@pytest.mark.parametrize("min_count", [5, 0])
def test_chunk_copies_only_kept_rows(tmp_path, monkeypatch, min_count):
    """A chunked build turns no padded chunk output into a host array:
    every tensor that reaches numpy has fewer rows than a chunk's padded
    length, and together they are the bytes chunk_copy_bytes counts."""
    from ska_tpu_torch import torchinit

    rng = np.random.default_rng(21)
    fwd, rev = _read_pairs(rng, _genome(rng, 700), 80, 80)
    files = [("big", _write_fastq(tmp_path / "big_1.fastq", fwd),
              _write_fastq(tmp_path / "big_2.fastq", rev))]
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=2)
    cap, k = 4096, 17
    Lp = tsample._bucket(cap + k + 1)
    sizes = []  # (rows, bytes) of every tensor turned into a numpy array
    numpy = torch.Tensor.numpy

    def recorded(t, *args, **kwargs):
        sizes.append((len(t) if t.dim() else 1, t.numel() * t.element_size()))
        return numpy(t, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "numpy", recorded)
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    torchinit.reset_launch_counts()
    tapi.build(files, k, True, qual, device="cpu")
    got = torchinit.chunk_counts()
    assert got["chunks"] >= 3 and got["chunk_rows"] > 0
    assert max(rows for rows, _ in sizes) < Lp
    assert sum(nbytes for _, nbytes in sizes) == got["chunk_copy_bytes"]


def _planted_pair(tmp_path, rng):
    """A read pair of a 3 kb genome at ~27x, with two 60-base segments
    that the genome lacks planted in whole high-quality reads of the
    forward file, spread evenly over it: `kept` 6 times and `dropped` 4
    times. Returns (fwd, rev, kept, dropped)."""
    fwd, rev = _read_pairs(rng, _genome(rng, 3000), 400, 100, repeat=0)
    kept, dropped = _genome(rng, 60), _genome(rng, 60)
    for seg, n in ((kept, 6), (dropped, 4)):
        for j in range(n):
            read = np.concatenate([_genome(rng, 20), seg, _genome(rng, 20)])
            at = (2 * j + 1) * len(fwd) // (2 * n)
            fwd.insert(at, (read.tobytes(), b"I" * len(read)))
            rev.insert(at, rev[at])  # its mate: a copy of a genome read
    return (_write_fastq(tmp_path / "p_1.fastq", fwd),
            _write_fastq(tmp_path / "p_2.fastq", rev), kept, dropped)


@pytest.mark.parametrize("k", [17, 31])
def test_chunked_count_build_matches_plain_reference(tmp_path, monkeypatch,
                                                     k):
    """A read pair cut into at least three chunks builds, under
    --min-count 5 and the strict filter, the .skf that the benchmark's
    plain reference (skabench/reference) works out from the same files:
    a whole k-mer seen 6 times, never 5 times in one chunk, is kept, and
    one seen 4 times is dropped."""
    from ska_tpu_torch import torchinit
    from ska_tpu_torch.io import skf as tskf
    from skabench.reference import build as reference
    from skabench.reference import kmers as R

    fwd, rev, kept, dropped = _planted_pair(tmp_path,
                                            np.random.default_rng(k))
    cap = 16384
    batch, is_reads = tsample.prepare_sample((fwd, rev))
    qual = QualOpts(min_count=5, min_qual=20, qual_filter=2)
    valid = tsample._masks(batch, qual, is_reads)
    views = list(tsample._chunk_views(batch, k, cap, valid))
    assert len(views) >= 3
    for seg, total in ((kept, 6), (dropped, 4)):
        # each of seg's windows: in how many reads of each chunk
        per_chunk = [[batch.seq[a:end].tobytes().count(seg[i:i + k].tobytes())
                      for i in range(len(seg) - k + 1)]
                     for a, _, end in views]
        assert np.array_equal(np.sum(per_chunk, axis=0),
                              [total] * (len(seg) - k + 1))
        assert np.max(per_chunk) < 5

    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    torchinit.reset_launch_counts()
    arr = tapi.build([("p", fwd, rev)], k, True, qual, device="cpu")
    assert torchinit.chunk_counts()["chunks"] == len(views)
    path = tskf.save(arr, str(tmp_path / "port"))
    cfg = {"build": {"k": k, "rc": True, "min_qual": 20,
                     "qual_filter": "strict", "min_count": 5}}
    exp = reference.expected(cfg, {"samples": [("p", fwd, rev)]})
    assert reference.compare(exp, path) == {
        "skf_unreadable": 0, "header_differing": 0, "rows_unsorted": 0,
        "rows_differing": 0}
    got = arr.keys[:, 0]
    assert np.isin(R.sample_dict([kept], k)[0], got).all()
    assert not np.isin(R.sample_dict([dropped], k)[0], got).any()


def test_chunked_boundary_on_record_final_window():
    """A record whose final (roll-only) window starts exactly at a chunk
    boundary is still emitted: the boundary nudges forward so that the
    emission rule sees the previous base's validity. The chunked build
    must equal the JAX package's unchunked and chunked builds."""
    k, cap = 9, 64
    step = cap - (k - 1)
    rng = np.random.default_rng(2)
    rec = _genome(rng, step + k)  # final window starts at `step`
    batch = tsample.fastx.build_batch([rec.tobytes()])
    views = list(tsample._chunk_views(batch, k, cap, np.ones(len(rec), bool)))
    assert views[0][1] == step + 1  # nudged past the final window
    got = tsample.dict_from_batch_chunked(batch, k, True, QualOpts(), False,
                                          cap, device="cpu")
    jbatch = jfastx.build_batch([rec.tobytes()])
    whole = jsample.dict_from_batch(jbatch, k, True, QualOpts(), False)
    chunked = jsample.dict_from_batch_chunked(jbatch, k, True, QualOpts(),
                                              False, cap)
    for g, w, c in zip(got, whole, chunked):
        assert np.array_equal(g, w) and np.array_equal(g, c)


# ---- the per-sample pipelines on the same numpy inputs ----------------


def _reads_batch(seed, rlen=60, n_pairs=50, glen=300):
    rng = np.random.default_rng(seed)
    fwd, rev = _read_pairs(rng, _genome(rng, glen), n_pairs, rlen)
    seqs, quals = zip(*(fwd + rev))
    return jfastx.build_batch(list(seqs), list(quals))


def _raw_inputs(batch, k, qual):
    """The JAX package's raw staging of one sample, as numpy arrays."""
    Lp = jsample._bucket(len(batch.seq) + k + 1)
    seqs, qual_bits, rec_ends, has_qual = jsample._stage_raw(
        [batch], Lp, qual.min_qual)
    return seqs[0], qual_bits[0], rec_ends[0], has_qual


def _records(seed, fasta=False):
    """(sequences, qualities) of a FASTQ sample whose last record has no
    qualities, or FASTA records of unequal lengths (qualities None)."""
    rng = np.random.default_rng(seed)
    fwd, rev = _read_pairs(rng, _genome(rng, 400), 30, 70)
    if fasta:
        return [s[: 40 + 7 * i] for i, (s, _) in enumerate(fwd)], None
    seqs, quals = map(list, zip(*(fwd + rev)))
    quals[-1] = None  # staged as 0xFF, which always passes
    return seqs, quals


@pytest.mark.parametrize("case,min_qual", [
    ("fasta", 20), ("fastq_mixed", 20), ("fastq_mixed", -40),
    ("fastq_mixed", 300), ("chunk_slice", 25),
])
def test_stage_raw_matches_jax(case, min_qual):
    """The port's _stage_raw gives the JAX package's arrays: FASTA rows of
    unequal lengths (no quality bits), FASTQ rows with a record without
    qualities at thresholds inside and past the PHRED range, and a
    one-row slice [a, end) of a FASTQ sample at a _chunk_views boundary,
    as the chunked build and `cov` stage it."""
    k = 17
    if case == "fasta":
        recs = [_records(s, fasta=True) for s in range(3)]
        tb = [tsample.fastx.build_batch(r[0][: 3 + s], [None] * (3 + s))
              for s, r in enumerate(recs)]
        jb = [jfastx.build_batch(r[0][: 3 + s], [None] * (3 + s))
              for s, r in enumerate(recs)]
    else:
        tb, jb = [], []
        for s in range(1 if case == "chunk_slice" else 2):
            seqs, quals = _records(10 + s)
            tb.append(tsample.fastx.build_batch(seqs, quals))
            jb.append(jfastx.build_batch(seqs, quals))
    Lp = jsample._bucket(max(len(b.seq) for b in jb) + k + 1)
    if case == "chunk_slice":
        cap = 2048
        qual = QualOpts(min_count=5, min_qual=min_qual, qual_filter=2)
        valid = tsample._masks(tb[0], qual, True)
        views = list(tsample._chunk_views(tb[0], k, cap, valid))
        assert len(views) >= 3
        a, _, end = views[1]
        tb = [tb[0].slice(a, end)]
        j = jb[0]
        jb = [jfastx.SeqBatch(seq=j.seq[a:end], qual=j.qual[a:end],
                              rec_last=j.rec_last[a:end],
                              has_qual=j.has_qual, n_records=tb[0].n_records)]
        Lp = jsample._bucket(cap + k + 1)
    got = tsample._stage_raw(tb, Lp, min_qual)
    want = jsample._stage_raw(jb, Lp, min_qual)
    assert got[3] == want[3] == (case != "fasta")
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _gates(qual):
    return qual.qual_filter in (1, 2), qual.qual_filter == 2


@pytest.mark.parametrize("k,min_count,qual_filter", [
    (9, 0, 2), (9, 2, 1), (15, 3, 2), (33, 2, 0),
])
def test_sample_pipeline_matches_jax(k, min_count, qual_filter):
    W = 1 if k <= 31 else 2
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=qual_filter)
    seq, qb, ends, has_qual = _raw_inputs(_reads_batch(k), k, qual)
    use_mq, strict = _gates(qual)
    args = (k, True, W, True, use_mq, min_count, strict, has_qual)
    want = JP.sample_from_raw(jnp.asarray(seq), jnp.asarray(qb),
                              jnp.asarray(ends), *args)
    got = [x[0] for x in TP.batched_from_raw(
        torch.from_numpy(seq[None]), torch.from_numpy(qb[None]),
        torch.from_numpy(ends[None]), *args)]
    wk, ws = JP.unpack_host(*want[:3], W)
    gk, gs = TP.unpack_host(TK.to_numpy_keys(got[0]), got[1].numpy(),
                            got[2].numpy(), W)
    assert len(wk) > 0 and int(got[3]) == int(want[3]) == len(wk)
    assert np.array_equal(gk, wk) and np.array_equal(gs, ws)
    # the chunked build's compaction on the device: the same rows
    dk, ds, nbytes = TP.dict_to_host(*got[:3])
    assert dk.dtype == np.uint64 and ds.dtype == np.uint8
    assert np.array_equal(dk, wk) and np.array_equal(ds, ws)
    assert nbytes == len(wk) * (8 * W + 1)


@pytest.mark.parametrize("k,qual_filter", [(9, 2), (17, 1), (35, 0)])
def test_chunk_count_pipeline_matches_jax(k, qual_filter):
    W = 1 if k <= 31 else 2
    qual = QualOpts(min_count=2, min_qual=20, qual_filter=qual_filter)
    seq, qb, ends, has_qual = _raw_inputs(_reads_batch(k + 1), k, qual)
    use_mq, strict = _gates(qual)
    args = (k, True, W, use_mq, strict, has_qual)
    want = JP.chunk_count_from_raw(jnp.asarray(seq), jnp.asarray(qb),
                                   jnp.asarray(ends), *args)
    got = TP.chunk_count_from_raw(torch.from_numpy(seq), torch.from_numpy(qb),
                                  torch.from_numpy(ends), *args)
    w = JP.unpack_chunk_counts(*want[:4], W)
    *g, nbytes = TP.chunk_counts_to_host(*got[:4])
    assert int(got[4]) == int(want[4]) == len(w[0]) > 0
    assert w[1].max() > 1  # some whole k-mers occur more than once
    for a, b in zip(g, w):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    assert nbytes == len(w[0]) * (16 * W + 4)


@pytest.mark.parametrize("S,k,min_count,qual_filter", [
    (1, 9, 3, 2), (2, 11, 2, 1), (3, 31, 5, 2), (2, 45, 2, 0), (2, 13, 1, 1),
])
def test_merged_reads_branch_matches_jax(S, k, min_count, qual_filter):
    """merged_build_from_raw with is_reads, on the JAX package's raw
    staging, against its merged_build_from_packed on its packed staging
    of the same batches: quality bits, strict validity, the middle-base
    gate and the per-sample rank filter."""
    W = 1 if k <= 31 else 2
    qual = QualOpts(min_count=min_count, min_qual=20, qual_filter=qual_filter)
    batches = [_reads_batch(100 * S + k + s, n_pairs=80) for s in range(S)]
    Lp = jsample._bucket(max(len(b.seq) for b in batches) + k + 1)
    packed = jsample._stage_packed(batches, Lp, qual.min_qual)
    raw = jsample._stage_raw(batches, Lp, qual.min_qual)
    use_mq, strict = _gates(qual)
    args = (k, True, W, True, use_mq, min_count, strict, raw[3])
    want = JP.merged_build_from_packed(*(jnp.asarray(x) for x in packed[:4]),
                                       *args)
    got = TP.merged_build_from_raw(*(torch.from_numpy(x) for x in raw[:3]),
                                   *args)
    n = int(np.asarray(want[3]))
    assert n > 0 and int(got[3]) == n
    assert np.array_equal(TK.to_numpy_keys(got[0][:n]), np.asarray(want[0])[:n])
    assert np.array_equal(got[1][:n].numpy(), np.asarray(want[1])[:n])
    assert np.array_equal(got[2][:n].numpy(), np.asarray(want[2])[:n])


def test_cli_proportion_reads_matches_ska_py(tmp_path):
    """`build -k 17 --min-count 2 --proportion-reads 0.5` of three FASTQ
    pairs: every second read of each file, the .skf bytes of ./ska.py's
    (ska_tpu.cli, pinned to its JAX pipeline)."""
    from ska_tpu import cli as jcli
    from ska_tpu_torch import cli as tcli

    files = _fastq_cohort(tmp_path, seed=21, n_samples=3)
    tsv = tmp_path / "samples.tsv"
    tsv.write_text("".join("\t".join(f) + "\n" for f in files))
    argv = ["build", "-f", str(tsv), "-k", "17", "--min-count", "2",
            "--proportion-reads", "0.5", "-o"]
    tcli.main(argv + [str(tmp_path / "port"), "--device", "cpu"])
    jcli.main(argv + [str(tmp_path / "ref")])
    port = (tmp_path / "port.skf").read_bytes()
    assert port == (tmp_path / "ref.skf").read_bytes()
    # the proportion took effect: all the reads give another array
    tcli.main(argv[:-3] + ["-o", str(tmp_path / "all"), "--device", "cpu"])
    assert (tmp_path / "all.skf").read_bytes() != port
