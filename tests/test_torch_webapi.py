"""The port's front ends on the CPU, against the JAX package.

- the per-sample build path that only the in-memory API calls:
  ops/pipeline.py ``batched_from_raw`` and ``merged_build_pipeline``,
  sample.py ``dict_from_batch`` (also over SKA_MAX_CHUNK_BASES),
  ``build_sample`` and ``build_samples`` (mixed FASTA and FASTQ, two
  length buckets, batches smaller than a group, proportion_reads), and
  merge.py ``merge_samples``: arrays equal, error messages equal;
- webapi.py: ``neighbor_joining`` on random matrices and the file-name
  helpers; ``SkaData.map`` (a two-record reference, repeated maps, a gz
  FASTQ pair, k=41) and ``get_reference``; ``AlignData.align`` on the
  merged build and the class Gram (too few samples, FASTA at k=17, 31,
  41 and 63, the build cache across calls, a two-call session with
  subsampled pairs, FASTQ pairing, an all-N file's error): the JSON
  strings equal; ``snp_distances`` against a direct pairwise count,
  the Gram's tail padding included;
- graft_entry.py: ``entry()``'s step equal to ``__graft_entry__``'s on
  the same arrays, ``dryrun_multichip`` on two gloo ranks returning the
  JAX ``dryrun_step``'s row count; with no ``device=`` every entry point
  asks for the card and raises here.

Inputs are written to tmp_path from numpy seeds. The JAX side is pinned
to its device pipeline (SKA_NATIVE_BUILD=0 SKA_NATIVE_CMDS=0
SKA_DISTRIBUTED=0). Every comparison is exact.
"""

import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from ska_tpu import merge as jmerge
from ska_tpu import sample as jsample
from ska_tpu import webapi as jweb
from ska_tpu.ops import pipeline as JP
from ska_tpu.sampletypes import QualOpts as JQual
from ska_tpu.sampletypes import SampleDict as JSampleDict
from ska_tpu_torch import graft_entry as tentry
from ska_tpu_torch import merge as tmerge
from ska_tpu_torch import sample as tsample
from ska_tpu_torch import webapi as tweb
from ska_tpu_torch.constants import QUAL_MIDDLE, QUAL_NOFILTER, QUAL_STRICT
from ska_tpu_torch.ops import keys as TK
from ska_tpu_torch.ops import pipeline as TP
from ska_tpu_torch.sampletypes import QualOpts as TQual
from ska_tpu_torch.sampletypes import SampleDict as TSampleDict

PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGTN")] = list(b"TGCAN")
CHROM, PLASMID = 2600, 400


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


# ---- inputs ---------------------------------------------------------------


def _mutate(rng, g, n_snps):
    g = g.copy()
    pos = rng.choice(len(g), n_snps, replace=False)
    g[pos] = rng.choice(ACGT, n_snps)
    return g


def _write_fasta(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name + b"\n" + bytes(seq) + b"\n")


def _write_pair(rng, genome, prefix, n_pairs=160, rlen=75, gz=False):
    """Paired reads of genome, both strands, 1% substitutions, PHRED+33
    qualities with ~5% low bases; returns the two paths."""
    mates = ([], [])
    for _ in range(n_pairs):
        ins = int(rng.integers(2 * rlen, 3 * rlen))
        a = int(rng.integers(0, len(genome) - ins))
        frag = genome[a : a + ins]
        pair = [frag[:rlen].copy(), COMP[frag[-rlen:][::-1]]]
        if rng.random() < 0.5:
            pair.reverse()
        for m, r in zip(mates, pair):
            err = rng.random(rlen) < 0.01
            r[err] = rng.choice(ACGT, int(err.sum()))
            q = rng.integers(53, 74, rlen).astype(np.uint8)
            q[rng.random(rlen) < 0.05] = 40
            m.append((r, q))
    paths = []
    for i, m in enumerate(mates, 1):
        path = f"{prefix}_{i}.fastq" + (".gz" if gz else "")
        body = b"".join(b"@r%d\n%s\n+\n%s\n" % (j, bytes(r), bytes(q))
                        for j, (r, q) in enumerate(m))
        with (gzip.open if gz else open)(path, "wb") as f:
            f.write(body)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A two-record reference, five FASTA samples (SNPs, an N run, IUPAC
    and lowercase letters, one short one in another length bucket), three
    read pairs (one gzipped) and an all-N sample."""
    d = tmp_path_factory.mktemp("webapi")
    rng = np.random.default_rng(2024)
    chrom, plasmid = rng.choice(ACGT, CHROM), rng.choice(ACGT, PLASMID)
    ref = str(d / "ref.fa")
    _write_fasta(ref, [(b"chrom desc", chrom), (b"plasmid", plasmid)])
    out = {"ref": ref, "fasta": [], "pairs": []}
    genomes = []
    for s in range(5):
        g = _mutate(rng, np.concatenate([chrom, plasmid]), 30)
        genomes.append(g)
        if s == 1:
            g[700:720] = ord("N")
            g[900] = ord("R")
            g[1500:1560] = np.frombuffer(bytes(g[1500:1560]).lower(), np.uint8)
        if s == 4:
            g = g[:900]  # another length bucket
        path = str(d / f"sample{s}.fa")
        _write_fasta(path, [(b"s%d_chrom" % s, g[:CHROM]),
                            (b"s%d_plasmid" % s, g[CHROM:])])
        out["fasta"].append(path)
    for s in range(3):
        out["pairs"].append(_write_pair(rng, genomes[s], str(d / f"reads{s}"),
                                        gz=s == 0))
    out["empty"] = str(d / "empty.fa")
    _write_fasta(out["empty"], [(b"nothing", np.full(200, ord("N"), np.uint8))])
    return out


def _quals(**kw):
    return JQual(**kw), TQual(**kw)


def _eq_pairs(a, b):
    assert len(a) == len(b)
    for (ka, sa), (kb, sb) in zip(a, b):
        assert ka.dtype == kb.dtype == np.uint64 and np.array_equal(ka, kb)
        assert np.array_equal(sa, sb)


def _eq_dicts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.name, x.k, x.rc) == (y.name, y.k, y.rc)
        assert np.array_equal(x.keys, y.keys) and np.array_equal(x.sets, y.sets)


# ---- the per-sample build path ---------------------------------------------


@pytest.mark.parametrize("case", ["fasta_k17", "fasta_k41", "reads_k31_mc2"])
def test_batched_from_raw_matches_jax(cohort, case):
    reads = case.startswith("reads")
    k = int(case.split("_")[1][1:])
    W = 1 if k <= 31 else 2
    jq, tq = _quals(min_count=2 if reads else 1, min_qual=20,
                    qual_filter=QUAL_STRICT)
    files = ([(p[0], p[1]) for p in cohort["pairs"]] if reads
             else [(f, None) for f in cohort["fasta"][:4]])
    batches = [tsample.prepare_sample(f)[0] for f in files]
    Lp = tsample._bucket(max(len(b.seq) for b in batches) + k + 1)
    seqs, qbits, ends, has_qual = tsample._stage_raw(batches, Lp, 20)
    use_mq, strict = tsample._gates(reads, has_qual, tq)
    cfg = (k, True, W, reads, use_mq, int(tq.min_count), strict, has_qual)
    got = TP.batched_from_raw(*(torch.from_numpy(x) for x in (seqs, qbits, ends)),
                              *cfg)
    want = JP.batched_from_raw(*(jnp.asarray(x) for x in (seqs, qbits, ends)),
                               *cfg)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    sp = TK.to_numpy_keys(got[0])
    wsp = [np.asarray(x) for x in want[:3]]
    _eq_pairs([TP.unpack_host(sp[i], got[1][i].numpy(), got[2][i].numpy(), W)
               for i in range(len(batches))],
              [JP.unpack_host(wsp[0][i], wsp[1][i], wsp[2][i], W)
               for i in range(len(batches))])


@pytest.mark.parametrize("cap", [None, 2000])
def test_dict_from_batch_matches_jax(cohort, monkeypatch, cap):
    if cap:
        monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    jq, tq = _quals(min_count=1, min_qual=0, qual_filter=QUAL_NOFILTER)
    for files, reads in (((cohort["fasta"][1], None), False),
                         (tuple(cohort["pairs"][1]), True)):
        jb, _ = jsample.prepare_sample(files)
        tb, _ = tsample.prepare_sample(files)
        _eq_pairs([tsample.dict_from_batch(tb, 17, True, tq, reads, "cpu")],
                  [jsample.dict_from_batch(jb, 17, True, jq, reads)])


@pytest.mark.parametrize("kind", ["fasta", "fastq_gz"])
def test_build_sample_matches_jax(cohort, kind):
    files = ((cohort["fasta"][0], None) if kind == "fasta"
             else tuple(cohort["pairs"][0]))
    jq, tq = _quals(min_count=1, min_qual=0, qual_filter=QUAL_NOFILTER)
    got = tsample.build_sample("s", 31, files, True, tq, device="cpu")
    want = jsample.build_sample("s", 31, files, True, jq)
    _eq_dicts([got], [want])


@pytest.mark.parametrize("max_batch,proportion,cap",
                         [(8, None, None), (2, 0.5, None), (8, None, 5000)])
def test_build_samples_matches_jax(cohort, monkeypatch, max_batch, proportion,
                                   cap):
    """FASTA of two length buckets and FASTQ pairs in one call, with
    batches smaller than a group, subsampled reads, and the read pairs
    over SKA_MAX_CHUNK_BASES (the port builds them chunked, the JAX
    package in one dispatch: the same dictionaries)."""
    if cap:
        monkeypatch.setenv("SKA_MAX_CHUNK_BASES", str(cap))
    inputs = [(f"f{i}", f, None) for i, f in enumerate(cohort["fasta"])]
    inputs[2:2] = [(f"r{i}", a, b) for i, (a, b) in enumerate(cohort["pairs"])]
    jq, tq = _quals(min_count=2, min_qual=20, qual_filter=QUAL_MIDDLE)
    got = tsample.build_samples(inputs, 21, True, tq, proportion, max_batch,
                                device="cpu")
    want = jsample.build_samples(inputs, 21, True, jq, proportion, max_batch)
    _eq_dicts(got, want)


@pytest.mark.parametrize("fn", ["build_sample", "build_samples"])
def test_no_valid_sequence_message_matches_jax(cohort, fn):
    jq, tq = _quals(min_count=1)
    inputs = [("a", cohort["fasta"][0], None), ("e", cohort["empty"], None)]

    def call(mod, qual, **kw):
        if fn == "build_sample":
            return mod.build_sample("e", 17, (cohort["empty"], None), True,
                                    qual, **kw)
        return mod.build_samples(inputs, 17, True, qual, **kw)

    with pytest.raises(ValueError) as want:
        call(jsample, jq)
    with pytest.raises(ValueError) as got:
        call(tsample, tq, device="cpu")
    assert str(got.value) == str(want.value)
    assert "has no valid sequence" in str(got.value)


def _dict_pair(name, k, rc, keys, sets):
    return (JSampleDict(name, k, rc, keys, sets),
            TSampleDict(name, k, rc, keys.copy(), sets.copy()))


@pytest.mark.parametrize("W", [1, 2])
def test_merge_samples_matches_jax(W):
    rng = np.random.default_rng(W)
    pool = rng.integers(0, 1 << 60, size=(40, W), dtype=np.uint64)
    pairs = []
    for s in range(4):
        keys = pool[np.sort(rng.choice(40, 25, replace=False))]
        sets = rng.integers(1, 16, 25).astype(np.uint8)
        pairs.append(_dict_pair(f"s{s}", 17 if W == 1 else 41, True, keys, sets))
    got = tmerge.merge_samples([t for _, t in pairs])
    want = jmerge.merge_samples([j for j, _ in pairs])
    assert (got.k, got.rc, got.names) == (want.k, want.rc, want.names)
    for a in ("keys", "variants", "counts"):
        x, y = getattr(got, a), getattr(want, a)
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("case", ["none", "k", "strand"])
def test_merge_samples_errors_match_jax(case):
    keys = np.arange(3, dtype=np.uint64)[:, None]
    sets = np.ones(3, np.uint8)
    pairs = [] if case == "none" else [_dict_pair("a", 17, True, keys, sets)]
    if case != "none":
        pairs.append(_dict_pair("b", 19 if case == "k" else 17,
                                case != "strand", keys, sets))
    with pytest.raises(ValueError) as want:
        jmerge.merge_samples([j for j, _ in pairs])
    with pytest.raises(ValueError) as got:
        tmerge.merge_samples([t for _, t in pairs])
    assert str(got.value) == str(want.value)


# ---- webapi ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 12])
def test_neighbor_joining_matches_jax(n):
    rng = np.random.default_rng(n)
    D = rng.integers(0, 40, (n, n)).astype(np.float64)
    D = np.triu(D, 1) + np.triu(D, 1).T
    if n > 4:
        D[1, 2] = D[2, 1] = D[0, 3] = D[3, 0] = 0  # ties in Q
    names = [f"t{i}" for i in range(n)]
    assert tweb.neighbor_joining(D, names) == jweb.neighbor_joining(D, names)
    assert tweb.neighbor_joining(D.astype(np.int64), names) == \
        jweb.neighbor_joining(D.astype(np.int64), names)


def test_helpers_match_jax():
    names = ["x.fastq.gz", "x.fq", "x.fa.gz", "x.fasta", "gz", "a.b.fq.gz",
             "my sample.fasta", "r_1.fastq.gz", "reads_1.fq", "reads_2.fq",
             "s0_R1.fastq.gz", "s0_R2.fastq.gz", "a_1.fq", "ab_2.fq"]
    for a in names:
        assert tweb._file_kind(a) == jweb._file_kind(a)
        assert tweb._clean_name(a) == jweb._clean_name(a)
        for b in names:
            assert tweb._same_pair(a, b) == jweb._same_pair(a, b)
    for x in (-0.0, -1e-13, 0.1 + 0.2, 3.0, 1e21, -2.5):
        assert tweb._fmt_len(x) == jweb._fmt_len(x)
    assert tweb._NOFILTER_QUAL.__dict__ == jweb._NOFILTER_QUAL.__dict__
    tweb._check_width(63)
    with pytest.raises(ValueError) as got:
        tweb._check_width(64)
    with pytest.raises(ValueError) as want:
        jweb._check_width(64)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [17, 41])
def test_skadata_matches_jax(cohort, k):
    """Repeated maps on one object: FASTA, a gz FASTQ pair, subsampled
    reads; two JSON chunks (chromosome and plasmid)."""
    got = tweb.SkaData(cohort["ref"], k=k, device="cpu")
    want = jweb.SkaData(cohort["ref"], k=k)
    calls = [((cohort["fasta"][1],), {}), (tuple(cohort["pairs"][0]), {}),
             ((cohort["fasta"][2],), {}),
             (tuple(cohort["pairs"][1]), {"proportion_reads": 0.5})]
    for args, kw in calls:
        g = got.map(*args, **kw)
        assert g == want.map(*args, **kw)
        assert len(json.loads(g)["Mapped sequences"]) == 2
    assert got.n_maps == want.n_maps == len(calls)
    assert got.get_reference() == want.get_reference()


def test_aligndata_not_enough_matches_jax(cohort):
    files = cohort["fasta"][:2]
    got = tweb.AlignData(k=17, device="cpu")
    want = jweb.AlignData(k=17)
    assert got.align(files) == want.align(files)
    # one FASTQ pair counts as one sample
    assert got.align(cohort["pairs"][0][:1]) == want.align(cohort["pairs"][0][:1])
    assert got.get_size() == want.get_size() == 3


@pytest.mark.parametrize("k", [17, 31, 41, 63])
def test_aligndata_fasta_matches_jax(cohort, k):
    files = cohort["fasta"]
    g = tweb.AlignData(k=k, device="cpu").align(files)
    assert g == jweb.AlignData(k=k).align(files)
    assert list(json.loads(g)) == ["newick", "names", "alignment"]


def _count_builds(monkeypatch):
    """The names of the files each merged build of AlignData is handed,
    one list a build."""
    built = []
    real = tweb.build_samples_merged

    def counting(inputs, *a, **kw):
        built.append([name for name, _, _ in inputs])
        return real(inputs, *a, **kw)

    monkeypatch.setattr(tweb, "build_samples_merged", counting)
    return built


def test_aligndata_incremental_matches_jax(cohort, monkeypatch):
    """The second call builds only its new files (the build cache), on
    the merged route; its batches' columns follow the earlier ones."""
    built = _count_builds(monkeypatch)
    got = tweb.AlignData(k=17, device="cpu")
    want = jweb.AlignData(k=17)
    for files in (cohort["fasta"][:3], cohort["fasta"][3:], cohort["pairs"][2]):
        assert got.align(files) == want.align(files)
    assert built == [["sample0.fa", "sample1.fa", "sample2.fa"],
                     ["sample3.fa", "sample4.fa"], ["reads2_1.fastq"]]


@pytest.mark.parametrize("k", [17, 31, 63])
def test_aligndata_session_matches_jax(cohort, monkeypatch, k):
    """Two calls of one session at each key width: FASTA with IUPAC
    letters and an N run (sample1) and a subsampled FASTQ pair, then
    more FASTA and another pair at another proportion. Each document
    equal to the JAX package's; the second call builds only its files,
    and the class Gram runs once a call."""
    from ska_tpu_torch import distance

    built = _count_builds(monkeypatch)
    monkeypatch.setattr(distance, "gram_calls", 0)
    got = tweb.AlignData(k=k, device="cpu")
    want = jweb.AlignData(k=k)
    calls = [(cohort["fasta"][:3] + cohort["pairs"][0], 0.5),
             (cohort["pairs"][1] + cohort["fasta"][3:], 0.8)]
    for files, prop in calls:
        g = got.align(files, proportion_reads=prop)
        assert g == want.align(files, proportion_reads=prop)
    assert built == [["sample0.fa", "sample1.fa", "sample2.fa",
                      "reads0_1.fastq.gz"],
                     ["sample3.fa", "sample4.fa", "reads1_1.fastq"]]
    assert distance.gram_calls == 2
    doc = json.loads(g)
    assert doc["names"] == built[0] + built[1]
    assert doc["alignment"].count(">") == 7


def test_aligndata_no_valid_sequence_matches_jax(cohort):
    """An all-N file stops the call with the JAX package's message."""
    files = cohort["fasta"][:2] + [cohort["empty"]]
    with pytest.raises(ValueError) as want:
        jweb.AlignData(k=17).align(files)
    with pytest.raises(ValueError) as got:
        tweb.AlignData(k=17, device="cpu").align(files)
    assert str(got.value) == str(want.value)
    assert "has no valid sequence" in str(got.value)


def _direct_mismatches(variants):
    """Pairwise rows where both samples hold a base and the letters
    differ, one pair at a time."""
    n = variants.shape[1]
    out = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(n):
            a, b = variants[:, i], variants[:, j]
            out[i, j] = np.count_nonzero((a != ord("-")) & (b != ord("-")) & (a != b))
    return out


# (letters drawn, samples, rows, one-hot scratch bytes): '-ACG' gives
# four classes with the gap among them, so the tail pads with '-' and its
# counts come back out; the others leave a free pad slot, or use all 16
@pytest.mark.parametrize("letters,n,rows,scratch", [
    ("-ACG", 5, 3000, 1 << 14),
    ("-ACGT", 7, 2500, 1 << 15),
    ("-ACGTRN", 3, 5000, 1 << 28),
    ("-ACGTMRWSYKVHDBN", 9, 4100, 1 << 16),
    ("ACGT", 4, 1500, 1 << 13),
])
def test_snp_distances_match_a_direct_count(monkeypatch, letters, n, rows, scratch):
    from ska_tpu_torch import distance

    rng = np.random.default_rng(rows + n)
    alphabet = np.frombuffer(letters.encode(), np.uint8)
    variants = alphabet[rng.integers(0, len(alphabet), (rows, n))]
    monkeypatch.setattr(distance, "GRAM_SCRATCH_BYTES", scratch)
    monkeypatch.setattr(distance, "gram_chunks", 0)
    got = tweb.snp_distances(variants, "cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, _direct_mismatches(variants))
    assert distance.gram_chunks >= 1 + (scratch < (1 << 20))


def test_aligndata_fastq_pairing_matches_jax(cohort):
    """Three FASTQ pairs handed interleaved with FASTA: greedy pairing
    by the digit test, each pair one sample named by its first file,
    after the FASTA. The test pairs any two names of one length that
    differ at a 0/1/2 digit, so reads1_1 takes reads2_2 as its mate."""
    (a1, a2), (b1, b2), (c1, c2) = cohort["pairs"]
    files = [b1, a1, cohort["fasta"][0], c2, a2, b2, c1, cohort["fasta"][3]]
    g = tweb.AlignData(k=21, device="cpu").align(files, proportion_reads=0.5)
    assert g == jweb.AlignData(k=21).align(files, proportion_reads=0.5)
    assert json.loads(g)["names"] == ["sample0.fa", "sample3.fa",
                                      "reads1_1.fastq", "reads0_1.fastq.gz",
                                      "reads1_2.fastq"]


# ---- graft_entry -----------------------------------------------------------


def test_entry_matches_jax():
    fn, args = tentry.entry("cpu")
    jfn, jargs = jentry.entry()
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu" and np.array_equal(a.numpy(), np.asarray(j))
    got, want = fn(*args), jfn(*jargs)
    assert np.array_equal(TK.to_numpy_keys(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0


def test_merged_build_pipeline_reads_matches_jax(cohort):
    """The reads branch (quality gate, min-count 2) on ASCII bytes with
    Ns, as the merged build's other callers never feed it."""
    batches = [tsample.prepare_sample(tuple(p))[0] for p in cohort["pairs"]]
    L = max(len(b.seq) for b in batches)
    seqs = np.zeros((3, L), np.uint8)
    rec_last = np.zeros((3, L), bool)
    qual_ok = np.zeros((3, L), bool)
    for i, b in enumerate(batches):
        seqs[i, : len(b.seq)] = b.seq
        rec_last[i, : len(b.seq)] = b.rec_last
        qual_ok[i, : len(b.seq)] = b.qual.astype(np.int16) - 33 > 20
    seqs[:, 100:103] = ord("N")
    valid = ((seqs & 0xF) != 14) & (seqs != 0)
    arrs = (seqs, valid, qual_ok, rec_last)
    got = TP.merged_build_pipeline(*map(torch.from_numpy, arrs), 31, True, 1,
                                   True, True, 2)
    want = JP.merged_build_pipeline(*map(jnp.asarray, arrs), 31, True, 1,
                                    True, True, 2)
    n = int(want[3])
    assert int(got[3]) == n > 0
    assert np.array_equal(TK.to_numpy_keys(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_multichip_gloo_matches_jax():
    """Two gloo rank processes; the row count of the JAX dryrun_step on
    a mesh of two of the conftest's virtual CPU devices."""
    from ska_tpu.parallel import dryrun_step

    assert tentry.dryrun_multichip(2, "cpu") == dryrun_step(2) > 0


@pytest.mark.parametrize("call", ["SkaData", "AlignData", "build_sample",
                                  "build_samples", "dict_from_batch",
                                  "entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(cohort, monkeypatch, call):
    """With no device= (and no SKA_DEVICE) each asks for cuda, which
    raises without a card; nothing moves to the CPU."""
    monkeypatch.delenv("SKA_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = cohort["fasta"][0]
    batch = tsample.prepare_sample((fa, None))[0]
    run = {
        "SkaData": lambda: tweb.SkaData(cohort["ref"], 17),
        "AlignData": lambda: tweb.AlignData(17),
        "build_sample": lambda: tsample.build_sample("a", 17, (fa, None), True,
                                                     TQual()),
        "build_samples": lambda: tsample.build_samples([("a", fa, None)], 17,
                                                       True, TQual()),
        "dict_from_batch": lambda: tsample.dict_from_batch(batch, 17, True,
                                                           TQual(), False),
        "entry": tentry.entry,
        "dryrun_multichip": lambda: tentry.dryrun_multichip(1),
    }[call]
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        run()
