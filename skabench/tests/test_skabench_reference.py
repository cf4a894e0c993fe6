"""The plain reference against a literal per-window loop of upstream's
rules on short random records (N, IUPAC and lowercase letters, records
shorter than k), for assemblies and for reads with qualities and a count
filter. (test_skabench_harness.py holds it against the program's CPU
route.)"""

import numpy as np
import pytest

from skabench.reference import kmers as R

CODE = {c: (c >> 1) & 3 for c in range(256)}


def literal(records, k, rc=True, quals=None, min_qual=20, min_count=1):
    """{key: set} by walking every window of every record."""
    h = (k - 1) // 2
    seen, counts = {}, {}
    for r, rec in enumerate(records):
        q = quals[r] if quals is not None else None
        ok = [(b & 0xF) != 14 and (q is None or q[i] - 33 > min_qual)
              for i, b in enumerate(rec)]
        for s in range(len(rec) - k + 1):
            if not all(ok[s : s + k]):
                continue
            if s + k == len(rec) and not (s >= 1 and ok[s - 1]):
                continue  # the last window is reached only by rolling
            codes = [CODE[b] for b in rec[s : s + k]]
            whole = codes
            rwhole = [c ^ 2 for c in reversed(codes)]
            if rc and rwhole < whole:
                whole = rwhole
            key = whole[:h] + whole[h + 1 :]
            mid = whole[h]
            rkey = [c ^ 2 for c in reversed(key)]
            if rc and rkey < key:
                key, mid = rkey, mid ^ 2
            bits = (1 << mid) | ((1 << (mid ^ 2)) if rc and rkey == key else 0)
            packed = 0
            for c in key:
                packed = (packed << 2) | c
            w = tuple(whole)
            counts[w] = counts.get(w, 0) + 1
            if counts[w] == min_count or (min_count == 1):
                seen[packed] = seen.get(packed, 0) | bits
    return seen


@pytest.mark.parametrize("k", [5, 7, 15, 31])
@pytest.mark.parametrize("rc", [True, False])
def test_assemblies(k, rc):
    rng = np.random.default_rng(k + rc)
    alphabet = np.frombuffer(b"ACGTACGTACGTACGTNRYKacgtn", np.uint8)
    for _ in range(20):
        records = [rng.choice(alphabet, size=int(rng.integers(1, 120)))
                   for _ in range(int(rng.integers(1, 4)))]
        keys, sets = R.sample_dict(records, k, rc)
        assert dict(zip(keys.tolist(), sets.tolist())) == literal(
            [r.tolist() for r in records], k, rc)


@pytest.mark.parametrize("min_count", [1, 2, 3])
def test_reads(min_count):
    rng = np.random.default_rng(min_count)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=60)
    reads, quals = [], []
    for _ in range(40):  # overlapping reads of one short genome
        a = int(rng.integers(0, 30))
        read = genome[a : a + 30].copy()
        read[rng.random(30) < 0.03] = ord("N")
        reads.append(read)
        quals.append(rng.integers(33 + 10, 33 + 41, size=30).astype(np.uint8))
    keys, sets = R.sample_dict(reads, 11, True, quals, 20, "strict", min_count)
    want = literal([r.tolist() for r in reads], 11, True,
                   [q.tolist() for q in quals], 20, min_count)
    assert dict(zip(keys.tolist(), sets.tolist())) == want


def test_letters():
    assert bytes(R.LETTER).decode() == "-ACMTWYHGRSVKDBN"
    assert R.COMPLEMENT[ord("A")] == ord("T") and R.COMPLEMENT[ord("R")] == ord("Y")
    assert R.COMPLEMENT[ord("S")] == ord("S") and R.COMPLEMENT[ord("-")] == ord("-")


def test_compare_arrays_counts_each_row_once():
    from skabench.reference import build as B

    ek = np.array([1, 3, 5, 7], np.uint64)
    ev = np.full((4, 2), ord("A"), np.uint8)
    ec = np.full(4, 2)
    exp = dict(k=31, rc=True, names=["a", "b"], keys=ek, variants=ev, counts=ec)

    def got(keys, var=ev, cnt=ec, **kw):
        return {**exp, **kw, "keys": np.array(keys, np.uint64)[:, None],
                "variants": var[: len(keys)], "counts": cnt[: len(keys)]}

    def rows(g):
        return B.compare_arrays(exp, g)["rows_differing"]

    assert B.compare_arrays(exp, got([1, 3, 5, 7])) == {
        "header_differing": 0, "rows_unsorted": 0, "rows_differing": 0}
    assert rows(got([1, 3, 5])) == 1
    assert rows(got([1, 3, 5, 9])) == 2
    assert B.compare_arrays(exp, got([1, 3, 3, 7])) == {
        "header_differing": 0, "rows_unsorted": 1, "rows_differing": 2}
    v = ev.copy()
    v[2, 1] = ord("C")
    assert rows(got([1, 3, 5, 7], var=v)) == 1
    assert rows(got([1, 3, 5, 7], cnt=np.array([2, 2, 1, 2]))) == 1
    assert B.compare_arrays(exp, got([1, 3, 5, 7], names=["b", "a"]))["header_differing"] == 1
