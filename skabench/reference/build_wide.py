"""Plain reference of ``ska build`` with 128-bit keys (any odd k from 5
to 63, kmers_wide.py): the merged array of a cohort worked out again
from the generated FASTA or FASTQ files, and its comparison with the
`.skf` the program wrote, field by field, with the four numbers that
build.compare reports.

The `.skf` is decoded as skf.read decodes it (skf.unframe, then its
CBOR reader), except that a long array of split k-mers is read a run of
one encoded head at a time: sorted u128 keys are written as plain uints
while their high limb is 0, then as tag-2 bignums of 9 to 16 bytes, each
length one run, so the reader's item-by-item path for bignums is never
taken. ``read`` returns keys as (rows, 2) uint64 limbs, (hi, lo).
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import build
from . import kmers as R
from . import kmers_wide as KW
from . import skf

_HEAD_WIDTH = {24: 2, 25: 3, 26: 5, 27: 9}


def sample(cfg: dict, p1: str, p2):
    """((n, 2) keys, sets) of one sample: a FASTA file, or a read pair
    under the configuration's build settings."""
    b = cfg["build"]
    if p2 is None:
        return KW.sample_dict([s for _, s in R.read_fasta(p1)], b["k"], b["rc"])
    s1, q1 = R.read_fastq(p1)
    s2, q2 = R.read_fastq(p2)
    return KW.sample_dict(s1 + s2, b["k"], b["rc"], q1 + q2, b["min_qual"],
                          b["qual_filter"], b["min_count"])


def expected(cfg: dict, inputs: dict, control: bool = False) -> dict:
    """names, k, rc, keys (rows, 2) uint64, variants and counts of the
    cohort's merged array (samples in threads: numpy drops the GIL). The
    control (control=True) merges by 32-bit fingerprints."""
    KW.check_k(cfg["build"]["k"])
    with ThreadPoolExecutor(max(1, min(8, len(inputs["samples"])))) as pool:
        dicts = list(pool.map(lambda s: sample(cfg, s[1], s[2]),
                              inputs["samples"]))
    keys, variants, counts = KW.merge(dicts, control)
    return {"names": [s[0] for s in inputs["samples"]], "k": cfg["build"]["k"],
            "rc": cfg["build"]["rc"], "keys": keys, "variants": variants,
            "counts": counts}


def _run_length(a, pos: int, width: int, most: int, match) -> int:
    """How many items of `width` bytes from pos on match(rows), at most
    `most`, checked in windows that double."""
    done, step = 0, 64
    while done < most:
        m = min(step, most - done)
        start = pos + done * width
        rows = a[start : start + m * width]
        if len(rows) < m * width:
            return done
        ok = match(rows.reshape(m, width))
        if not ok.all():
            return done + int(np.argmin(ok))
        done += m
        step *= 2
    return done


def _keys(a, pos: int, n: int):
    """(hi, lo, end) of n CBOR unsigned integers or tag-2 bignums of at
    most 16 bytes from pos, or None at any other item."""
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    i = 0
    while i < n:
        head = int(a[pos])
        if head < 24:
            width = 1
            run = _run_length(a, pos, 1, n - i, lambda r: r[:, 0] < 24)
        elif head in _HEAD_WIDTH:
            width = _HEAD_WIDTH[head]
            run = _run_length(a, pos, width, n - i, lambda r: r[:, 0] == head)
        elif head == 0xC2 and pos + 1 < len(a) and 0x40 < a[pos + 1] <= 0x50:
            second = int(a[pos + 1])
            width = 2 + second - 0x40
            run = _run_length(a, pos, width, n - i,
                              lambda r: (r[:, 0] == 0xC2) & (r[:, 1] == second))
        else:
            return None
        rows = a[pos : pos + run * width].reshape(run, width)
        if width == 1:
            lo[i : i + run] = rows[:, 0]
        else:
            body = rows[:, 1:] if head != 0xC2 else rows[:, 2:]
            be = np.zeros((run, 16), np.uint8)
            be[:, 16 - body.shape[1] :] = body
            limbs = be.view(">u8")
            hi[i : i + run] = limbs[:, 0]
            lo[i : i + run] = limbs[:, 1]
        pos += run * width
        i += run
    return hi, lo, pos


class _WideKeys:
    def __init__(self, hi, lo):
        self.hi, self.lo = hi, lo


class _Cbor(skf._Cbor):
    """skf's CBOR reader, with the array that follows the text
    "split_kmers" read by _keys."""

    _last = None

    def item(self):
        v = super().item()
        if isinstance(v, str):
            self._last = v
        return v

    def array(self, n: int):
        if self._last == "split_kmers" and n >= 64:
            self._last = None
            got = _keys(self.a, self.pos, n)
            if got is not None:
                self.pos = got[2]
                return _WideKeys(got[0], got[1])
        return super().array(n)


def read(path: str) -> dict:
    """skf.read's fields of an `.skf` file, keys as (rows, 2) uint64
    limbs (hi, lo) whatever its key width."""
    with open(path, "rb") as f:
        raw = f.read()
    r = _Cbor(skf.unframe(raw))
    obj = r.item()
    if r.pos != len(r.a):
        raise ValueError("trailing bytes after the CBOR map")
    sk = obj["split_kmers"]
    if isinstance(sk, _WideKeys):
        keys = KW.stack(sk.hi, sk.lo)
    else:
        vals = [int(v) for v in sk]
        if any(v >> 128 for v in vals):
            raise ValueError("a split k-mer wider than 128 bits")
        keys = np.array([[v >> 64, v & (2**64 - 1)] for v in vals],
                        np.uint64).reshape(-1, 2)
    v = obj["variants"]
    rows, cols = v["dim"]
    data = np.asarray(v["data"])
    if len(data) != rows * cols or (data.dtype != np.uint8 and (data > 255).any()):
        raise ValueError("variants: not a (rows, samples) matrix of bytes")
    return {"k": obj["k"], "rc": obj["rc"], "names": list(obj["names"]),
            "k_bits": obj.get("k_bits", 64), "keys": keys,
            "variants": data.astype(np.uint8).reshape(rows, cols),
            "counts": np.asarray(obj["variant_count"], np.int64)}


def compare(exp: dict, path: str) -> dict:
    """The numbers compared for the `.skf` at path (see compare_arrays);
    one that does not read counts every row as differing."""
    t = time.perf_counter()
    try:
        got = read(path)
    except (OSError, ValueError, KeyError, TypeError, IndexError) as e:
        print(f"skabench: {path} does not read: {e}")
        return {"skf_unreadable": 1, "header_differing": 0, "rows_unsorted": 0,
                "rows_differing": len(exp["keys"])}
    print(f"skabench: reading {path} took {time.perf_counter() - t:.3f} s")
    return {"skf_unreadable": 0, **compare_arrays(exp, got)}


def _ranks(ek, gk):
    """Dense ranks of the expected and the got keys in their union, as
    uint64: equal keys get one rank and the ranks keep the keys' order."""
    keys = np.concatenate([ek, gk])
    o = KW.order(keys[:, 0], keys[:, 1])
    sk = keys[o]
    first = np.ones(len(o), bool)
    first[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    rank = np.empty(len(o), np.uint64)
    rank[o] = np.cumsum(first) - 1
    return rank[: len(ek)], rank[len(ek) :]


def compare_arrays(exp: dict, got: dict) -> dict:
    """build.compare_arrays of the two arrays with each key replaced by
    its rank (so rows are matched and ordered as their 128-bit keys are),
    a key width other than 128 bits counted as one more header field
    that differs."""
    ek, gk = exp["keys"], got["keys"]
    if np.array_equal(ek, gk):
        er = gr = np.arange(len(ek), dtype=np.uint64)
    else:
        er, gr = _ranks(ek, gk)
    out = build.compare_arrays({**exp, "keys": er}, {**got, "keys": gr[:, None]})
    out["header_differing"] += int(got.get("k_bits", 128) != 128)
    return out
