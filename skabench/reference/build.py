"""Plain reference of ``ska build``: the merged array of a cohort worked
out again from the generated FASTA or FASTQ files, and its comparison
with the `.skf` the program wrote."""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import kmers as R
from . import skf


def sample(cfg: dict, p1: str, p2):
    """(keys, sets) of one sample: a FASTA file, or a read pair under
    the configuration's build settings."""
    b = cfg["build"]
    if p2 is None:
        return R.sample_dict([s for _, s in R.read_fasta(p1)], b["k"], b["rc"])
    s1, q1 = R.read_fastq(p1)
    s2, q2 = R.read_fastq(p2)
    return R.sample_dict(s1 + s2, b["k"], b["rc"], q1 + q2, b["min_qual"],
                         b["qual_filter"], b["min_count"])


def expected(cfg: dict, inputs: dict, control: bool = False) -> dict:
    """names, k, rc, keys (rows,) uint64, variants and counts of the
    cohort's merged array (samples in threads: numpy drops the GIL)."""
    with ThreadPoolExecutor(min(8, len(inputs["samples"]))) as pool:
        dicts = list(pool.map(lambda s: sample(cfg, s[1], s[2]),
                              inputs["samples"]))
    keys, variants, counts = R.merge(dicts, control)
    return {"names": [s[0] for s in inputs["samples"]], "k": cfg["build"]["k"],
            "rc": cfg["build"]["rc"], "keys": keys, "variants": variants,
            "counts": counts}


def compare(exp: dict, path: str) -> dict:
    """The numbers compared for the `.skf` at path (see compare_arrays);
    one that does not read counts every row as differing."""
    t = time.perf_counter()
    try:
        got = skf.read(path)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"skabench: {path} does not read: {e}")
        return {"skf_unreadable": 1, "header_differing": 0, "rows_unsorted": 0,
                "rows_differing": len(exp["keys"])}
    print(f"skabench: reading {path} took {time.perf_counter() - t:.3f} s")
    return {"skf_unreadable": 0, **compare_arrays(exp, got)}


def compare_arrays(exp: dict, got: dict) -> dict:
    """Header fields that differ, rows not in key order, and rows that
    are missing, extra, or differ in letters or count."""
    header = int(got["k"] != exp["k"]) + int(got["rc"] != exp["rc"]) + int(
        got["names"] != exp["names"])
    ek, ev, ec = exp["keys"], exp["variants"], exp["counts"]
    if got["keys"].shape[1] != 1:
        return {"header_differing": header, "rows_unsorted": 0,
                "rows_differing": max(len(ek), len(got["keys"]))}
    gk, gv, gc = got["keys"][:, 0], got["variants"], got["counts"]
    unsorted = int(np.count_nonzero(gk[1:] <= gk[:-1]))
    if np.array_equal(ek, gk):
        common, ie, ig = len(ek), slice(None), slice(None)
    else:
        # the program's rows found among the expected ones, a key it
        # wrote twice matched once
        idx = np.minimum(np.searchsorted(ek, gk), max(len(ek) - 1, 0))
        hit = (ek[idx] == gk) if len(ek) else np.zeros(len(gk), bool)
        ig = np.flatnonzero(hit)
        ie = idx[ig]
        order = np.argsort(ie, kind="stable")
        first = np.ones(len(order), bool)
        first[1:] = ie[order][1:] != ie[order][:-1]
        ie, ig = ie[order[first]], ig[order[first]]
        common = len(ie)
    only = (len(ek) - common) + (len(gk) - common)
    if ev.shape[1] == gv.shape[1]:
        diff = int(np.count_nonzero((ev[ie] != gv[ig]).any(axis=1)
                                    | (ec[ie] != gc[ig])))
    else:
        diff = common
    return {"header_differing": header, "rows_unsorted": unsorted,
            "rows_differing": only + diff}
