"""The metric arithmetic on synthetic traces and records: self time,
kernels attributed to the span of their launch, the device's idle union,
the breakdown, the 95th percentile over all calls, and the least bytes
and bound of the two rooflines on hand-checked examples."""

import os

import pytest
from skabench_helpers import ROOT

from skabench import core
from skabench.peaks import HBM_BYTES_PER_S, build_pass_bytes, key_words, lookup_bound
from skabench.trace import Trace


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _kernel(name, ts, dur, corr, launch_ts, tid=1, cat="kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": tid, "ts": launch_ts, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur,
             "args": {"correlation": corr}}]


def _trace():
    # window 0-1000 us; two jobs; job 1 holds a parse with a nested stage
    # and a device pass whose kernel runs after the span has closed
    ev = [_span("skabench::window", 0, 1000),
          _span("skabench::job", 0, 500), _span("skabench::job", 500, 500),
          _span("ska::parse", 100, 200), _span("ska::stage", 150, 50),
          _span("ska::device_pass", 300, 100), _span("ska::device_pass", 600, 100),
          _span("ska::other", 600, 100, tid=2)]
    ev += _kernel("sort", 350, 100, 1, launch_ts=310)   # launched in pass 1
    ev += _kernel("sort", 380, 40, 2, launch_ts=320)    # overlaps the first
    ev += _kernel("fill", 800, 50, 3, launch_ts=450)    # launched outside
    ev += _kernel("late", 900, 10, 4, launch_ts=650, tid=2)  # other thread
    ev += _kernel("copy", 700, 20, 5, launch_ts=650, cat="gpu_memcpy")
    return Trace(ev)


def test_self_time_and_jobs():
    t = _trace()
    assert t.jobs() == 2
    assert t.window_s == pytest.approx(1e-3)
    assert t.self_s(("ska::parse",)) == pytest.approx(150e-6)
    assert t.self_s(("ska::parse", "ska::stage")) == pytest.approx(200e-6)
    # a job less only the named spans in it
    assert t.self_s(("skabench::job",), ("ska::device_pass",)) == pytest.approx(800e-6)


def test_kernels_by_launch_span():
    t = _trace()
    names = sorted(e[0] for e in t.kernels_in(("ska::device_pass",)))
    assert names == ["sort", "sort"]  # not fill (launched outside), not late
    assert t.kernels_in(("ska::other",))[0][0] == "late"


def test_idle_is_the_union_of_device_intervals():
    t = _trace()
    # busy: 350-450 (two overlapping sorts), 700-720, 800-850, 900-910
    assert t.busy_s() == pytest.approx(180e-6)
    assert t.idle_pct() == pytest.approx(82.0)
    b = t.breakdown("build")
    assert dict(b["device_ops"])["sort"] == pytest.approx(140e-6)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(820e-6)
    assert idle["ska::parse"] == pytest.approx(150e-6)
    assert idle["ska::stage"] == pytest.approx(50e-6)
    # pass 1 idle 300-350, pass 2 all of 600-700 (the copy starts at 700)
    assert idle["ska::device_pass"] == pytest.approx(150e-6)
    # job 1: 0-100 and 450-500 outside its spans; job 2: 500-600,
    # 720-800, 850-900 and 910-1000
    assert idle["build: outside ska spans"] == pytest.approx(470e-6)


def test_idle_gap_labels_sum_to_the_window():
    t = _trace()
    b = t.breakdown("build")
    busy = t.busy_s()
    assert sum(v for _, v in b["idle_gaps"]) + busy == pytest.approx(t.window_s)


def test_query_p95_is_over_all_calls(tmp_path):
    job = core.load_module(ROOT, "jobs", "webapi_map")
    j = job.Job.__new__(job.Job)
    # 100 calls: 94 at 10 ms, then 6 slow ones; nearest rank 95 is 60 ms.
    # Medians of chunks of 10 would give 10 ms.
    lat = [0.01] * 94 + [0.05, 0.06, 0.07, 0.08, 0.09, 0.1]
    recs = [{"ok": True, "seconds": s, "index": i, "query": i % 21}
            for i, s in enumerate(lat)] + [{"ok": False, "seconds": 0, "index": 100}]
    assert j.metrics(recs, 1.0)["query_p95_ms"] == pytest.approx(50.0)
    recs = [{"ok": True, "seconds": s, "index": i, "query": 0}
            for i, s in enumerate(lat[:-1] + [0.2])]
    assert j.metrics(recs, 1.0)["query_p95_ms"] == pytest.approx(50.0)


def test_least_bytes_by_hand():
    # 42,000,000 bases read once; 6,400,000 rows of one key word and 21
    # sample bytes written once
    assert build_pass_bytes(42_000_000, 6_400_000, 1, 21) == 42_000_000 + 6_400_000 * 29
    # map: 8 bytes of each of N keys and M queries, 8 of each answer
    ms, kind = lookup_bound(1, 6_447_824, 1_999_345)
    assert kind == "bytes"
    assert ms == pytest.approx(1e3 * (8 * (6_447_824 + 1_999_345) + 8 * 1_999_345)
                               / HBM_BYTES_PER_S)
    assert ms == pytest.approx(0.0249, abs=1e-4)


@pytest.mark.parametrize("k,words", [(5, 1), (17, 1), (31, 1), (33, 2), (63, 2)])
def test_key_words(k, words):
    """One 64-bit word of key to k = 31, two to k = 63."""
    assert key_words(k) == words


def test_roofline_readers():
    t = _trace()
    run = {"jobs": 2, "inputs": {"bases": 1000}, "stats": {"rows": 100, "W": 1,
                                                           "samples": 3}}
    m = core.load_module(ROOT, "metrics", "device_pass_roofline")
    least = 2 * (1000 + 100 * 11) / HBM_BYTES_PER_S
    assert m.read(t, run) == pytest.approx(100 * least / 140e-6)
    assert m.read(t, {**run, "stats": {}}) is None
    lk = core.load_module(ROOT, "metrics", "lookup_roofline")
    assert lk.read(t, {"jobs": 2, "stats": {}}) is None


def test_every_declared_metric_has_a_reader():
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for m in spec["per_layer"]:
        assert hasattr(core.load_module(ROOT, "metrics", m["name"]), "read")
