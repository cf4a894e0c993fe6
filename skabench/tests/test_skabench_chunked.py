"""The cell reads_ecoli_k31.build: one deep read pair over the port's
single-dispatch cap (SKA_MAX_CHUNK_BASES), built by the chunked count
route. Its generator at a size cut here, a tiny copy of the cell on the
CPU with the cap forced low, correct and traced, the metric
chunk_merge_ms.build on a hand-made trace, and (marker ``card``) the
cell on a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
from skabench_helpers import ROOT, make_root, run_cell

from skabench import core
from skabench.gen import reads
from skabench.trace import Trace

CELL = "reads_ecoli_k31.build"


def _cfg():
    with open(os.path.join(ROOT, "skabench", "configs", "reads_ecoli_k31.json")) as f:
        return json.load(f)


def test_config_states_the_deployment():
    cfg = _cfg()
    p = cfg["inputs"]
    assert cfg["samples"] == 1 and list(cfg["reduced"]) == ["samples"]
    assert (p["genome_bases"], p["chromosome_bases"], p["depth"], p["read_len"]) == (
        4_800_000, 4_700_000, 40, 150)
    assert cfg["build"] == {"k": 31, "rc": True, "min_count": 5, "min_qual": 20,
                            "qual_filter": "strict"}
    # over the default cap: three dispatches
    bases = 2 * (p["depth"] * p["genome_bases"] // (2 * p["read_len"])) * p["read_len"]
    cap = (1 << 26) - 128
    assert bases == 192_000_000 and 2 * cap < bases <= 3 * cap


def test_generator_makes_one_pair_of_the_stated_records(tmp_path):
    cfg = _cfg()
    cfg["inputs"].update(genome_bases=48_000, chromosome_bases=47_000, n_run=[10, 100])
    inputs = reads.make(cfg, str(tmp_path), 2**31 + 17)
    ((_, fwd, rev),) = inputs["samples"]
    counts = []
    for path in (fwd, rev):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        assert len(lines) % 4 == 1 and lines[-1] == b""
        counts.append(len(lines) // 4)
        assert {len(x) for x in lines[1::4]} == {150}
    # 40x of the genome, whose indels move its length by a few bases
    pairs = counts[0]
    assert counts == [pairs, pairs] and abs(pairs - 40 * 48_000 // 300) < 10
    assert inputs["bases"] == 2 * pairs * 150
    assert inputs["windows"] == 2 * pairs * (150 - 31 + 1)


@pytest.fixture
def chunked_root(tmp_path, monkeypatch):
    """A tiny copy of the benchmark (20 kb genome at 40x: 800 kb of
    reads) whose cap cuts the pair into three chunks."""
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", "300000")
    return make_root(tmp_path)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct_through_the_chunked_route(chunked_root, trace):
    from ska_tpu_torch import torchinit

    torchinit.reset_launch_counts()
    rc, last, out = run_cell(chunked_root, CELL, seed=2**31 + 23, trace=trace)
    assert rc == 0 and last is not None, out
    assert last["correct"] is True and last["failed"] == 0, last["checks"]
    assert all(c["value"] <= c["limit"] == 0 for c in last["checks"].values())
    jobs = last["attempted"] + 1  # the warm-up job too
    assert torchinit.chunk_counts()["chunked_samples"] == jobs
    assert torchinit.chunk_counts()["chunks"] == 3 * jobs
    if trace:
        spec = json.loads((chunked_root / "BENCHMARK.json").read_text())
        want = {m["name"] for m in spec["per_layer"]
                if CELL in m.get("workloads", []) and m["source"] == "program_span"}
        assert "chunk_merge_ms.build" in want and want <= set(last["metrics"])
    else:
        assert set(last["metrics"]) == {"build_kmers_per_s", "setup_s"}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": 1,
            "ts": ts, "dur": dur}


def test_chunk_merge_metric_reads_a_hand_made_trace():
    read = core.load_module(ROOT, "metrics", "chunk_merge_ms.build").read
    # two jobs; the second's merge holds a nested span of 100 us
    ev = [_span("skabench::window", 0, 10_000),
          _span("skabench::job", 0, 5_000), _span("skabench::job", 5_000, 5_000),
          _span("ska::command", 0, 4_000), _span("ska::chunk_merge", 2_000, 1_500),
          _span("ska::command", 5_000, 4_000), _span("ska::chunk_merge", 6_000, 2_500),
          _span("ska::sort", 7_000, 100)]
    trace = Trace(ev)
    assert read(trace, {"jobs": trace.jobs()}) == pytest.approx((1.5 + 2.4) / 2)
    # a program without the span (the parent of the chunked spans) reads nothing
    plain = Trace([e for e in ev if e["name"] != "ska::chunk_merge"])
    assert read(plain, {"jobs": plain.jobs()}) is None


@pytest.mark.card
def test_cell_on_card():
    r = subprocess.run([sys.executable, "skabench/run.py", "--workload", CELL,
                        "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
