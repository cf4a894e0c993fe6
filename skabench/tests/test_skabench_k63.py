"""The cell asm_k63.build: the asm_k31 cohort built at k = 63, where keys
are u128 (two int64 limbs in the port). Its configuration, the plain
128-bit reference's `.skf` reader against skf.read, a tiny copy of the
cell on the CPU, correct and traced, the control failing the cell's
comparison, device_pass_roofline at W = 2 on a hand-made trace, faults
caught, and (marker ``card``) the cell on a CUDA card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from skabench_helpers import ROOT, make_root, run_cell

from skabench import core
from skabench.peaks import HBM_BYTES_PER_S, build_pass_bytes
from skabench.reference import build_wide, skf
from skabench.trace import Trace

CELL = "asm_k63.build"


def _spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _cfg(name):
    with open(os.path.join(ROOT, "skabench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_config_states_the_deployment():
    cfg, k31 = _cfg("asm_k63"), _cfg("asm_k31")
    assert cfg["name"] == "asm_k63" and cfg["samples"] == 21
    assert list(cfg["reduced"]) == ["samples"]
    assert cfg["build"] == dict(k31["build"], k=63)
    # the same cohort and generator as asm_k31, with no map reference
    assert cfg["inputs"] == dict(k31["inputs"], map_reference=False)
    assert cfg["guarantees"][0] == k31["guarantees"][0]
    assert "tag-2" in cfg["guarantees"][1] and "u128" in cfg["guarantees"][1]
    spec = _spec()
    (entry,) = [c for c in spec["configs"] if c["name"] == "asm_k63"]
    assert entry["file"] == "skabench/configs/asm_k63.json"
    assert entry["reduced"] == ["samples"] and len(entry["source"]) <= 200
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("asm_k63", "build_u128", 1)
    # every build metric of asm_k31.build is read in this cell too
    build = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
             if "asm_k31.build" in m.get("workloads", [])}
    mine = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
            if CELL in m.get("workloads", [])}
    assert mine == build


@pytest.fixture
def tiny_k63(tmp_path):
    return make_root(tmp_path)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct(tiny_k63, trace):
    from ska_tpu_torch import torchinit

    torchinit.reset_launch_counts()
    rc, last, out = run_cell(tiny_k63, CELL, seed=2**31 + 63, trace=trace)
    assert rc == 0 and last is not None, out
    assert last["correct"] is True and last["failed"] == 0, last["checks"]
    assert set(last["checks"]) == {"jobs_failed", "skf_unreadable", "header_differing",
                                   "rows_unsorted", "rows_differing",
                                   "jobs_output_differing"}
    assert all(c["value"] <= c["limit"] == 0 for c in last["checks"].values())
    # every save wrote u128 keys as bignums
    saves = torchinit.save_counts()
    assert saves["files"] == last["attempted"] + 1
    assert saves["wide_keys"] > 0 and saves["wide_keys"] % saves["files"] == 0
    if trace:
        want = {m["name"] for m in _spec(tiny_k63)["per_layer"]
                if CELL in m.get("workloads", []) and m["source"] == "program_span"}
        assert "union_save_ms.build" in want and want <= set(last["metrics"])
    else:
        assert set(last["metrics"]) == {"build_kmers_per_s", "setup_s"}


def test_reader_decodes_as_skf_read(tiny_k63, tmp_path):
    """build_wide.read gives skf.read's keys, letters and counts for a
    program-written .skf at k = 63 (bignums) and k = 33 (64-bit keys that
    are u128 all the same), with its key width."""
    from ska_tpu_torch import cli

    _, _, cfg, _, _, _ = core.cell_plan(str(tiny_k63), CELL)
    gen = core.load_module(str(tiny_k63), "gen", "assemblies")
    inputs = gen.make(cfg, str(tmp_path), 99)
    for k in (63, 33):
        out = str(tmp_path / f"k{k}")
        cli.main(["build", *[p for _, p, _ in inputs["samples"]], "-k", str(k),
                  "-o", out, "--device", "cpu"])
        a, b = skf.read(out + ".skf"), build_wide.read(out + ".skf")
        assert len(a["keys"]) > 1000 and b["k_bits"] == 128
        assert np.array_equal(a["keys"], b["keys"])
        assert np.array_equal(a["variants"], b["variants"])
        assert np.array_equal(a["counts"], b["counts"])
        assert (b["keys"][:, 0] != 0).any() == (k == 63)


def test_control_fails_the_cell(tmp_path):
    """The control (split k-mers told apart by 32-bit fingerprints of
    both limbs) fails the cell's comparison at a size where fingerprints
    collide: five 1 Mb genomes."""
    root = make_root(tmp_path, sizes={"genome_bases": 1_000_000,
                                      "chromosome_bases": 950_000},
                     samples={"assemblies": 5})
    _, _, cfg, _, _, _ = core.cell_plan(str(root), CELL)
    gen = core.load_module(str(root), "gen", "assemblies")
    work = tmp_path / "in"
    work.mkdir()
    inputs = gen.make(cfg, str(work), 1234)
    exp = build_wide.expected(cfg, inputs)
    ctl = build_wide.expected(cfg, inputs, control=True)
    got = {**ctl, "k_bits": 128}
    assert build_wide.compare_arrays(exp, got)["rows_differing"] > 0
    assert build_wide.compare_arrays(exp, {**exp, "k_bits": 128}) == {
        "header_differing": 0, "rows_unsorted": 0, "rows_differing": 0}


def _altered_key(mp):
    import ska_tpu_torch.io.skf as tskf

    orig = tskf.save

    def save(arr, path, *a, **k):
        arr.keys[-1, 1] ^= 1
        return orig(arr, path, *a, **k)

    mp.setattr(tskf, "save", save)


def _half_batch(mp):
    import ska_tpu_torch.api as api

    orig = api.build
    mp.setattr(api, "build", lambda files, *a, **k: orig(files[: len(files) // 2], *a, **k))


@pytest.mark.parametrize("plant", [_altered_key, _half_batch])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, plant):
    root = make_root(tmp_path)
    plant(monkeypatch)
    rc, last, out = run_cell(root, CELL, seconds=0.5)
    assert rc == 0 and last is not None, out
    assert last["correct"] is False, last["checks"]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _kernel(ts, dur, corr, launch_ts):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": 1, "ts": launch_ts, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": "scatter_kernel", "tid": 7,
             "ts": ts, "dur": dur, "args": {"correlation": corr}}]


def test_roofline_reads_the_two_limb_pass():
    """device_pass_roofline counts 16 bytes a row's key when the job sets
    W = 2, on a hand-made trace of two jobs; nothing without the span."""
    read = core.load_module(ROOT, "metrics", "device_pass_roofline").read
    ev = [_span("skabench::window", 0, 10_000),
          _span("skabench::job", 0, 5_000), _span("skabench::job", 5_000, 5_000),
          _span("ska::device_pass", 100, 1_000), _span("ska::device_pass", 5_100, 1_000)]
    ev += _kernel(200, 300, 1, 150) + _kernel(5_200, 500, 2, 5_150)
    trace = Trace(ev)
    run = {"jobs": trace.jobs(), "inputs": {"bases": 42_000_000},
           "stats": {"rows": 10_000_000, "samples": 21, "W": 2}}
    least = 2 * (42_000_000 + 10_000_000 * (16 + 21)) / HBM_BYTES_PER_S
    assert build_pass_bytes(42_000_000, 10_000_000, 2, 21) == 42_000_000 + 370_000_000
    assert read(trace, run) == pytest.approx(100 * least / 800e-6)
    plain = Trace([e for e in ev if e.get("name") != "ska::device_pass"])
    assert read(plain, run) is None


@pytest.mark.card
def test_cell_on_card():
    r = subprocess.run([sys.executable, "skabench/run.py", "--workload", CELL,
                        "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
