"""The cell asm_k31.map_aln: `ska map -f aln`, upstream's default output,
of the map reference to the 21-assembly `.skf`. Its entries in
BENCHMARK.json, a tiny copy of the cell on the CPU, correct and traced
(the writer's span ska::aln read by aln_ms.map), the control failing the
cell's comparison, faults caught, aln_ms.map on a hand-made trace, and
(marker ``card``) the cell on a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
from skabench_helpers import ROOT, make_root, run_cell

from skabench import core
from skabench.reference import aln, build, mapping
from skabench.trace import Trace

CELL = "asm_k31.map_aln"


def _spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_config_states_the_deployment():
    spec = _spec()
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("asm_k31", "map_aln", 1)
    with open(os.path.join(ROOT, "skabench", "traffic", "map_aln.json")) as f:
        assert json.load(f)["job"] == "map_aln"
    with open(os.path.join(ROOT, "skabench", "configs", "asm_k31.json")) as f:
        cfg = json.load(f)
    assert cfg["inputs"]["map_reference"] is True and cfg["samples"] == 21
    mine = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
            if CELL in m.get("workloads", [])}
    assert mine == {"map_s", "lookup_roofline", "device_idle_pct.map", "load_ms.map",
                    "command_self_ms.map", "aln_ms.map"}
    (metric,) = [m for m in spec["per_layer"] if m["name"] == "aln_ms.map"]
    assert (metric["layer"], metric["moves"], metric["source"]) == (
        "map writers", "map_s", "program_span")


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct(tiny_root, trace):
    rc, last, out = run_cell(tiny_root, CELL, seed=2**31 + 31, trace=trace)
    assert rc == 0 and last is not None, out
    assert last["correct"] is True and last["failed"] == 0, last["checks"]
    assert set(last["checks"]) == {"jobs_failed", "aln_lines_differing",
                                   "jobs_output_differing"}
    assert all(c["value"] <= c["limit"] == 0 for c in last["checks"].values())
    if trace:
        assert {"aln_ms.map", "load_ms.map", "command_self_ms.map"} <= set(last["metrics"])
        assert "vcf_ms.map" not in last["metrics"]
    else:
        assert set(last["metrics"]) == {"map_s", "setup_s"}


def test_control_fails_the_cell(tmp_path):
    """The control (split k-mers told apart by 32-bit fingerprints, in
    the table and in the lookup) fails aln_lines_differing at a size
    where fingerprints collide: five 1 Mb genomes."""
    root = make_root(tmp_path, sizes={"genome_bases": 1_000_000,
                                      "chromosome_bases": 950_000},
                     samples={"assemblies": 5})
    _, _, cfg, _, _, _ = core.cell_plan(str(root), CELL)
    gen = core.load_module(str(root), "gen", "assemblies")
    work = tmp_path / "in"
    work.mkdir()
    inputs = gen.make(cfg, str(work), 1234)
    k, rc = cfg["build"]["k"], cfg["build"]["rc"]
    ref = mapping.Reference(inputs["map_reference"], k, rc)
    exp = build.expected(cfg, inputs)
    ctl = build.expected(cfg, inputs, control=True)
    want = aln.aln(ref, exp["names"], exp["keys"], exp["variants"])
    got = aln.aln(ref, ctl["names"], ctl["keys"], ctl["variants"], control=True)
    assert aln.lines_differing(want, got) > 0
    assert aln.lines_differing(want, want) == 0
    assert want.count(b"\n") == 2 * 5


def _half_hits(mp):
    from ska_tpu_torch.ref import RefSka

    orig = RefSka.map

    def half(self, arr):
        orig(self, arr)
        n = len(self.mapped_pos) // 2
        self.mapped_variants = self.mapped_variants[:n]
        self.mapped_chrom, self.mapped_pos = self.mapped_chrom[:n], self.mapped_pos[:n]

    mp.setattr(RefSka, "map", half)


def _altered_aln(mp):
    from ska_tpu_torch.ref import RefSka

    orig = RefSka.pseudoalignment

    def rows(self):
        out = orig(self)
        out[-1][0] = ord("-") if out[-1][0] != ord("-") else ord("A")
        return out

    mp.setattr(RefSka, "pseudoalignment", rows)


@pytest.mark.parametrize("plant", [_half_hits, _altered_aln])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, plant):
    root = make_root(tmp_path)
    plant(monkeypatch)
    rc, last, out = run_cell(root, CELL, seconds=0.5)
    assert rc == 0 and last is not None, out
    assert last["correct"] is False, last["checks"]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def test_aln_metric_reads_a_hand_made_trace():
    read = core.load_module(ROOT, "metrics", "aln_ms.map").read
    # two jobs; the first writer's span holds a nested span of 100 us
    ev = [_span("skabench::window", 0, 10_000),
          _span("skabench::job", 0, 5_000), _span("skabench::job", 5_000, 5_000),
          _span("ska::command", 0, 4_000), _span("ska::pseudoalign", 1_000, 500),
          _span("ska::aln", 1_500, 2_000), _span("ska::other", 2_000, 100),
          _span("ska::command", 5_000, 4_000), _span("ska::aln", 6_500, 1_000)]
    trace = Trace(ev)
    assert read(trace, {"jobs": trace.jobs()}) == pytest.approx((1.9 + 1.0) / 2)
    # a program without the span (the parent of ska::aln) reads nothing
    plain = Trace([e for e in ev if e["name"] != "ska::aln"])
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
