"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped, the program on its CPU route): the result line, the cells
correct against the plain reference, a cell, a configuration and a
metric added as new files, the faults that each cell's check catches,
and the refusals."""

import ast
import glob
import hashlib
import json
import os
import subprocess
import sys

import pytest
from skabench_helpers import ROOT, make_root, run_cell

from skabench import core

CELLS = ["asm_k31.build", "reads_k31.build", "asm_k31.map_vcf", "asm_k31.webapi_map"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _spec(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_cpu(tiny_root, cell):
    spec = _spec(tiny_root)
    rc, last, out = run_cell(tiny_root, cell, seed=2**31 + 5)
    assert rc == 0 and last is not None, out
    assert list(last) == KEYS + ["checks"]  # the numbers compared come last
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert all(c["value"] <= c["limit"] == 0 for c in last["checks"].values())
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(last["metrics"]) == want and "setup_s" in want
    assert last["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(tiny_root, cell):
    rc, last, out = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and last is not None, out
    assert list(last) == KEYS + ["breakdown", "checks"]
    assert last["correct"] is True
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(last["device"])
    spec = _spec(tiny_root)
    # on the CPU the device metrics find nothing to read; every span
    # metric of the cell is there
    want = {m["name"] for m in spec["per_layer"] if cell in m["workloads"]
            and m["source"] == "program_span"}
    assert want and want <= set(last["metrics"])
    assert not {"device_pass_roofline", "lookup_roofline"} & set(last["metrics"])


def _digests(root):
    out = {}
    for p in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(p) and "__pycache__" not in p:
            with open(p, "rb") as f:
                out[p] = hashlib.sha1(f.read()).hexdigest()
    return out


def test_new_cell_config_and_metric_are_new_files(tiny_root):
    """A cell on a new configuration, with a new per-layer metric: new
    files and new entries in BENCHMARK.json, and no other file edited."""
    before = _digests(tiny_root)
    cfg = json.loads((tiny_root / "skabench/configs/asm_k31.json").read_text())
    cfg["name"] = "asm_k31_small"
    cfg["samples"] = 2
    (tiny_root / "skabench/configs/asm_k31_small.json").write_text(json.dumps(cfg))
    (tiny_root / "skabench/metrics/jobs_seen.py").write_text(
        "def read(trace, run):\n    return float(run['jobs'])\n")
    spec = _spec(tiny_root)
    spec["configs"].append({"name": "asm_k31_small", "source": "a test",
                            "file": "skabench/configs/asm_k31_small.json",
                            "reduced": ["samples"], "why": "a test"})
    spec["workloads"].append({"name": "asm_k31_small.build", "config": "asm_k31_small",
                              "traffic": "build", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "build_kmers_per_s":
            m["workloads"].append("asm_k31_small.build")
    spec["per_layer"].append({"name": "jobs_seen", "unit": "jobs", "better": "higher",
                              "source": "program_span", "layer": "harness",
                              "moves": "build_kmers_per_s",
                              "workloads": ["asm_k31_small.build"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, last, out = run_cell(tiny_root, "asm_k31_small.build")
    assert rc == 0 and last["correct"] and "build_kmers_per_s" in last["metrics"], out
    rc, last, out = run_cell(tiny_root, "asm_k31_small.build", trace=1)
    assert rc == 0 and last["metrics"]["jobs_seen"]["value"] == last["attempted"]
    after = _digests(tiny_root)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == [str(tiny_root / "BENCHMARK.json")]


def _half_batch_build(mp):
    import ska_tpu_torch.api as api

    orig = api.build
    mp.setattr(api, "build", lambda files, *a, **k: orig(files[: len(files) // 2], *a, **k))


def _altered_save(mp):
    import ska_tpu_torch.io.skf as skf

    orig = skf.save

    def save(arr, path, *a, **k):
        arr.variants[0, 0] = ord("C") if arr.variants[0, 0] == ord("A") else ord("A")
        return orig(arr, path, *a, **k)

    mp.setattr(skf, "save", save)


def _no_save(mp):
    import ska_tpu_torch.io.skf as skf

    mp.setattr(skf, "save", lambda arr, path, *a, **k: path)


def _half_hits(mp):
    from ska_tpu_torch.ref import RefSka

    orig = RefSka.map

    def half(self, arr):
        orig(self, arr)
        n = len(self.mapped_pos) // 2
        self.mapped_variants = self.mapped_variants[:n]
        self.mapped_chrom, self.mapped_pos = self.mapped_chrom[:n], self.mapped_pos[:n]

    mp.setattr(RefSka, "map", half)


def _altered_vcf(mp):
    from ska_tpu_torch.ref import RefSka

    orig = RefSka._vcf_records

    def records(self, w, aln_mat):
        lines = []
        orig(self, lines.append, aln_mat)
        f = lines[0].split("\t")
        f[1] = str(int(f[1]) + 1)
        lines[0] = "\t".join(f)
        for line in lines:
            w(line)

    mp.setattr(RefSka, "_vcf_records", records)


def _no_map(mp):
    import ska_tpu_torch.api as api

    mp.setattr(api, "map_mode", lambda *a, **k: None)


def _altered_doc(mp):
    from ska_tpu_torch.webapi import SkaData

    orig = SkaData.map

    def call(self, *a, **k):
        doc = json.loads(orig(self, *a, **k))
        doc["Number of variants"] += 1
        return json.dumps(doc)

    mp.setattr(SkaData, "map", call)


def _stale_doc(mp):
    from ska_tpu_torch.webapi import SkaData

    orig, first = SkaData.map, []

    def call(self, *a, **k):
        if not first:
            first.append(orig(self, *a, **k))
        return first[0]

    mp.setattr(SkaData, "map", call)


FAULTS = [
    ("asm_k31.build", "half of the batch left out", _half_batch_build),
    ("asm_k31.build", "an answer altered where it is produced", _altered_save),
    ("asm_k31.build", "a step that leaves its state unchanged", _no_save),
    ("reads_k31.build", "half of the batch left out", _half_batch_build),
    ("reads_k31.build", "an answer altered where it is produced", _altered_save),
    ("asm_k31.map_vcf", "half of the batch left out", _half_hits),
    ("asm_k31.map_vcf", "an answer altered where it is produced", _altered_vcf),
    ("asm_k31.map_vcf", "a step that leaves its state unchanged", _no_map),
    ("asm_k31.webapi_map", "half of the batch left out", _half_hits),
    ("asm_k31.webapi_map", "an answer altered where it is produced", _altered_doc),
    ("asm_k31.webapi_map", "a step that leaves its state unchanged", _stale_doc),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault, plant):
    root = make_root(tmp_path, samples={"reads": 2})
    plant(monkeypatch)
    rc, last, out = run_cell(root, cell, seconds=0.5)
    assert rc == 0 and last is not None, out
    assert last["correct"] is False, (fault, last["checks"])


def test_control_fails_each_cell(tmp_path):
    """The control (split k-mers told apart by 32-bit fingerprints) fails
    every job kind's comparison, at a size where fingerprints collide:
    five 1 Mb genomes."""
    from skabench import control

    root = make_root(tmp_path, sizes={"genome_bases": 1_000_000,
                                      "chromosome_bases": 950_000},
                     samples={"assemblies": 5})
    _, _, cfg, _, _, _ = core.cell_plan(str(root), "asm_k31.build")
    gen = core.load_module(str(root), "gen", "assemblies")
    work = tmp_path / "in"
    work.mkdir()
    inputs = gen.make(cfg, str(work), 1234)
    for job, number in (("build", "rows_differing"), ("map", "vcf_lines_differing"),
                        ("webapi_map", "calls_differing")):
        assert control.readings(job, cfg, inputs)[number] > 0, job


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "ska_tpu_torch" not in core.forbidden_modules()
    for name in ("jax", "jaxlib.xla_client", "flax", "ska_tpu", "ska_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert core.forbidden_modules() == ["flax", "jax", "jaxlib", "ska_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program_and_no_jax():
    bench = os.path.join(ROOT, "skabench")
    for path in glob.glob(os.path.join(bench, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ska_tpu"}, path
        if os.sep + "reference" + os.sep in path:
            assert "ska_tpu_torch" not in tops and "torch" not in tops, path


def test_run_refused_without_a_card_or_the_program(tmp_path):
    """On a machine with no card the command prints no result and exits
    with another code than 0; so it does in a directory that holds only
    BENCHMARK.json and the benchmark's files."""
    root = make_root(tmp_path)
    for cwd in (ROOT, str(root)):
        r = subprocess.run([sys.executable, "skabench/run.py", "--workload",
                            "asm_k31.build", "--seed", "1", "--seconds", "1",
                            "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
        assert r.returncode != 0
        assert '"correct"' not in r.stdout
