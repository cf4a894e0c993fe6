"""The cell asm_k31.webapi_align: the browser's reference-free aligner,
``AlignData.align`` of the 21 cohort assemblies a call. Its entries in
BENCHMARK.json and its configuration asm_k31_web, the browser's build
settings over the asm_k31 cohort; the generator at a small size (5 genomes of 30 kb) and
the port's documents equal to the plain reference's
(reference/webalign.py), whose neighbour joining and distances are held
against the port's too; a tiny copy of the cell on the CPU, correct and
traced; a flipped base and a changed distance caught by the cell's
numbers; the new readers on a hand-made trace, each None without its
span; and (marker ``card``) the cell on a CUDA card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from skabench_helpers import ROOT, make_root, run_cell

from skabench import core
from skabench.reference import webalign
from skabench.trace import Trace

CELL = "asm_k31.webapi_align"
NEW = ("union_ms.align", "gram_ms.align", "nj_ms.align", "doc_ms.align",
       "gram_roofline")
EXTENDED = ("query_p95_ms", "parse_ms.query", "device_pass_ms.query",
            "to_host_ms.query", "call_self_ms.query", "device_idle_pct.query")
SMALL = {"genome_bases": 30000, "chromosome_bases": 28500, "n_run": [10, 100]}


def _spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _job(root=ROOT):
    return core.load_module(str(root), "jobs", "webapi_align")


def test_config_states_the_deployment():
    spec = _spec()
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "asm_k31_web", "webapi_align", 1)
    entries = {c["name"]: c for c in spec["configs"]}
    entry = entries["asm_k31_web"]
    assert entry["file"] == "skabench/configs/asm_k31_web.json"
    assert entry["reduced"] == ["samples"]
    assert "lib.rs:1126-1446" in entry["source"]
    assert all(entry["source"] != c["source"] for n, c in entries.items()
               if n != "asm_k31_web")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "skabench", "configs", "asm_k31.json")) as f:
        cohort = json.load(f)
    assert cfg["name"] == "asm_k31_web" and cfg["source"] == entry["source"]
    assert cfg["samples"] == cohort["samples"] == 21
    assert list(cfg["reduced"]) == entry["reduced"]
    # the browser's build: k 31, both strands, no quality or count filter
    assert cfg["build"] == {"k": 31, "rc": True, "min_count": 1, "min_qual": 0,
                            "qual_filter": "no_filter"}
    # the cohort of asm_k31, without its map reference
    assert cfg["inputs"] == dict(cohort["inputs"], map_reference=False)
    with open(os.path.join(ROOT, "skabench", "traffic", "webapi_align.json")) as f:
        traffic = json.load(f)
    assert traffic["job"] == "webapi_align" and traffic["warm_calls"] == 2
    assert "lib.rs:1126-1446" in traffic["source"]
    mine = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
            if CELL in m.get("workloads", [])}
    assert mine == set(NEW) | set(EXTENDED)
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            assert m["moves"] == "query_p95_ms" and m["workloads"] == [CELL]
            assert m["layer"] in {"host union and save", "class Gram", "front end"}


def _small_cohort(tmp_path, seed):
    root = make_root(tmp_path, sizes=SMALL, samples={"assemblies": 5})
    _, _, cfg, _, _, _ = core.cell_plan(str(root), CELL)
    gen = core.load_module(str(root), "gen", "assemblies")
    work = tmp_path / "in"
    work.mkdir()
    return cfg, gen.make(cfg, str(work), seed)


@pytest.mark.parametrize("seed", [2**33 + 1, 7])
def test_port_documents_equal_the_reference(tmp_path, seed):
    """The generator at 5 genomes of 30 kb; AlignData's document byte for
    byte the plain reference's, its tree over 5 leaves."""
    from ska_tpu_torch.webapi import AlignData

    cfg, inputs = _small_cohort(tmp_path, seed)
    files = [p for _, p, _ in inputs["samples"]]
    assert [os.path.basename(p) for p in files] == [f"genome{i:02d}.fa" for i in range(5)]
    assert 5 * 29900 < inputs["bases"] < 5 * 30100  # indels move a genome's length
    exp = webalign.expected(cfg, inputs)
    doc = AlignData(k=cfg["build"]["k"], device="cpu").align(files)
    assert doc == exp["doc"]
    parsed = json.loads(doc)
    assert parsed["names"] == [os.path.basename(p) for p in files]
    assert parsed["alignment"].count(">") == exp["samples"] == 5
    assert len(parsed["alignment"]) > 5 * exp["rows"] > 5 * 25000
    assert parsed["newick"].count("genome") == 5


@pytest.mark.parametrize("n", [3, 4, 7, 12, 21])
def test_reference_tree_equals_the_port(n):
    """Neighbour joining from the definition against the port's function
    on whole-number matrices, with ties in Q."""
    from ska_tpu_torch.webapi import neighbor_joining

    rng = np.random.default_rng(n)
    D = rng.integers(0, 5000, (n, n))
    D = np.triu(D, 1) + np.triu(D, 1).T
    if n > 4:
        D[1, 2] = D[2, 1] = D[0, 3] = D[3, 0] = 0
    names = [f"g{i}" for i in range(n)]
    assert webalign.neighbor_joining(D, names) == neighbor_joining(D, names)


def test_reference_distances_and_names():
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"-ACGTRN", np.uint8)
    v = letters[rng.integers(0, len(letters), (2000, 6))]
    got = webalign.mismatches(v)
    for i in range(6):
        for j in range(6):
            a, b = v[:, i].tolist(), v[:, j].tolist()
            assert got[i, j] == sum(x != y and 45 not in (x, y) for x, y in zip(a, b))
    assert webalign.clean_name("my sample.fasta") == "my_sample"
    assert webalign.clean_name("g.fa.fq") == "g"
    assert webalign.branch(-0.0) == "0" and webalign.branch(0.1 + 0.2) == "0.3"


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct(tiny_root, trace):
    rc, last, out = run_cell(tiny_root, CELL, seed=2**31 + 23, seconds=0.5, trace=trace)
    assert rc == 0 and last is not None, out
    assert last["correct"] is True and last["failed"] == 0, last["checks"]
    assert set(last["checks"]) == {"jobs_failed", "calls_differing",
                                   "alignment_differing", "newick_differing"}
    assert all(c["value"] <= c["limit"] == 0 for c in last["checks"].values())
    if trace:
        got = last["metrics"]
        assert {"union_ms.align", "gram_ms.align", "nj_ms.align", "doc_ms.align",
                "parse_ms.query", "device_pass_ms.query", "to_host_ms.query",
                "call_self_ms.query"} <= set(got)
        assert all(got[n]["value"] > 0 for n in NEW[:4])
        assert "gram_roofline" not in got  # no kernel on the CPU
    else:
        assert set(last["metrics"]) == {"query_p95_ms", "setup_s"}


def _flip(doc: str) -> str:
    """The document with the first letter of its first sample's sequence
    changed."""
    d = json.loads(doc)
    head, _, rest = d["alignment"].partition("\n")
    d["alignment"] = head + "\n" + ("C" if rest[0] != "C" else "A") + rest[1:]
    return json.dumps(d)


def _records(*docs):
    return ([{"ok": True, "seconds": 1.0, "index": i, "digest": core.digest(x)}
             for i, x in enumerate(docs)],
            {core.digest(x): x for x in docs})


def test_flipped_base_and_changed_distance_are_counted(tmp_path, monkeypatch):
    """One flipped base reads 1 in calls_differing and
    alignment_differing; one distance changed in the program reads 1 in
    calls_differing and newick_differing; the true document reads 0."""
    from ska_tpu_torch import webapi

    job = _job()
    cfg, inputs = _small_cohort(tmp_path, 11)
    files = [p for _, p, _ in inputs["samples"]]
    want = webalign.expected(cfg, inputs)["doc"]
    assert job.differing(*_records(want), want) == {
        "calls_differing": 0, "alignment_differing": 0, "newick_differing": 0}
    assert job.differing(*_records(want, _flip(want)), want) == {
        "calls_differing": 1, "alignment_differing": 1, "newick_differing": 0}

    real = webapi.snp_distances

    def changed(variants, device=None):
        d = real(variants, device)
        d[0, 1] += 1000
        d[1, 0] += 1000
        return d

    monkeypatch.setattr(webapi, "snp_distances", changed)
    got = webapi.AlignData(k=cfg["build"]["k"], device="cpu").align(files)
    assert job.differing(*_records(got), want) == {
        "calls_differing": 1, "alignment_differing": 0, "newick_differing": 1}
    # a document that does not read differs in every key
    assert job.differing(*_records("{"), want) == {
        "calls_differing": 1, "alignment_differing": 1, "newick_differing": 1}


def _changed_distance(mp):
    from ska_tpu_torch import webapi

    real = webapi.snp_distances

    def changed(variants, device=None):
        d = real(variants, device)
        d[0, 2] = d[2, 0] = d[0, 2] + 500
        return d

    mp.setattr(webapi, "snp_distances", changed)


def _flipped_fasta(mp):
    from ska_tpu_torch.array import SkaArray

    real = SkaArray.write_fasta

    def write(self, fh):
        self.variants = self.variants.copy()
        self.variants[0, 0] = ord("C") if self.variants[0, 0] != ord("C") else ord("A")
        return real(self, fh)

    mp.setattr(SkaArray, "write_fasta", write)


@pytest.mark.parametrize("plant", [_changed_distance, _flipped_fasta])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, plant):
    root = make_root(tmp_path)
    plant(monkeypatch)
    rc, last, out = run_cell(root, CELL, seconds=0.3)
    assert rc == 0 and last is not None, out
    assert last["correct"] is False, last["checks"]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _kernel(name, ts, dur, corr, launch_ts, tid=1):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": tid, "ts": launch_ts, "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "tid": 7, "ts": ts,
             "dur": dur, "args": {"correlation": corr}}]


def _align_trace(spans=True):
    # two calls of 1000 us; each call's span holds a union, a Gram, an NJ
    # and a document; the Gram of call 1 launches two kernels, of call 2
    # one, and a kernel launched in the union does not count
    ev = [_span("skabench::window", 0, 2000),
          _span("skabench::job", 0, 1000), _span("skabench::job", 1000, 1000)]
    for t0, (u, g, n, d) in ((0, (100, 300, 10, 200)), (1000, (80, 260, 6, 160))):
        ev.append(_span("ska::call", t0 + 10, 980))
        if spans:
            t = t0 + 20
            for name, dur in (("union", u), ("gram", g), ("nj", n), ("doc", d)):
                ev.append(_span(f"ska::{name}", t, dur))
                t += dur
    ev += _kernel("int_mm", 200, 40, 1, launch_ts=130)
    ev += _kernel("scatter", 250, 20, 2, launch_ts=140)
    ev += _kernel("int_mm", 1200, 40, 3, launch_ts=1110)
    ev += _kernel("merge", 60, 5, 4, launch_ts=30)
    return Trace(ev)


SPAN_READS = {"union_ms.align": 0.09, "gram_ms.align": 0.28,   # (100+80)/2, (300+260)/2
              "nj_ms.align": 0.008, "doc_ms.align": 0.18}


@pytest.mark.parametrize("name", list(SPAN_READS))
def test_reader_on_a_synthetic_trace(name):
    read = core.load_module(ROOT, "metrics", name).read
    t = _align_trace()
    assert read(t, {"jobs": 2}) == pytest.approx(SPAN_READS[name])
    assert read(_align_trace(spans=False), {"jobs": 2}) is None
    assert read(t, {"jobs": 0}) is None


def test_gram_roofline_reads_the_kernels_in_the_gram():
    m = core.load_module(ROOT, "metrics", "gram_roofline")
    # 6.4M rows of 21 samples read once; a 336 x 336 int64 Gram written once
    assert m.gram_bytes(6_400_000, 21) == 6_400_000 * 21 + 8 * 336 * 336
    from skabench.peaks import HBM_BYTES_PER_S

    run = {"jobs": 2, "stats": {"rows": 1000, "samples": 3}}
    least = 2 * (1000 * 3 + 8 * 48 * 48) / HBM_BYTES_PER_S
    assert m.read(_align_trace(), run) == pytest.approx(100 * least / 100e-6)
    assert m.read(_align_trace(spans=False), run) is None
    assert m.read(_align_trace(), {**run, "stats": {}}) is None


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import skabench.reference.webalign; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'ska_tpu', 'ska_tpu_torch', 'torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.card
def test_cell_on_card():
    r = subprocess.run([sys.executable, "skabench/run.py", "--workload", CELL,
                        "--seed", "4000000023", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1


def test_control_fails_the_cell(tmp_path):
    """The control (split k-mers told apart by 32-bit fingerprints, so
    that colliding keys share a row) fails calls_differing and
    alignment_differing at a size where fingerprints collide: five 1 Mb
    genomes."""
    from skabench.reference import build

    root = make_root(tmp_path, sizes={"genome_bases": 1_000_000,
                                      "chromosome_bases": 950_000},
                     samples={"assemblies": 5})
    _, _, cfg, _, _, _ = core.cell_plan(str(root), CELL)
    gen = core.load_module(str(root), "gen", "assemblies")
    work = tmp_path / "in"
    work.mkdir()
    inputs = gen.make(cfg, str(work), 1234)
    want = webalign.expected(cfg, inputs)["doc"]
    ctl = build.expected(cfg, inputs, control=True)
    names = [os.path.basename(p) for _, p, _ in inputs["samples"]]
    got = webalign.document(names, ctl["variants"])
    numbers = _job().differing(*_records(got), want)
    assert numbers["calls_differing"] == numbers["alignment_differing"] == 1
