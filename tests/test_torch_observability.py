"""The port's two observability switches on the CPU, the counterparts of
the JAX CLI's (ska_tpu/cli.py SKA_PROFILE, ska_tpu/jaxinit.py
SKA_DISPATCH_STATS):

- SKA_PROFILE=<dir>: `python -m ska_tpu_torch <cmd>` writes one Chrome
  trace a process, `rank<r>.<ns>.pt.trace.json`, that holds the
  command's `ska::` spans (or its `aten::` operators where it has no
  span), and writes the same output bytes as without the switch; without
  it torch.profiler is never entered. In a gloo group of two ranks each
  rank writes its own, a rank with nothing to do too.
- SKA_DISPATCH_STATS=1: one stderr line at exit that
  scripts/bench_cmds.py's _STATS_RE reads, with the hand-written
  kernels' launches and sorts (none on the CPU), the compiler runs of
  the process, the class Gram's calls, products, rows and one-hot, and
  the .skf writer's files, chunks, threads and bignum keys; none and no exit
  hook without it. `kernels.builds` counts a compiler
  run and no up-to-date library.
"""

import ctypes
import glob
import importlib.util
import json
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ska_tpu_torch import api as tapi
from ska_tpu_torch import cli, kernels
from ska_tpu_torch.io import skf, snappy
from ska_tpu_torch.sampletypes import QualOpts
from test_torch_fastq import _genome, _read_pairs, _write_fastq
from test_torch_parallel import _free_port, _wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)
TRACE_NAME = re.compile(r"^rank(\d+)\.\d+\.pt\.trace\.json$")


def _stats_re():
    """scripts/bench_cmds.py's _STATS_RE, read from the script itself."""
    spec = importlib.util.spec_from_file_location(
        "bench_cmds", os.path.join(REPO, "scripts", "bench_cmds.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._STATS_RE


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 4 kb reference, three samples with ~2% SNPs built at k=17 into
    an .skf, and a FASTQ pair of the reference at 30x."""
    d = tmp_path_factory.mktemp("obs")
    rng = np.random.default_rng(12)
    ref = _genome(rng, 4000)
    (d / "ref.fa").write_bytes(b">ref\n" + ref.tobytes() + b"\n")
    files = []
    for i in range(3):
        g = ref.copy()
        snp = rng.random(len(g)) < 0.02
        g[snp] = rng.choice(ACGT, size=int(snp.sum()))
        (d / f"s{i}.fa").write_bytes(b">s\n" + g.tobytes() + b"\n")
        files.append((f"s{i}", str(d / f"s{i}.fa"), None))
    arr = tapi.build(files, 17, True, QualOpts(), device="cpu")
    fwd, rev = _read_pairs(rng, ref, 4000 * 30 // 200, 100, repeat=0)
    return {
        "ref": str(d / "ref.fa"),
        "samples": [f for _, f, _ in files],
        "skf": skf.save(arr, str(d / "in")),
        "fastq": (_write_fastq(d / "r_1.fastq", fwd),
                  _write_fastq(d / "r_2.fastq", rev)),
    }


def _argv(cmd, inp, out):
    o = os.path.join(out, "out")
    return {
        "build": ["build", "-k", "17", "-o", o, *inp["samples"]],
        # FASTA files: align builds them first
        "align": ["align", *inp["samples"], "-o", o],
        "align_skf": ["align", inp["skf"], "-o", o],
        "map": ["map", inp["ref"], inp["skf"], "-f", "vcf", "-o", o],
        # the default format, aln
        "map_aln": ["map", inp["ref"], inp["skf"], "-o", o],
        "distance": ["distance", inp["skf"], "-o", o],
        "cov": ["cov", *inp["fastq"], "-k", "17"],
        "weed": ["weed", inp["skf"], inp["ref"], "-o", o + ".skf"],
        "nk": ["nk", inp["skf"]],
    }[cmd]


# the spans each command runs through (ref.py, sample.py, api.py, cli.py,
# io/skf.py)
SPANS = {
    "build": {"ska::parse", "ska::device_pass", "ska::union", "ska::save",
              "ska::command"},
    "map": {"ska::scan", "ska::lookup", "ska::vcf", "ska::command",
            "ska::load", "ska::read", "ska::decompress", "ska::decode"},
    "map_aln": {"ska::scan", "ska::lookup", "ska::pseudoalign", "ska::aln",
                "ska::command", "ska::load"},
    "weed": {"ska::scan"},
    # the class Gram, ska distance's kernel (distance.py)
    "distance": {"ska::command", "ska::load", "ska::gram"},
}


def _run(cmd, inp, out, capsys):
    """One in-process CLI run into the directory `out`: (stdout, {file:
    bytes} of `out`)."""
    os.makedirs(out)
    capsys.readouterr()
    cli.main(_argv(cmd, inp, str(out)) + ["--device", "cpu"])
    files = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            files[name] = f.read()
    return capsys.readouterr().out, files


def _trace_names(path):
    with open(path) as f:
        doc = json.load(f)
    return {e.get("name", "") for e in doc["traceEvents"]}


# commands that run no torch op: their trace holds no event of theirs
NO_TORCH_OP = ("align_skf", "nk")


@pytest.mark.parametrize("cmd", ["build", "align", "align_skf", "map",
                                 "map_aln", "distance", "cov", "weed", "nk"])
def test_profile_writes_one_trace(inputs, tmp_path, monkeypatch, capsys,
                                  caplog, cmd):
    """One parseable Chrome trace with the command's spans (its aten::
    operators where it has none; only a file for nk and the align of an
    .skf, which run no torch op), and the output bytes of the same
    command untraced."""
    monkeypatch.delenv("SKA_PROFILE", raising=False)
    plain = _run(cmd, inp=inputs, out=tmp_path / "plain", capsys=capsys)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SKA_PROFILE", str(trace_dir))
    caplog.set_level(logging.INFO, logger="ska_tpu_torch")
    traced = _run(cmd, inp=inputs, out=tmp_path / "traced", capsys=capsys)
    assert traced == plain
    assert plain[0] or plain[1]
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and TRACE_NAME.match(traces[0]).group(1) == "0"
    path = str(trace_dir / traces[0])
    assert f"profiler trace written to {path}" in caplog.text
    names = _trace_names(path)
    if cmd in SPANS:
        assert SPANS[cmd] <= names
    elif cmd not in NO_TORCH_OP:
        assert any(n.startswith("aten::") for n in names)


def test_no_profiler_without_the_switch(inputs, tmp_path, monkeypatch, capsys):
    """Without SKA_PROFILE the profiler is never entered and no trace
    file appears."""
    import torch.profiler

    entered = []

    def refuse(*a, **kw):
        entered.append((a, kw))
        raise AssertionError("torch.profiler.profile entered")

    monkeypatch.delenv("SKA_PROFILE", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    _, files = _run("build", inputs, tmp_path / "out", capsys)
    assert list(files) == ["out.skf"] and not entered
    assert not glob.glob(str(tmp_path / "**" / "*.json"), recursive=True)


def _port(argv, **env):
    """`python -m ska_tpu_torch <argv> --device cpu` in a process of its
    own, with neither switch inherited."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("SKA_DISPATCH_STATS", "SKA_PROFILE")}
    return subprocess.run(
        [sys.executable, "-m", "ska_tpu_torch", *argv, "--device", "cpu"],
        env=dict(base, PYTHONPATH=REPO, **env), cwd=REPO,
        capture_output=True, timeout=300)


@pytest.mark.parametrize("switch", ["1", None])
def test_dispatch_stats_line(inputs, tmp_path, switch):
    """With SKA_DISPATCH_STATS=1 a build prints exactly one line that
    bench_cmds.py's regex reads: no kernel launched on the CPU; without
    it, no such line."""
    env = {} if switch is None else {"SKA_DISPATCH_STATS": switch}
    os.makedirs(tmp_path / "out")
    r = _port(_argv("build", inputs, str(tmp_path / "out")), **env)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    stats_re = _stats_re()
    lines = [ln for ln in r.stderr.splitlines() if stats_re.search(ln)]
    if switch is None:
        assert lines == [] and b"SKA_DISPATCH_STATS" not in r.stderr
        return
    assert len(lines) == 1
    stats = json.loads(stats_re.search(lines[0]).group(1))
    assert set(stats) == {"kernel_launches", "launches", "radix_sorts",
                          "kernel_builds", "chunked", "merged", "gram", "save"}
    assert stats["gram"] == {"calls": 0, "chunks": 0, "rows": 0,
                             "onehot_width": 0, "onehot_bytes": 0}
    assert stats["launches"] == {"radix_sort": 0, "lower_bound": 0}
    assert stats["radix_sorts"] == {}
    assert stats["chunked"] == {"chunked_samples": 0, "chunks": 0,
                                "chunk_rows": 0, "chunk_copy_bytes": 0}
    # the three samples are one batch: a W=1 key, 3 ASCII bytes and an
    # int64 count a row, and the 3 presence flags
    merged = stats["merged"]
    assert merged["merged_batches"] == 1 and merged["merged_rows"] > 0
    assert merged["merged_copy_bytes"] == merged["merged_rows"] * 19 + 3
    assert stats["save"]["files"] == 1 and stats["save"]["wide_keys"] == 0
    assert stats["save"]["chunks"] >= stats["save"]["max_threads"] >= 1
    assert stats["kernel_launches"] == 0
    assert isinstance(stats["kernel_builds"], int) and stats["kernel_builds"] >= 0


def test_dispatch_stats_count_chunks(inputs, tmp_path, monkeypatch):
    """A reads build cut into chunks prints, under SKA_DISPATCH_STATS=1,
    the chunked counters that the same build counts in process: one
    chunked sample, its chunks, the rows they handed to the merge and
    the bytes of those rows alone (16W + 4 a row under the count
    filter)."""
    from ska_tpu_torch import torchinit

    tsv = tmp_path / "reads.tsv"
    tsv.write_text("r\t%s\t%s\n" % inputs["fastq"])
    os.makedirs(tmp_path / "out")
    argv = ["build", "-f", str(tsv), "-k", "17", "-o",
            str(tmp_path / "out" / "out")]
    r = _port(argv, SKA_DISPATCH_STATS="1", SKA_MAX_CHUNK_BASES="40000")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    (line,) = [ln for ln in r.stderr.splitlines() if _stats_re().search(ln)]
    stats = json.loads(_stats_re().search(line).group(1))
    monkeypatch.setenv("SKA_MAX_CHUNK_BASES", "40000")
    torchinit.reset_launch_counts()
    cli.main(argv + ["--device", "cpu"])
    want = torchinit.chunk_counts()
    assert want["chunked_samples"] == 1 and want["chunks"] >= 3
    assert want["chunk_copy_bytes"] == want["chunk_rows"] * (16 + 4) > 0
    assert stats["chunked"] == want


def test_dispatch_stats_count_the_gram(inputs, tmp_path):
    """`distance` prints, under SKA_DISPATCH_STATS=1, the class Gram's
    counters that the same Gram counts in process: one call, its int8
    products, their rows (a power of two a chunk), the one-hot's columns
    and its bytes, rows x columns."""
    from ska_tpu_torch import distance, torchinit

    argv = ["distance", inputs["skf"], "-o", str(tmp_path / "d.tsv")]
    r = _port(argv, SKA_DISPATCH_STATS="1")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    (line,) = [ln for ln in r.stderr.splitlines() if _stats_re().search(ln)]
    stats = json.loads(_stats_re().search(line).group(1))
    torchinit.reset_launch_counts()
    cli.main(argv + ["--device", "cpu"])
    want = torchinit.gram_counts()
    assert want["calls"] == 1 and want["chunks"] >= 1
    assert want["rows"] % want["chunks"] == 0 and want["rows"] >= 1024
    assert want["onehot_width"] % 8 == 0 and want["onehot_width"] >= 3 * 4
    assert want["onehot_bytes"] == want["rows"] * want["onehot_width"]
    assert stats["gram"] == want
    torchinit.reset_launch_counts()
    assert distance.gram_calls == distance.gram_onehot_bytes == 0


def test_dispatch_stats_count_the_save(tmp_path):
    """A build whose .skf spans many framing chunks prints, under
    SKA_DISPATCH_STATS=1, one file written, the chunks of its CBOR text
    (ceil(bytes / 65536)) and the threads the writer used: as many as
    SKA_THREADS allows."""
    rng = np.random.default_rng(18)
    samples = []
    for i in range(3):
        path = tmp_path / f"g{i}.fa"
        path.write_bytes(b">g\n" + _genome(rng, 40000).tobytes() + b"\n")
        samples.append(str(path))
    os.makedirs(tmp_path / "out")
    out = str(tmp_path / "out" / "out")
    r = _port(["build", "-k", "17", "-o", out, *samples],
              SKA_DISPATCH_STATS="1", SKA_THREADS="4")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    (line,) = [ln for ln in r.stderr.splitlines() if _stats_re().search(ln)]
    stats = json.loads(_stats_re().search(line).group(1))
    with open(out + ".skf", "rb") as f:
        cbor_len = len(snappy.frame_decompress(f.read()))
    chunks = -(-cbor_len // 65536)
    assert chunks > 4
    assert stats["save"] == {"files": 1, "chunks": chunks, "max_threads": 4,
                             "wide_keys": 0}


@pytest.mark.parametrize("switch", ["1", None])
def test_dispatch_stats_hook_only_with_the_switch(switch):
    """torchinit registers its exit hook when SKA_DISPATCH_STATS is set,
    and no hook otherwise."""
    code = (
        "import atexit\n"
        "hooks = []\n"
        "atexit.register = lambda fn, *a, **kw: hooks.append(fn) or fn\n"
        "import ska_tpu_torch.torchinit as t\n"
        "print(sum(h is t._print_dispatch_stats for h in hooks))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SKA_DISPATCH_STATS", None)
    if switch:
        env["SKA_DISPATCH_STATS"] = switch
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["1" if switch else "0"]
    assert "SKA_DISPATCH_STATS" not in r.stderr


def test_kernel_builds_counts_compiler_runs(tmp_path):
    """A g++ source compiled through kernels._compile counts one build;
    the second, up-to-date call none; a newer source one more."""
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int ska_probe() { return 42; }\n')
    so = str(tmp_path / "lib" / "libprobe.so")

    def compile_():
        before = kernels.builds
        assert kernels._compile(kernels._gxx(), kernels.GXX_FLAGS,
                                [str(src)], so) == so
        return kernels.builds - before

    assert compile_() == 1
    assert ctypes.CDLL(so).ska_probe() == 42
    assert compile_() == 0
    t = os.path.getmtime(so) + 10
    os.utime(src, (t, t))
    assert compile_() == 1


@pytest.fixture(scope="module")
def group_traces(inputs, tmp_path_factory):
    """`build` (collective, SKA_DISTRIBUTED=1) and `nk` (rank 0 alone)
    under SKA_PROFILE, each in a gloo group of two rank processes, all
    four at once. Returns the directory: <cmd>/trace and <cmd>/out."""
    d = tmp_path_factory.mktemp("group")
    procs = []
    for cmd in ("build", "nk"):
        os.makedirs(d / cmd / "out")
        env = dict(os.environ, PYTHONPATH=REPO, SKA_DISTRIBUTED="1",
                   SKA_PROFILE=str(d / cmd / "trace"),
                   SKA_COORDINATOR=f"localhost:{_free_port()}",
                   SKA_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
        procs += [(f"{cmd} rank {r}", subprocess.Popen(
            [sys.executable, "-m", "ska_tpu_torch",
             *_argv(cmd, inputs, str(d / cmd / "out")), "--device", "cpu"],
            env=dict(env, SKA_PROCESS_ID=str(r)), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)) for r in range(2)]
    failed = _wait_all(procs)
    assert not failed, "\n".join(failed)
    return d


@pytest.mark.parametrize("cmd", ["build", "nk"])
def test_profile_one_trace_per_rank(group_traces, cmd):
    """Each rank of the group writes its own parseable trace, rank 1 of
    `nk` (which has nothing to do) too; rank 0 alone writes the .skf."""
    trace_dir = group_traces / cmd / "trace"
    traces = sorted(os.listdir(trace_dir))
    assert sorted(TRACE_NAME.match(t).group(1) for t in traces) == ["0", "1"]
    for t in traces:
        names = _trace_names(trace_dir / t)
        if cmd == "build":
            # every rank builds; rank 0 alone saves
            rank0 = TRACE_NAME.match(t).group(1) == "0"
            assert SPANS["build"] - {"ska::save"} <= names
            assert ("ska::save" in names) == rank0
    want = ["out.skf"] if cmd == "build" else []
    assert os.listdir(group_traces / cmd / "out") == want


def _spans(path):
    """The trace's record_function spans: [(name, thread, start, end)]."""
    with open(path) as f:
        doc = json.load(f)
    return [(e["name"], e.get("tid"), float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _profile_spans(fn, tmp_path):
    """The spans of fn() run under torch.profiler (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "fn.pt.trace.json")
    prof.export_chrome_trace(path)
    return _spans(path)


def _inside(spans, outer):
    """The spans nested in the span outer, on its thread."""
    _, tid, a, b = outer
    return [s for s in spans if s is not outer and s[1] == tid
            and a <= s[2] < b and s[3] <= b]


# the per-sample build's, the merge's and map's spans in a browser call
CALL_SPANS = {"ska::parse", "ska::stage", "ska::to_device", "ska::device_pass",
              "ska::to_host", "ska::merge", "ska::lookup", "ska::gather",
              "ska::pseudoalign"}


@pytest.mark.parametrize("query", ["fasta", "fastq_pair"])
def test_webapi_call_encloses_its_steps(inputs, tmp_path, query):
    """SkaData.map runs in one ska::call span that holds, on its thread,
    every step of the call: the per-sample build, the merge and map."""
    from ska_tpu_torch.webapi import SkaData

    sd = SkaData(inputs["ref"], k=17, device="cpu")
    files = ((inputs["samples"][0],) if query == "fasta" else inputs["fastq"])
    spans = _profile_spans(lambda: sd.map(*files), tmp_path)
    calls = [s for s in spans if s[0] == "ska::call"]
    assert len(calls) == 1
    assert {s[0] for s in _inside(spans, calls[0])} - {"ska::compile"} == CALL_SPANS


# the merged build's, the union's, the Gram's, neighbor joining's and
# the document's spans in a browser align call
ALIGN_CALL_SPANS = {"ska::parse", "ska::stage", "ska::to_device",
                    "ska::device_pass", "ska::to_host", "ska::union",
                    "ska::gram", "ska::nj", "ska::doc"}


@pytest.mark.parametrize("files", ["fasta", "fasta_and_pair"])
def test_align_call_encloses_its_steps(inputs, tmp_path, files):
    """AlignData.align runs in one ska::call span that holds, on its
    thread, every step of the call: the merged build, the union, the
    class Gram, neighbor joining and the document."""
    from ska_tpu_torch.webapi import AlignData

    ad = AlignData(k=17, device="cpu")
    paths = inputs["samples"] + (list(inputs["fastq"]) if files != "fasta" else [])
    spans = _profile_spans(lambda: ad.align(paths), tmp_path)
    calls = [s for s in spans if s[0] == "ska::call"]
    assert len(calls) == 1
    inside = _inside(spans, calls[0])
    assert {s[0] for s in inside} - {"ska::compile"} == ALIGN_CALL_SPANS
    assert sum(s[0] == "ska::gram" for s in inside) == 1


# the spans whose self times the benchmark reads: nothing may nest in
# them, or their metrics would shrink
SELF_TIMED = ("ska::parse", "ska::stage", "ska::to_device", "ska::device_pass",
              "ska::to_host", "ska::union", "ska::save", "ska::vcf", "ska::aln",
              "ska::gram", "ska::nj", "ska::doc")


@pytest.mark.parametrize("path", ["build_fasta", "build_fastq", "map_vcf",
                                  "map_aln", "webapi_map", "build_fastq_chunked",
                                  "webapi_align"])
def test_no_span_nests_in_a_self_timed_span(inputs, tmp_path, monkeypatch,
                                            capsys, path):
    """On the benchmark's six paths, no span but ska::compile opens
    inside a span whose self time a metric reads, on the same thread.
    The chunked reads build (the read pair cut into chunks) merges its
    chunks in one ska::chunk_merge inside ska::command."""
    monkeypatch.delenv("SKA_PROFILE", raising=False)
    if path == "build_fastq_chunked":
        monkeypatch.setenv("SKA_MAX_CHUNK_BASES", "40000")
    out = tmp_path / "out"
    if path == "webapi_map":
        from ska_tpu_torch.webapi import SkaData

        sd = SkaData(inputs["ref"], k=17, device="cpu")
        spans = _profile_spans(lambda: sd.map(inputs["samples"][0]), tmp_path)
    elif path == "webapi_align":
        from ska_tpu_torch.webapi import AlignData

        ad = AlignData(k=17, device="cpu")
        spans = _profile_spans(lambda: ad.align(inputs["samples"]), tmp_path)
    else:
        os.makedirs(out)
        if path in ("build_fastq", "build_fastq_chunked"):
            files = tmp_path / "reads.tsv"
            files.write_text("r\t%s\t%s\n" % inputs["fastq"])
            argv = ["build", "-f", str(files), "-k", "17", "--min-count", "5",
                    "--min-qual", "20", "-o", str(out / "out")]
        else:
            argv = _argv({"build_fasta": "build", "map_vcf": "map",
                          "map_aln": "map_aln"}[path], inputs, str(out))
        monkeypatch.setenv("SKA_PROFILE", str(tmp_path / "trace"))
        cli.main(argv + ["--device", "cpu"])
        (trace,) = os.listdir(tmp_path / "trace")
        spans = _spans(str(tmp_path / "trace" / trace))
    timed = [s for s in spans if s[0] in SELF_TIMED]
    assert timed
    nested = [(s[0], t[0]) for s in timed for t in _inside(spans, s)
              if t[0] != "ska::compile"]
    assert nested == []
    merges = [s for s in spans if s[0] == "ska::chunk_merge"]
    assert len(merges) == (path == "build_fastq_chunked")
    if merges:
        (command,) = [s for s in spans if s[0] == "ska::command"]
        assert merges[0] in _inside(spans, command)


def test_compile_span_only_for_a_compiler_run(tmp_path):
    """A forced rebuild through kernels._compile records one ska::compile
    span; a call that finds the library up to date records none."""
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int ska_probe() { return 7; }\n')
    so = str(tmp_path / "lib" / "libprobe.so")

    def compile_():
        kernels._compile(kernels._gxx(), kernels.GXX_FLAGS, [str(src)], so)

    def compiles():
        return sum(s[0] == "ska::compile" for s in _profile_spans(compile_, tmp_path))

    assert compiles() == 1
    assert ctypes.CDLL(so).ska_probe() == 7
    assert compiles() == 0
