"""The input generators: the same seed gives the same bytes, another
seed other bytes, every seed the same sizes."""

import json
import os

from skabench_helpers import ROOT, TINY

from skabench.gen import assemblies, reads


def _cfg(name):
    with open(os.path.join(ROOT, "skabench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["inputs"].update(TINY)
    cfg["samples"] = 2
    return cfg


def _files(inputs):
    paths = [p for s in inputs["samples"] for p in s[1:] if p]
    if inputs["map_reference"]:
        paths.append(inputs["map_reference"])
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def test_generators_reproducible_and_seeded(tmp_path):
    for name, gen in (("asm_k31", assemblies), ("reads_k31", reads)):
        cfg = _cfg(name)
        runs = []
        for i, seed in enumerate((11, 11, 2**31 + 12)):
            d = tmp_path / f"{name}{i}"
            d.mkdir()
            inputs = gen.make(cfg, str(d), seed)
            runs.append((inputs, _files(inputs)))
        (a, fa), (b, fb), (c, fc) = runs
        assert fa == fb
        assert all(x != y for x, y in zip(fa, fc))
        assert a["windows"] == b["windows"] > 0 and a["bases"] == b["bases"]
        # every seed the same sizes: the record layout is fixed and only
        # indels move a length by a few bases
        assert abs(c["windows"] - a["windows"]) < 0.01 * a["windows"]
        assert all(abs(len(x) - len(y)) < 0.01 * len(x) for x, y in zip(fa, fc))


def test_reads_counts(tmp_path):
    cfg = _cfg("reads_k31")
    inputs = reads.make(cfg, str(tmp_path), 5)
    read_len = cfg["inputs"]["read_len"]
    windows = 0
    for _, fwd, rev in inputs["samples"]:
        with open(fwd, "rb") as f, open(rev, "rb") as g:
            n_fwd, n_rev = f.read().count(b"\n") // 4, g.read().count(b"\n") // 4
        assert n_fwd == n_rev
        # 30x of a ~20 kb genome in pairs of 2 x 150
        assert abs(n_fwd - 30 * 20000 // 300) < 10
        windows += 2 * n_fwd * (read_len - 31 + 1)
    assert inputs["windows"] == windows
    with open(inputs["file_list"]) as f:
        assert [line.split("\t")[0] for line in f] == ["genome00", "genome01"]
