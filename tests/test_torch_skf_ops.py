"""The port's `ska merge`, `ska delete` and `ska nk` on the CPU, against
`./ska.py` (SKA_NATIVE_CMDS=0: the JAX package's Python route).

The .skf inputs are built once with ska_tpu.api.build (the JAX
pipeline) from a small cohort made with numpy. The port runs through
ska_tpu_torch.cli.main, the function `python -m ska_tpu_torch` calls
(three cases run that module in a process of its own, importing
neither jax nor ska_tpu); `./ska.py` runs in a process of its own.
Output files and stdout must be byte-equal:

- `merge` of two files and of three, and of a .skf whose rows are not
  in key order; the k mismatch, strand mismatch and one-file errors;
- `delete` of one name and of names from `-f`, in place and with `-o`;
  the unknown-name and every-name errors;
- `nk` and `nk --full-info` at k=17 (W=1) and k=41 (W=2).
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ska_tpu import api as japi
from ska_tpu.io import skf as jskf
from ska_tpu.sampletypes import QualOpts
from ska_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN = {"SKA_NATIVE_BUILD": "0", "SKA_NATIVE_CMDS": "0", "SKA_DISTRIBUTED": "0"}
REF = [sys.executable, os.path.join(REPO, "ska.py")]
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _pin_jax_path(monkeypatch):
    for var, val in PIN.items():
        monkeypatch.setenv(var, val)


@pytest.fixture(scope="module")
def skfs(tmp_path_factory):
    """.skf files of a 5-genome cohort (3 kb each, SNPs, an IUPAC letter
    and an N run): all five at k=17 and k=41, subsets for merge at k=17,
    one at k=21 and one single-strand."""
    d = tmp_path_factory.mktemp("skf")
    rng = np.random.default_rng(17)
    base = rng.choice(ACGT, size=3000)
    files = []
    for s in range(5):
        g = base.copy()
        snp = rng.choice(len(g), 30, replace=False)
        g[snp] = rng.choice(ACGT, size=30)
        g[rng.integers(0, len(g))] = ord("R")
        a = int(rng.integers(0, len(g) - 50))
        g[a : a + 20] = ord("N")
        path = d / f"s{s}.fa"
        path.write_bytes(b">s%d\n" % s + g.tobytes() + b"\n")
        files.append((f"s{s}", str(path), None))

    def build(name, idx, k, rc=True):
        arr = japi.build([files[i] for i in idx], k, rc, QualOpts())
        return jskf.save(arr, str(d / name))

    return {
        "all17": build("all17", range(5), 17),
        "all41": build("all41", range(5), 41),
        "a": build("a", [0, 1], 17),
        "b": build("b", [2, 3], 17),
        "c": build("c", [4], 17),
        "k21": build("k21", [4], 21),
        "single": build("single", [4], 17, rc=False),
    }


def _port(args, capsys):
    """The port's CLI in this process: (stdout, stderr)."""
    capsys.readouterr()
    cli.main(args + ["--device", "cpu"])
    return capsys.readouterr()


def _port_process(args, cwd):
    """`python -m ska_tpu_torch ... --device cpu` in a process of its own;
    checks that it imports neither jax nor ska_tpu."""
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ska_tpu_torch", *args,
         "--device", "cpu"],
        cwd=cwd, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    imported = re.findall(r"\|\s+([\w.]+)\s*$", r.stderr.decode(), re.M)
    assert "ska_tpu_torch.cli" in imported
    assert not [m for m in imported if m in ("jax", "ska_tpu")
                or m.startswith(("jax.", "ska_tpu."))]
    return r.stdout


def _ska_py(args, cwd, rc=0):
    r = subprocess.run(REF + args, cwd=cwd, capture_output=True, timeout=300,
                       env=dict(os.environ, **PIN, JAX_PLATFORMS="cpu"))
    assert r.returncode == rc, r.stderr.decode()[-2000:]
    return r


def _same(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read()
    return data


# ------------------------------------------------------------ merge


@pytest.mark.parametrize("inputs", [("a", "b"), ("a", "b", "c")])
def test_merge_matches_ska_py(skfs, tmp_path, capsys, inputs):
    paths = [skfs[i] for i in inputs]
    if len(inputs) == 3:
        _port_process(["merge", *paths, "-o", str(tmp_path / "port")], REPO)
    else:
        _port(["merge", *paths, "-o", str(tmp_path / "port")], capsys)
    _ska_py(["merge", *paths, "-o", str(tmp_path / "ref")], tmp_path)
    _same(tmp_path / "port.skf", tmp_path / "ref.skf")


def test_merge_unsorted_rows_matches_ska_py(skfs, tmp_path, capsys):
    arr = jskf.load(skfs["b"])
    perm = np.random.default_rng(3).permutation(arr.ksize)
    arr.keys, arr.variants, arr.counts = (
        arr.keys[perm], arr.variants[perm], arr.counts[perm])
    shuffled = jskf.save(arr, str(tmp_path / "shuffled"))
    keys = jskf.load(shuffled).keys[:, 0]
    assert not np.all(keys[1:] >= keys[:-1])
    args = ["merge", skfs["a"], shuffled, "-o"]
    _port(args + [str(tmp_path / "port")], capsys)
    _ska_py(args + [str(tmp_path / "ref")], tmp_path)
    _same(tmp_path / "port.skf", tmp_path / "ref.skf")


@pytest.mark.parametrize("other,error,message", [
    ("k21", ValueError, "K-mer lengths do not match: 21 17"),
    ("single", ValueError, "Strand use inconsistent"),
    (None, SystemExit, "Need at least two files to merge"),
])
def test_merge_errors_match_ska_py(skfs, tmp_path, capsys, other, error,
                                   message):
    paths = [skfs["a"]] + ([skfs[other]] if other else [])
    args = ["merge", *paths, "-o", str(tmp_path / "out")]
    with pytest.raises(error) as e:
        _port(args, capsys)
    got = str(e.value.code if error is SystemExit else e.value)
    assert got == message
    r = _ska_py(args, tmp_path, rc=1)
    last = r.stderr.decode().rstrip("\n").split("\n")[-1]
    assert last == (message if error is SystemExit else f"ValueError: {message}")
    assert not (tmp_path / "out.skf").exists()


# ------------------------------------------------------------ delete


@pytest.mark.parametrize("from_list", [False, True])
@pytest.mark.parametrize("in_place", [True, False])
def test_delete_matches_ska_py(skfs, tmp_path, capsys, from_list, in_place):
    out = {}
    for side in ("port", "ref"):
        src = str(tmp_path / f"{side}_in.skf")
        shutil.copy(skfs["all17"], src)
        if from_list:
            lst = tmp_path / f"{side}_names.txt"
            lst.write_text("s1\ts1.fa\ns3\ts3.fa\n")
            names = ["-f", str(lst)]
        else:
            names = ["s2"]
        dest = [] if in_place else ["-o", str(tmp_path / f"{side}_out")]
        args = ["delete", "-s", src, *dest, *names]
        if side == "ref":
            _ska_py(args, tmp_path)
        elif from_list and not in_place:
            _port_process(args, REPO)
        else:
            _port(args, capsys)
        out[side] = src if in_place else str(tmp_path / f"{side}_out.skf")
    data = _same(out["port"], out["ref"])
    assert data != open(skfs["all17"], "rb").read()
    left = jskf.load(out["port"]).names
    assert left == (["s0", "s2", "s4"] if from_list else ["s0", "s1", "s3", "s4"])


@pytest.mark.parametrize("names,message", [
    (["s1", "nobody"], "Could not find sample(s): ['nobody']"),
    (["s0", "s1", "s2", "s3", "s4"], "Invalid number of samples to remove"),
])
def test_delete_errors_match_ska_py(skfs, tmp_path, capsys, names, message):
    args = ["delete", "-s", skfs["all17"], "-o", str(tmp_path / "out"), *names]
    with pytest.raises(ValueError) as e:
        _port(args, capsys)
    assert str(e.value) == message
    r = _ska_py(args, tmp_path, rc=1)
    assert r.stderr.decode().rstrip("\n").split("\n")[-1] == f"ValueError: {message}"


# ------------------------------------------------------------ nk


@pytest.mark.parametrize("full_info", [False, True])
@pytest.mark.parametrize("k", [17, 41])
def test_nk_matches_ska_py(skfs, tmp_path, capsys, k, full_info):
    args = ["nk", skfs[f"all{k}"]] + (["--full-info"] if full_info else [])
    if k == 41 and full_info:
        got = _port_process(args, REPO)
    else:
        got = _port(args, capsys).out.encode()
    want = _ska_py(args, tmp_path).stdout
    assert got == want
    lines = got.decode().split("\n")
    assert lines[4] == f"k-mers={jskf.load(skfs[f'all{k}']).ksize}"
    assert lines[5] == "samples=5"
    if full_info:
        n = jskf.load(skfs[f"all{k}"]).ksize
        rows = [ln for ln in lines[9:] if ln]
        assert len(rows) == n
        assert all(len(r) == (k - 1) + 2 + 9 for r in rows)
