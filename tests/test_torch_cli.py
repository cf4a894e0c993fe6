"""The port's CLI wrapper against ska_tpu.cli's (ska_tpu_torch/cli.py::main).

- `map ... -f vcf` whose stdout is closed after 10 bytes exits 141 with
  no traceback, as ./ska.py does, also with PYTHONUNBUFFERED while the
  writer waits on a full pipe;
- the banner and the `SKA done in Ns` footer with its two lines go to
  stderr;
- `--threads N` sets SKA_THREADS for every subcommand that takes it;
- a MemoryError with guidance prints `Error: <guidance>` and exits 1; a
  bare one keeps its traceback.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from ska_tpu_torch import api as tapi
from ska_tpu_torch import cli
from ska_tpu_torch.io import skf
from ska_tpu_torch.sampletypes import QualOpts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = [sys.executable, "-m", "ska_tpu_torch"]
ACGT = np.frombuffer(b"ACGT", np.uint8)
FOOTER = ["⬛⬜⬛⬜⬛⬜⬛", "⬜⬛⬜⬛⬜⬛⬜"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A 60 kb reference and four samples with ~3% SNPs each (a VCF of a
    few hundred kB), built into an .skf: (reference path, .skf path)."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    ref = rng.choice(ACGT, size=60_000)
    (d / "ref.fa").write_bytes(b">ref\n" + ref.tobytes() + b"\n")
    files = []
    for i in range(4):
        g = ref.copy()
        snp = rng.random(len(g)) < 0.03
        g[snp] = ACGT[(np.searchsorted(ACGT, g[snp]) + 1 + i % 3) % 4]
        (d / f"s{i}.fa").write_bytes(b">s\n" + g.tobytes() + b"\n")
        files.append((f"s{i}", str(d / f"s{i}.fa"), None))
    arr = tapi.build(files, 17, True, QualOpts(), device="cpu")
    return str(d / "ref.fa"), skf.save(arr, str(d / "cohort"))


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_closed_stdout_exits_141_without_traceback(cohort):
    ref, skf_path = cohort
    p = subprocess.Popen(PORT + ["map", ref, skf_path, "-f", "vcf", "--device", "cpu"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=_env(), cwd=REPO)
    try:
        head = p.stdout.read(10)
        p.stdout.close()
        err = p.stderr.read()
        rc = p.wait(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert head == b"##fileform"
    assert rc == 141, err.decode()
    assert b"Traceback" not in err and b"Exception" not in err


def test_closed_unbuffered_stdout_exits_141(cohort):
    """With PYTHONUNBUFFERED the VCF still reaches the pipe in pieces a
    pipe takes whole: a reader that closes after 10 bytes, while the
    writer waits on the full pipe, fails the next piece."""
    ref, skf_path = cohort
    p = subprocess.Popen(PORT + ["map", ref, skf_path, "-f", "vcf", "--device", "cpu"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=dict(_env(), PYTHONUNBUFFERED="1"), cwd=REPO)
    try:
        head = os.read(p.stdout.fileno(), 10)
        time.sleep(0.5)
        p.stdout.close()
        err = p.stderr.read()
        rc = p.wait(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert head == b"##fileform"
    assert rc == 141, err.decode()
    assert b"Traceback" not in err


def test_banner_and_footer_on_stderr(cohort, tmp_path):
    _, skf_path = cohort
    r = subprocess.run(PORT + ["align", skf_path, "-o", str(tmp_path / "a.aln"),
                               "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, env=_env(),
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    lines = r.stderr.splitlines()
    assert lines[0] == "SKA: Split K-mer Analysis (the alignment-free aligner)"
    assert re.fullmatch(r"SKA done in \d+s", lines[-3])
    assert lines[-2:] == FOOTER
    assert r.stdout == ""


@pytest.mark.parametrize("cmd", ["align", "map", "distance"])
def test_threads_sets_ska_threads(cohort, tmp_path, monkeypatch, cmd):
    ref, skf_path = cohort
    # an inherited value, restored after the test; --threads wins over it
    monkeypatch.setenv("SKA_THREADS", "1")
    out = str(tmp_path / "out")
    argv = {"align": ["align", skf_path], "map": ["map", ref, skf_path],
            "distance": ["distance", skf_path]}[cmd]
    cli.main(argv + ["-o", out, "--threads", "3", "--device", "cpu"])
    assert os.environ["SKA_THREADS"] == "3"
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("msg", ["too many bubbles: raise --depth", ""])
def test_memory_error(monkeypatch, capsys, msg):
    def oom(args, device):
        raise MemoryError(msg)

    monkeypatch.setattr(cli, "_run", oom)
    argv = ["distance", "x.skf", "--device", "cpu"]
    if msg:
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 1
        assert capsys.readouterr().err.splitlines()[-1] == f"Error: {msg}"
    else:
        with pytest.raises(MemoryError):
            cli.main(argv)
