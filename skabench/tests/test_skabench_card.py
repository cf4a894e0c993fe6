"""Each cell, run as the benchmark's command on a CUDA card for a short
window, is correct and names the card (skips without one)."""

import json
import subprocess
import sys

import pytest
from skabench_helpers import ROOT

CELLS = ["asm_k31.build", "reads_k31.build", "asm_k31.map_vcf", "asm_k31.webapi_map"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    r = subprocess.run([sys.executable, "skabench/run.py", "--workload", cell,
                        "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
