"""Helpers of the benchmark's CPU tests."""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a size a test run holds: 20 kb genomes (a 19 kb chromosome and a 1 kb
# plasmid), 4 assemblies and a map reference, one read pair
TINY = {"genome_bases": 20000, "chromosome_bases": 19000, "n_run": [10, 100]}


def make_root(tmp_path, sizes=TINY, samples=None):
    """A checkout of the benchmark alone (BENCHMARK.json and skabench/)
    whose configurations are cut to sizes."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "skabench"), root / "skabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["inputs"].update(sizes)
        n = (samples or {}).get(cfg["inputs"]["kind"])
        if n is None:
            n = 1 if cfg["inputs"]["kind"] == "reads" else 4
        cfg["samples"] = n
        path.write_text(json.dumps(cfg))
    return root


def run_cell(root, workload, seed=7, seconds=0.3, trace=0):
    """(exit code, last line as JSON or None, stdout) of one CPU run."""
    import contextlib
    import io
    import time

    from skabench import core

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = core.run(["--workload", workload, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], time.perf_counter(),
                      root=str(root), device="cpu", need_card=False)
    lines = out.getvalue().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        last = None
    return rc, last, out.getvalue()
