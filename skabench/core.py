"""The benchmark of ska_tpu_torch: one run of one cell.

``python3 skabench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads the cell from BENCHMARK.json and finds by name
everything that belongs to it:

- ``skabench/configs/<config>.json`` (the file BENCHMARK.json names):
  the deployment, its input generator's parameters and build settings;
- ``skabench/gen/<inputs kind>.py``: makes the inputs from the seed;
- ``skabench/traffic/<traffic>.json``: the job kind and its parameters;
- ``skabench/jobs/<job>.py``: one job of that kind on the program, its
  end-to-end metrics and its check against the plain reference;
- ``skabench/metrics/<metric>.py``: one per-layer metric, read from the
  traced window.

A run makes its inputs in a fresh directory under TMPDIR, sets up and
warms up on the cell's own job (``setup_s``, from the start of the
process), then runs jobs back to back, one client, while ``--seconds``
have not passed (a job that starts runs to its end). Once the window
has closed it reads the card's memory peak over the window, frees the
program's state, checks every job's output against the reference and
prints, as the last line of standard output, one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the numbers compared
with their limits (also the last lines of standard error). Without as
many CUDA cards as the cell asks for, or with JAX or the JAX package
loaded, it prints no result and exits with another code than 0.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ska_tpu")


class Refused(Exception):
    """A run that may print no result; the message goes to stderr."""


def forbidden_modules():
    """Top-level names of loaded modules that a run may not load, each
    compared whole (ska_tpu_torch is not ska_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _check_modules(when: str):
    found = forbidden_modules()
    if found:
        raise Refused(f"skabench: {', '.join(found)} loaded {when}")


def load_module(root: str, kind: str, name: str):
    """skabench/<kind>/<name>.py of the checkout at root, by file."""
    path = os.path.join(root, "skabench", kind, f"{name}.py")
    if not os.path.exists(path):
        raise Refused(f"skabench: no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"skabench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise Refused(f"skabench: no {what} named {name!r} in BENCHMARK.json")


def cell_plan(root: str, workload: str):
    """(spec, cell, config, traffic, end-to-end metrics, per-layer
    metrics) of one cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = _entry(spec["workloads"], workload, "workload")
    entry = _entry(spec["configs"], cell["config"], "config")
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "skabench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m["workloads"] or (
                     "workloads" not in m and m["moves"] in e2e_names)]
    return spec, cell, cfg, traffic, e2e, per_layer


class Ctx:
    """What a job module gets: the configuration, the traffic, the
    inputs, a directory of its own and the device."""

    def __init__(self, cfg, traffic, inputs, workdir, device):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.workdir, self.device = workdir, device
        self.stats = {}  # what the reference counted, for the metrics

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()


def digest(data) -> str:
    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha1(data).hexdigest()


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def timed_command(ctx, cli, argv, out: str, i: int) -> dict:
    """One CLI command in process, timed from its call to the card's
    last work, that has to write out (removed first)."""
    if os.path.exists(out):
        os.remove(out)
    t = time.perf_counter()
    cli.main(argv)
    ctx.sync()
    dt = time.perf_counter() - t
    if not os.path.exists(out):
        raise RuntimeError(f"{argv[0]} wrote no {os.path.basename(out)}")
    return {"seconds": dt, "index": i, "digest": file_digest(out)}


def attempt(job, i: int) -> dict:
    """One job; a job that raises or exits is a failed one."""
    try:
        rec = job.run_one(i)
        rec["ok"] = True
    except (Exception, SystemExit):  # a failed job is counted, not fatal
        traceback.print_exc()
        rec = {"ok": False, "seconds": 0.0, "index": i}
    return rec


def _power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _bytes_written():
    try:
        with open("/proc/self/io") as f:
            return dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return {}


def run(argv, started: float, root: str = ROOT, device: str = "cuda",
        need_card: bool = True) -> int:
    """One run; returns the exit code. need_card False (the CPU tests)
    skips the look for a card and runs the program on ``device``."""
    p = argparse.ArgumentParser(prog="skabench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        return _run(args, started, root, device, need_card)
    except Refused as e:
        print(str(e), file=sys.stderr)
        return 3


def _run(args, started, root, device, need_card):
    _, cell, cfg, traffic, e2e, per_layer = cell_plan(root, args.workload)
    _check_modules("at start-up")
    import torch

    if need_card:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(cell["chips"]):
            raise Refused(f"skabench: {args.workload} needs {cell['chips']} "
                          f"CUDA card(s); torch finds {n}")
    threads = len(os.sched_getaffinity(0))
    os.environ["SKA_THREADS"] = str(threads)
    print(f"skabench: {args.workload} seed {args.seed}, SKA_THREADS={threads}")
    workdir = tempfile.mkdtemp(prefix="skabench-")
    try:
        return _measure(args, started, root, device, cell, cfg, traffic, e2e,
                        per_layer, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _measure(args, started, root, device, cell, cfg, traffic, e2e, per_layer,
             workdir):
    import torch
    from torch.profiler import record_function

    from skabench.trace import Trace

    gen = load_module(root, "gen", cfg["inputs"]["kind"])
    inputs = gen.make(cfg, workdir, args.seed)
    ctx = Ctx(cfg, traffic, inputs, workdir, device)
    job = load_module(root, "jobs", traffic["job"]).Job(ctx)
    job.setup()
    try:
        job.warm()
    except (Exception, SystemExit):  # the window's jobs fail and count
        traceback.print_exc()
    ctx.sync()
    setup_s = time.perf_counter() - started
    if device.startswith("cuda"):
        # memory_peak_bytes is the window's own: not set-up's work, such
        # as the map cell's build of its .skf
        torch.cuda.reset_peak_memory_stats(0)

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    records = []
    t0 = time.perf_counter()
    with record_function("skabench::window"):
        while time.perf_counter() - t0 < args.seconds:
            with record_function("skabench::job"):
                records.append(attempt(job, len(records)))
    window_s = time.perf_counter() - t0
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
        os.remove(path)

    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}
    if cuda:
        dev["power_limit_w"] = _power_limit()
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    job.release()
    if cuda:
        torch.cuda.empty_cache()

    failed = sum(not r["ok"] for r in records)
    print(f"skabench: {len(records)} jobs in {window_s:.3f} s, {failed} failed")
    t = time.perf_counter()
    checks = {"jobs_failed": failed, **job.check(records)}
    print(f"skabench: the reference and the comparison took "
          f"{time.perf_counter() - t:.3f} s")
    limits = {name: 0 for name in checks}  # every comparison is exact
    correct = bool(records) and all(checks[n] <= limits[n] for n in checks)

    metrics = {}
    if trace is None:
        values = {"setup_s": setup_s, **job.metrics(records, window_s)}
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run_info = {"jobs": trace.jobs(), "inputs": ctx.inputs, "stats": ctx.stats}
        for m in per_layer:
            v = load_module(root, "metrics", m["name"]).read(trace, run_info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    io = _bytes_written()
    print(f"skabench: setup_s {setup_s}, bytes written {io.get('write_bytes')} "
          f"(wchar {io.get('wchar')})")
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace.breakdown(traffic["job"])
    result["checks"] = {n: {"value": checks[n], "limit": limits[n]} for n in checks}
    _check_modules("once the window has closed")
    for n in checks:
        print(f"skabench: check {n} = {checks[n]} (limit {limits[n]})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
