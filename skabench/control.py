"""The control of each cell: the plain reference put in the program's
place with one guarantee of the configuration broken, compared with the
true reference by the cell's own comparison. The guarantee broken is
exact keys: split k-mers are told apart by a 32-bit fingerprint
(kmers.fingerprint), as a hash table keyed by 32 bits would tell them
apart. Each cell's comparison has to fail it.

    python3 skabench/control.py --workload <cell> --seeds <a,b,c>

prints, for each seed, the numbers that the cell compares (limit 0).
The benchmark's runs never run it.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from skabench import core  # noqa: E402
from skabench.reference import build, mapping  # noqa: E402


def readings(job: str, cfg: dict, inputs: dict) -> dict:
    """The cell's numbers for the control's output in place of the
    program's."""
    k, rc = cfg["build"]["k"], cfg["build"]["rc"]
    if job == "build":
        exp = build.expected(cfg, inputs)
        ctl = build.expected(cfg, inputs, control=True)
        ctl["keys"] = ctl["keys"][:, None]
        return build.compare_arrays(exp, ctl)
    ref = mapping.Reference(inputs["map_reference"], k, rc)
    if job == "map":
        exp = build.expected(cfg, inputs)
        ctl = build.expected(cfg, inputs, control=True)
        want = mapping.vcf(ref, exp["names"], exp["keys"], exp["variants"])
        got = mapping.vcf(ref, ctl["names"], ctl["keys"], ctl["variants"],
                          control=True)
        return {"vcf_lines_differing": mapping.lines_differing(want, got)}
    if job == "webapi_map":
        differ = 0
        for _, path, _ in inputs["samples"]:
            keys, sets = build.sample(cfg, path, None)
            differ += (mapping.query_json(ref, keys, sets)
                       != mapping.query_json(ref, keys, sets, control=True))
        return {"calls_differing": differ}
    raise ValueError(f"no control for job kind {job!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="skabench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    _, cell, cfg, traffic, _, _ = core.cell_plan(core.ROOT, args.workload)
    gen = core.load_module(core.ROOT, "gen", cfg["inputs"]["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="skabench-control-")
        try:
            inputs = gen.make(cfg, workdir, seed)
            print(f"control {args.workload} seed {seed}: "
                  f"{readings(traffic['job'], cfg, inputs)}", flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
