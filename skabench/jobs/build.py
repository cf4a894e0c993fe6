"""Job kind ``build``: ``ska build`` of the cohort, called in process as
``ska_tpu_torch.cli.main`` (the path of ``python -m ska_tpu_torch``),
writing one `.skf` that each job overwrites.

End to end, ``build_kmers_per_s``: the window starts (split k-mers) of
every record of the inputs, times the finished jobs, over those jobs'
wall time from parse to the saved `.skf`. Checked: the `.skf` of the
last job against the plain reference, and every job's bytes against it.
"""

import os
import time

from skabench import core
from skabench.peaks import key_words
from skabench.reference import build as reference


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        inp = ctx.inputs
        src = (["-f", inp["file_list"]] if inp["file_list"]
               else [p for _, p, _ in inp["samples"]])
        prefix = os.path.join(ctx.workdir, "cohort")
        self.out = prefix + ".skf"
        self.argv = ["build", *src, "-k", str(ctx.cfg["build"]["k"]), "-o",
                     prefix, "--device", ctx.device]

    def setup(self):
        from ska_tpu_torch import cli

        self.cli = cli

    def warm(self):
        self.run_one(-1)

    def run_one(self, i):
        return core.timed_command(self.ctx, self.cli, self.argv, self.out, i)

    def metrics(self, records, window_s):
        ok = [r for r in records if r["ok"]]
        if not ok:
            return {}
        return {"build_kmers_per_s": self.ctx.inputs["windows"] * len(ok)
                / sum(r["seconds"] for r in ok)}

    def release(self):
        pass

    def check(self, records):
        t = time.perf_counter()
        exp = reference.expected(self.ctx.cfg, self.ctx.inputs)
        print(f"skabench: the reference's array took {time.perf_counter() - t:.3f} s")
        self.ctx.stats = {"rows": len(exp["keys"]), "samples": len(exp["names"]),
                          "W": key_words(self.ctx.cfg["build"]["k"])}
        checks = reference.compare(exp, self.out)
        final = core.file_digest(self.out) if os.path.exists(self.out) else None
        checks["jobs_output_differing"] = sum(
            r["digest"] != final for r in records if r["ok"])
        return checks
