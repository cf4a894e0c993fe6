"""Job kind ``map``: ``ska map <reference> <cohort.skf> -f vcf``,
called in process as ``ska_tpu_torch.cli.main``. Set-up builds the
cohort's `.skf` once with the program; each job overwrites one output.

End to end, ``map_s``: the window's time over the jobs finished in it.
Checked: the VCF of the last job against the plain reference, which
works out the cohort's table again from the FASTA files, and every
job's bytes against it.
"""

import os

from skabench import core
from skabench.peaks import key_words
from skabench.reference import build, mapping


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        inp = ctx.inputs
        self.prefix = os.path.join(ctx.workdir, "cohort")
        self.out = os.path.join(ctx.workdir, "out.vcf")
        self.k = str(ctx.cfg["build"]["k"])
        self.argv = ["map", inp["map_reference"], self.prefix + ".skf", "-f",
                     "vcf", "-o", self.out, "--device", ctx.device]

    def setup(self):
        from ska_tpu_torch import cli

        self.cli = cli
        cli.main(["build", *[p for _, p, _ in self.ctx.inputs["samples"]],
                  "-k", self.k, "-o", self.prefix, "--device", self.ctx.device])

    def warm(self):
        self.run_one(-1)

    def run_one(self, i):
        return core.timed_command(self.ctx, self.cli, self.argv, self.out, i)

    def metrics(self, records, window_s):
        ok = sum(r["ok"] for r in records)
        return {"map_s": window_s / ok} if ok else {}

    def release(self):
        pass

    def check(self, records):
        cfg, inp = self.ctx.cfg, self.ctx.inputs
        exp = build.expected(cfg, inp)
        ref = mapping.Reference(inp["map_reference"], cfg["build"]["k"],
                                cfg["build"]["rc"])
        self.ctx.stats = {"table_keys": len(exp["keys"]), "queries": len(ref.keys),
                          "W": key_words(cfg["build"]["k"])}
        want = mapping.vcf(ref, exp["names"], exp["keys"], exp["variants"])
        try:
            with open(self.out) as f:
                got = f.read()
        except OSError:
            got = ""
        checks = {"vcf_lines_differing": mapping.lines_differing(want, got)}
        final = core.file_digest(self.out) if os.path.exists(self.out) else None
        checks["jobs_output_differing"] = sum(
            r["digest"] != final for r in records if r["ok"])
        return checks
