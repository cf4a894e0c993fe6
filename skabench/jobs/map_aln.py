"""Job kind ``map_aln``: the ``map`` job (jobs/map.py) with upstream's
default output, ``ska map <reference> <cohort.skf> -f aln``: the
pseudoalignment that users pass to tree inference. Set-up builds the
cohort's `.skf` once with the program; each job overwrites one output.

End to end, ``map_s``, as in ``map``. Checked: the aln of the last job
against the plain reference (reference/aln.py), which works out the
cohort's table again from the FASTA files, and every job's bytes
against it.
"""

import os

from skabench import core
from skabench.jobs import map as map_job
from skabench.peaks import key_words
from skabench.reference import aln, build, mapping


class Job(map_job.Job):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.out = os.path.join(ctx.workdir, "out.aln")
        self.argv = ["map", ctx.inputs["map_reference"], self.prefix + ".skf",
                     "-f", "aln", "-o", self.out, "--device", ctx.device]

    def check(self, records):
        cfg, inp = self.ctx.cfg, self.ctx.inputs
        exp = build.expected(cfg, inp)
        ref = mapping.Reference(inp["map_reference"], cfg["build"]["k"],
                                cfg["build"]["rc"])
        self.ctx.stats = {"table_keys": len(exp["keys"]), "queries": len(ref.keys),
                          "W": key_words(cfg["build"]["k"])}
        want = aln.aln(ref, exp["names"], exp["keys"], exp["variants"])
        try:
            with open(self.out, "rb") as f:
                got = f.read()
        except OSError:
            got = b""
        checks = {"aln_lines_differing": aln.lines_differing(want, got)}
        final = core.file_digest(self.out) if os.path.exists(self.out) else None
        checks["jobs_output_differing"] = sum(
            r["digest"] != final for r in records if r["ok"])
        return checks
