"""Job kind ``build_u128``: the ``build`` job (jobs/build.py) for a
cohort built at k > 31, where ska.rust types keys as u128: the same
``ska build`` loop, checked against the plain 128-bit reference
(reference/build_wide.py) in place of the 64-bit one.

End to end, ``build_kmers_per_s``, as in ``build``. Checked: the `.skf`
of the last job against the reference, and every job's bytes against it.
"""

import os
import time

from skabench import core
from skabench.jobs import build
from skabench.reference import build_wide as reference


class Job(build.Job):
    def check(self, records):
        t = time.perf_counter()
        exp = reference.expected(self.ctx.cfg, self.ctx.inputs)
        print(f"skabench: the reference's array took {time.perf_counter() - t:.3f} s")
        self.ctx.stats = {"rows": len(exp["keys"]), "samples": len(exp["names"]),
                          "W": 2}
        checks = reference.compare(exp, self.out)
        final = core.file_digest(self.out) if os.path.exists(self.out) else None
        checks["jobs_output_differing"] = sum(
            r["digest"] != final for r in records if r["ok"])
        return checks
