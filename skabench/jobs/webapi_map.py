"""Job kind ``webapi_map``: the browser mapper of one interactive user,
``ska_tpu_torch.webapi.SkaData``. Set-up indexes the map reference
(``SkaData(reference, k)``); each call maps the next cohort FASTA in
turn and returns its JSON document.

End to end, ``query_p95_ms``: the 95th percentile (nearest rank) of the
latencies of all calls finished in the window. Checked: every call's
document against the plain reference's for its input.
"""

import math
import time
from concurrent.futures import ThreadPoolExecutor

from skabench import core
from skabench.peaks import key_words
from skabench.reference import build, mapping


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.queries = [p for _, p, _ in ctx.inputs["samples"]]

    def setup(self):
        from ska_tpu_torch.webapi import SkaData

        self.sd = SkaData(self.ctx.inputs["map_reference"],
                          k=self.ctx.cfg["build"]["k"], device=self.ctx.device)

    def warm(self):
        for i in range(int(self.ctx.traffic.get("warm_calls", 1))):
            self.run_one(i)

    def run_one(self, i):
        q = i % len(self.queries)
        t = time.perf_counter()
        doc = self.sd.map(self.queries[q])
        self.ctx.sync()
        dt = time.perf_counter() - t
        return {"seconds": dt, "index": i, "query": q, "digest": core.digest(doc)}

    def metrics(self, records, window_s):
        ok = [r for r in records if r["ok"]]
        lat = sorted(r["seconds"] for r in ok)
        print(f"skabench: {len(lat)} calls finished in the window")
        if not lat:
            return {}
        q = [1e3 * lat[min(len(lat) - 1, int(f * len(lat)))] for f in (0, .5, .9, .99)]
        slow = sorted(ok, key=lambda r: -r["seconds"])[:10]
        print("skabench: call ms min %.1f median %.1f p90 %.1f p99 %.1f max %.1f; "
              "slowest (call, query, ms): %s" % (*q, 1e3 * lat[-1], [
                  (r["index"], r["query"], round(1e3 * r["seconds"], 1)) for r in slow]))
        return {"query_p95_ms": 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]}

    def release(self):
        del self.sd

    def check(self, records):
        cfg = self.ctx.cfg
        ref = mapping.Reference(self.ctx.inputs["map_reference"], cfg["build"]["k"],
                                cfg["build"]["rc"])
        self.ctx.stats = {"queries": len(ref.keys), "W": key_words(cfg["build"]["k"])}

        def expected(q):
            keys, sets = build.sample(cfg, self.queries[q], None)
            return q, core.digest(mapping.query_json(ref, keys, sets))

        used = sorted({r["query"] for r in records if r["ok"]})
        with ThreadPoolExecutor(8) as pool:  # numpy drops the GIL
            want = dict(pool.map(expected, used))
        return {"calls_differing": sum(r["digest"] != want[r["query"]]
                                       for r in records if r["ok"])}
