"""Job kind ``webapi_align``: the browser's reference-free aligner of one
interactive user, ``ska_tpu_torch.webapi.AlignData``. Each call makes a
fresh ``AlignData(k)`` and returns the document of one ``align()`` of
every cohort FASTA file, in cohort order.

End to end, ``query_p95_ms``: the 95th percentile (nearest rank) of the
latencies of all calls finished in the window, as in ``webapi_map``.
Checked against the plain reference (reference/webalign.py): each
call's document (``calls_differing``), and its ``alignment`` and
``newick`` alone (``alignment_differing``, ``newick_differing``).
A call keeps the digest of its document; each distinct document is kept
once, until the check, which splits it into its keys.
"""

import json
import time

from skabench import core
from skabench.jobs import webapi_map
from skabench.reference import webalign

KEYS = ("alignment", "newick")


def key_digests(doc: str) -> dict:
    """The digests of the document's alignment and newick; None for a
    key that a document that does not read lacks."""
    try:
        parsed = json.loads(doc)
    except ValueError:
        parsed = {}
    if not isinstance(parsed, dict):
        parsed = {}
    return {key: core.digest(parsed[key]) if isinstance(parsed.get(key), str)
            else None for key in KEYS}


def differing(records, docs: dict, want: str) -> dict:
    """The numbers compared: the finished calls whose document, and whose
    alignment and newick alone, differ from the reference's document
    want; docs holds each distinct document by its digest."""
    want_keys = key_digests(want)
    got_keys = {d: key_digests(doc) for d, doc in docs.items()}
    ok = [r for r in records if r["ok"]]
    out = {"calls_differing": sum(r["digest"] != core.digest(want) for r in ok)}
    for key in KEYS:
        out[f"{key}_differing"] = sum(
            got_keys[r["digest"]][key] != want_keys[key] for r in ok)
    return out


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.files = [p for _, p, _ in ctx.inputs["samples"]]
        self.docs = {}

    def setup(self):
        from ska_tpu_torch.webapi import AlignData

        self.AlignData = AlignData

    def warm(self):
        for i in range(int(self.ctx.traffic.get("warm_calls", 1))):
            self.run_one(i)

    def run_one(self, i):
        t = time.perf_counter()
        doc = self.AlignData(k=self.ctx.cfg["build"]["k"],
                             device=self.ctx.device).align(self.files)
        self.ctx.sync()
        dt = time.perf_counter() - t
        d = core.digest(doc)
        self.docs.setdefault(d, doc)
        return {"seconds": dt, "index": i, "query": 0, "digest": d}

    metrics = webapi_map.Job.metrics  # query_p95_ms, as the mapper's

    def release(self):
        pass  # each call's AlignData is gone with the call

    def check(self, records):
        exp = webalign.expected(self.ctx.cfg, self.ctx.inputs)
        self.ctx.stats = {"rows": exp["rows"], "samples": exp["samples"]}
        return differing(records, self.docs, exp["doc"])
