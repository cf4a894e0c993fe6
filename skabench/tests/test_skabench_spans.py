"""The eight readers of the spans on the time that map's three spans
and the build's steps leave uncovered: ska::command, ska::load (with
ska::read, ska::decompress, ska::decode) and a browser call's
ska::call, ska::parse, ska::stage, ska::to_device, ska::device_pass,
ska::to_host and ska::merge. Each on a synthetic trace with spans
nested and on two threads, each None without its span, and each in a
traced CPU run of its cell."""

import pytest
from skabench_helpers import ROOT, run_cell

from skabench import core
from skabench.trace import Trace


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": ts, "dur": dur}


def _map_trace():
    # two map jobs of 1000 us; job 1's command holds a load with its
    # three steps, a scan, a vcf, and overlaps a span of another thread
    return Trace([
        _span("skabench::window", 0, 2000),
        _span("skabench::job", 0, 1000), _span("skabench::job", 1000, 1000),
        _span("ska::command", 10, 900),
        _span("ska::load", 20, 300), _span("ska::read", 20, 40),
        _span("ska::decompress", 60, 140), _span("ska::decode", 200, 120),
        _span("ska::scan", 320, 40), _span("ska::vcf", 400, 400),
        _span("ska::other", 850, 40, tid=2),
        _span("ska::command", 1010, 600),
        _span("ska::load", 1020, 200), _span("ska::read", 1020, 30),
        _span("ska::decompress", 1050, 100), _span("ska::decode", 1150, 70),
        _span("ska::vcf", 1300, 200)])


def _call_trace():
    # two browser calls of 500 us, each a job holding one ska::call with
    # the per-sample build, the merge and map's spans; a compile nested
    # in call 1's device pass, and a span of another thread in call 1
    ev = [_span("skabench::window", 0, 1000),
          _span("skabench::job", 0, 500), _span("skabench::job", 500, 500),
          _span("ska::other", 100, 40, tid=2), _span("ska::compile", 100, 20)]
    for t0, durs in ((10, (40, 20, 10, 60, 50, 60, 40, 20, 80)),
                     (510, (20, 10, 5, 45, 40, 60, 20, 10, 70))):
        ev.append(_span("ska::call", t0, 480))
        t = t0 + 10
        for name, d in zip(("parse", "stage", "to_device", "device_pass",
                            "to_host", "merge", "lookup", "gather",
                            "pseudoalign"), durs):
            ev.append(_span(f"ska::{name}", t, d))
            t += d
    return Trace(ev)


def _read(name, trace, jobs=2):
    return core.load_module(ROOT, "metrics", name).read(trace, {"jobs": jobs})


MAP = {"load_ms.map": 0.25,             # (300 + 200) / 2 us, steps included
       "command_self_ms.map": 0.18,     # (900-740 + 600-400) / 2
       "command_self_ms.build": 0.18}
QUERY = {"parse_ms.query": 0.045,       # (40+20 + 20+10) / 2
         "to_host_ms.query": 0.0525,    # (10+50 + 5+40) / 2
         "device_pass_ms.query": 0.0425,  # (60-20 + 45) / 2
         "merge_ms.query": 0.06,
         "call_self_ms.query": 0.15}    # (480-380 + 480-280) / 2


@pytest.mark.parametrize("name", list(MAP) + list(QUERY))
def test_reader_on_a_synthetic_trace(name):
    own, other = ((_map_trace(), _call_trace()) if name in MAP
                  else (_call_trace(), _map_trace()))
    assert _read(name, own) == pytest.approx({**MAP, **QUERY}[name])
    assert _read(name, other) is None  # its span is not there
    assert _read(name, own, jobs=0) is None


def test_call_spans_sum_to_the_call_outside_map():
    """The five .query readers add up to call_outside_map_ms.query less
    what the job holds outside ska::call (20 us a call here) and the
    compile nested in call 1's device pass (10 us a call)."""
    t = _call_trace()
    outside = core.load_module(ROOT, "metrics", "call_outside_map_ms.query").read(
        t, {"jobs": 2})
    assert sum(_read(n, t) for n in QUERY) + 0.02 + 0.01 == pytest.approx(outside)


CELL_METRICS = {
    "asm_k31.map_vcf": ["load_ms.map", "command_self_ms.map"],
    "asm_k31.webapi_map": list(QUERY),
}


@pytest.mark.parametrize("cell", list(CELL_METRICS))
def test_traced_cpu_run_reports_the_new_metrics(tiny_root, cell):
    rc, last, out = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and last is not None, out
    assert last["correct"] is True
    got = last["metrics"]
    assert all(got[n]["value"] > 0 and got[n]["unit"] == "ms"
               for n in CELL_METRICS[cell])
    if cell == "asm_k31.webapi_map":
        # each call's span lies inside its job
        assert sum(got[n]["value"] for n in QUERY) <= (
            got["call_outside_map_ms.query"]["value"] + 1e-6)
