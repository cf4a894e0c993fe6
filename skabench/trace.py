"""The reduction of a torch.profiler Chrome trace to what the per-layer
metrics read.

- Spans are the ``user_annotation`` events: the program's ``ska::*``
  spans and the harness's ``skabench::window`` (the measured window)
  and ``skabench::job`` (one job or call). A span's self time is its
  length less the part that other spans nested in it, on its thread,
  cover.
- Device operations are the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events. A kernel belongs to a span when the host call
  that launched it (the runtime event of the same correlation id) began
  inside that span on the span's thread.
- The device is busy where the union of the device operations' intervals
  covers the window; idle elsewhere.

Times in the trace are microseconds; everything returned is seconds.
"""

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "skabench::window"
JOB = "skabench::job"


def _union(intervals):
    """Sorted, merged copy of [(start, end)] intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, a, b):
    """Length of [a, b] that merged intervals cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if y > a and x < b)


class Trace:
    def __init__(self, events):
        self.spans = []  # (name, tid, start, end)
        self.device = []  # (name, cat, start, end, correlation)
        launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat == "user_annotation":
                self.spans.append((e["name"], e.get("tid"), ts, ts + dur))
            elif cat in DEVICE_CATS:
                corr = (e.get("args") or {}).get("correlation")
                self.device.append((e["name"], cat, ts, ts + dur, corr))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), ts)
        self.launches = launches
        self.spans.sort(key=lambda s: (s[2], -s[3]))
        windows = [s for s in self.spans if s[0] == WINDOW]
        if windows:
            self.t0, self.t1 = windows[0][2], windows[0][3]
        else:
            times = [s[2] for s in self.spans] + [s[3] for s in self.spans]
            self.t0, self.t1 = (min(times), max(times)) if times else (0.0, 0.0)

    @classmethod
    def load(cls, path: str):
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def named(self, names):
        return [s for s in self.spans if s[0] in names]

    def jobs(self) -> int:
        return len(self.named((JOB,)))

    def self_s(self, names, exclude_children=None) -> float:
        """Total self time of the spans named in names: each span less
        what spans nested in it on its thread cover (only those named in
        exclude_children, when given)."""
        total = 0.0
        for name, tid, a, b in self.named(names):
            kids = [(x, y) for n, t, x, y in self.spans
                    if t == tid and a <= x and y <= b and (x, y) != (a, b)
                    and n not in (WINDOW, JOB)
                    and (exclude_children is None or n in exclude_children)]
            total += (b - a) - _covered(_union(kids), a, b)
        return total / 1e6

    def kernels_in(self, names):
        """Kernels whose launch began inside a span named in names."""
        per_tid = defaultdict(list)
        for _, tid, a, b in self.named(names):
            per_tid[tid].append((a, b))
        merged = {t: _union(v) for t, v in per_tid.items()}
        starts = {t: [a for a, _ in v] for t, v in merged.items()}
        out = []
        for ev in self.device:
            if ev[1] != "kernel" or ev[4] not in self.launches:
                continue
            tid, ts = self.launches[ev[4]]
            i = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if i >= 0 and ts <= merged[tid][i][1]:
                out.append(ev)
        return out

    def busy_intervals(self):
        return [(max(a, self.t0), min(b, self.t1)) for _, _, a, b, _ in self.device
                if b > self.t0 and a < self.t1]

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.busy_intervals())) / 1e6

    def idle_pct(self):
        if not self.device or self.t1 <= self.t0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def _segments(self):
        """The window's main-thread spans flattened into disjoint
        (start, end, innermost span's name) pieces."""
        tid = next((t for n, t, _, _ in self.spans if n == WINDOW), None)
        segs, stack, cur = [], [], None
        for name, t, x, y in self.spans:
            if t != tid or name == WINDOW:
                continue
            while stack and stack[-1][1] <= x:
                segs.append((cur, stack[-1][1], stack[-1][0]))
                cur = stack.pop()[1]
            if stack and cur < x:
                segs.append((cur, x, stack[-1][0]))
            stack.append((name, y))
            cur = x
        while stack:
            segs.append((cur, stack[-1][1], stack[-1][0]))
            cur = stack.pop()[1]
        return [s for s in segs if s[1] > s[0]]

    def breakdown(self, job_kind: str, top: int = 10):
        """The device operations that took most time, and the device's
        idle time summed by what the host was in meanwhile: the innermost
        ska:: span, else the job, else the harness between jobs."""
        per_op = defaultdict(float)
        for name, _, a, b, _ in self.device:
            per_op[name] += (min(b, self.t1) - max(a, self.t0)) / 1e6 if b > self.t0 and a < self.t1 else 0.0
        gaps = []
        cur = self.t0
        for a, b in _union(self.busy_intervals()):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        segs = self._segments()
        seg_starts = [x for x, _, _ in segs]
        per_label = defaultdict(float)
        for a, b in gaps:
            i = max(bisect.bisect_right(seg_starts, a) - 1, 0)
            cur = a
            while cur < b:
                if i < len(segs) and segs[i][0] <= cur < segs[i][1]:
                    end, label = min(b, segs[i][1]), segs[i][2]
                    label = f"{job_kind}: outside ska spans" if label == JOB else label
                    i += 1
                else:
                    while i < len(segs) and segs[i][1] <= cur:
                        i += 1
                    end = min(b, segs[i][0]) if i < len(segs) else b
                    label = "harness: between jobs"
                per_label[label] += (end - cur) / 1e6
                cur = end
        rank = lambda d: sorted(([k, v] for k, v in d.items() if v > 0),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(per_op), "idle_gaps": rank(per_label)}
