"""Indicatif-style stderr progress bars (the port's copy of
ska_tpu/progress.py).

The reference shows progress bars on the serial build
(merge_ska_dict.rs:403). Bars render on stderr, update in place, and
finish with a newline; they are enabled whenever logging is at INFO
(`-v`) or when SKA_PROGRESS=1 forces them.
"""

import logging
import os
import sys
import time


def enabled() -> bool:
    if os.environ.get("SKA_PROGRESS") == "1":
        return True
    if os.environ.get("SKA_PROGRESS") == "0":
        return False
    return logging.getLogger("ska_tpu_torch").getEffectiveLevel() <= logging.INFO


class Bar:
    """[=====>    ] 12/45 samples (elapsed 3s) on stderr, in place."""

    def __init__(self, total: int, label: str, width: int = 30):
        self.total = max(int(total), 1)
        self.label = label
        self.width = width
        self.n = 0
        self.t0 = time.monotonic()
        self.on = enabled() and sys.stderr is not None
        self._render()

    def update(self, k: int = 1):
        self.n = min(self.n + k, self.total)
        self._render()

    def _render(self):
        if not self.on:
            return
        frac = self.n / self.total
        fill = int(frac * self.width)
        bar = "=" * fill + (">" if fill < self.width else "") + " " * (
            self.width - fill - 1
        )
        el = int(time.monotonic() - self.t0)
        sys.stderr.write(
            f"\r[{bar}] {self.n}/{self.total} {self.label} ({el}s)"
        )
        if self.n >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()

    def finish(self):
        if self.n < self.total:
            self.n = self.total
            self._render()
