"""Entry point of the benchmark of ska_tpu_torch (see core.py):

    python3 skabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout."""

import os
import sys
import time

STARTED = time.perf_counter()
# the checkout's root in place of this directory, so that skabench's
# modules never shadow a top-level name
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from skabench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.run(sys.argv[1:], STARTED))
