"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and the numbers compared under checks), and each
number compared beside its limit as the last lines of standard error.
Fails, printing no result, without a CUDA card.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HARNESS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HARNESS)
sys.path[:0] = [HARNESS, ROOT]

from pbench.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0, HARNESS, ROOT))
