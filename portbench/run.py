"""The benchmark of the PyTorch and CUDA port ``surtr_tpu_torch`` on one
H100: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout. The last line of standard
output is the run's JSON result; see ``pblib/harness.py``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (_HERE, os.path.dirname(_HERE)) if p not in sys.path]

from pblib.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], T_START))
