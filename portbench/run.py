#!/usr/bin/env python3
"""Run one cell of the benchmark of gpu_fft_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program.  The last line of
standard output is the result (JSON); the last lines of standard error give
each number compared beside its limit.  Exits non-zero, with no result,
where the cell's cards are missing, where the program cannot be imported
from this checkout, or where JAX or the JAX package was loaded.
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
