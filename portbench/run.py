"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``cylon_tpu_torch`` package. It runs on the card only: without
CUDA, or with fewer cards than the cell asks for, it prints no result
and exits with 2.
"""
import sys
import time

STARTED = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).absolute().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    why = harness.program_inside(ROOT)
    if why:
        sys.exit(harness.fail(why))
    sys.exit(harness.main(sys.argv[1:], STARTED, root=ROOT))
