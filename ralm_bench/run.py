"""Run one cell of the benchmark once and print its result line.

    python3 ralm_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``src/repro_torch`` (the port under
test) and ``BENCHMARK.json``. The last line of standard output is the
result (JSON); the compared numbers and their limits are the last lines
of standard error. Exits non-zero, with no result, without the CUDA
devices the cell asks for, or when the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from ralm_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
