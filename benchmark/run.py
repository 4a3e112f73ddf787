"""Benchmark of the PyTorch/CUDA port `mammodissect_torch` on one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices. Prints, as
the last line of standard output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics untraced, its per-layer metrics with
--trace 1), device. Exits non-zero without a result when the card, the program or
BENCHMARK.json is missing, or when JAX or the JAX package was loaded."""
import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark.core import main

    sys.exit(main(sys.argv[1:], T_START))
