#!/usr/bin/env python3
"""Run one cell of the benchmark once; see `benchkit.harness`.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every cache the program keeps is pointed at a fixed directory inside the
checkout before anything is imported, so only a cell's first run there
builds."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(CACHE, "autotune.json")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

from benchkit.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
