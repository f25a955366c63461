#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`jpgenc_tpu_torch`): one run of
one cell, ending in one JSON line on standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See portbench/README.md and portbench/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
