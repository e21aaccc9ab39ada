#!/usr/bin/env python3
"""One run of one cell of the fashion_nerf_torch benchmark.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
traffic come from BENCHMARK.json and the files it names; see
perfbench/README.md.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for `perfbench`) and src/ (for the program), not
# this folder: its module names must not shadow the standard library's
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
