"""The benchmark of fashion_nerf_torch (perfbench/README.md)."""

import os

# the root of the checkout the benchmark runs in
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
