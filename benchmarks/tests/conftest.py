"""The harness's CPU tests import the benchmark as the package
``benchmarks`` from the checkout's root, as ``benchmarks/run.py`` does."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
