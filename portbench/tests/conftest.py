"""The benchmark's own tests: ``python -m pytest portbench/tests``. They
run on the CPU at small sizes; the one that needs a CUDA device skips
without one, decided inside its fixture."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
