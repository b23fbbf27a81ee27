"""The benchmark's own tests: the harness's folder and the checkout on
the import path, and few threads a worker, as the tiny runs are many."""
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
torch.set_num_threads(2)
