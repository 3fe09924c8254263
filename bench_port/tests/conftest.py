"""The benchmark's own tests: its folder and the checkout's root on the
import path, as run.py puts them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the tests run several to a machine (pytest-xdist): one thread each
torch.set_num_threads(1)
