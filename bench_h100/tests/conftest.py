"""The benchmark's CPU tests: ``python -m pytest bench_h100/tests`` from
the checkout's root.  They run the program on the CPU at toy sizes; none
needs a card."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)
