"""One torch thread in each test worker process.

Under ``pytest -n N`` (pytest-xdist) every worker runs its own torch, and
torch's intra-op pool defaults to one thread a core: N workers then ask
for N times the cores, and the port's CPU tests, whose tensors are small,
spend most of their time waiting on each other's threads (a test file
alone: 31 s single-threaded against 42 s at eight threads on an 8-core
host; in the whole suite the gap is several times that). The port's
test modules import this module first; run alone (no worker id in the
environment) torch keeps its default.
"""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
