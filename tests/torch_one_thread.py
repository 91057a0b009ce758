"""Imported by every ``tests/test_torch_*.py``: the port's CPU tests run
torch on one intra-op thread.

The tier-1 lane runs the tests in 6 pytest-xdist workers on an 8-core
machine.  torch starts one intra-op thread per core in each worker, so on
the port's narrow test shapes six workers keep about 48 OpenMP threads
spinning on 8 cores: a serving test that takes 8-11 s alone took 298 s in
the lane.  One thread a worker computes the same values (the tests
compare against tolerances that hold for any thread count) without the
oversubscription.
"""

import torch

torch.set_num_threads(1)
