"""The benchmark's own tests run on the CPU at narrow widths, one torch
thread each; the tests that need a card skip without one."""

import torch

torch.set_num_threads(1)
