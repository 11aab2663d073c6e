"""The port's CPU tests' thread budget, imported by every test_torch_*.py:
one intra-op thread per pytest process. The tests run on small tensors
under `-n 6` workers, each beside its mesh ranks' processes (one thread
each, parallel/mesh.py); torch's default of one thread per core in every
worker oversubscribes the host several times over."""

import torch

torch.set_num_threads(1)
