"""Caps torch's intra-op threads in the port's test modules.

Torch starts one intra-op thread per core in every process. The tier-1
run spreads the test files over several xdist workers on one host, so
at full width each worker's torch threads compete with every other
worker's for the same cores. Each ``test_torch_*.py`` module calls
`cap_torch_threads` where it is imported; the small shapes of these
tests gain nothing from more than two threads.
"""

import torch

TORCH_THREADS = 2


def cap_torch_threads() -> None:
    torch.set_num_threads(TORCH_THREADS)
