"""Two intra-op threads for the port's CPU tests.

The port's tests run small tensors on the CPU. Left alone, PyTorch starts
an intra-op pool as wide as the machine in every process, and the test
run's pytest-xdist workers (six on an eight-core box) then spend most of
their time waiting for each other's threads: the port's test files took
about 2,560 s of worker time that way and about 950 s with one thread
each. Two threads keep that gain; every port test file imports this
module, so a file run alone sums in the same order as in the whole run.
"""

import torch

torch.set_num_threads(2)
