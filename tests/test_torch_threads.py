"""torch's intra-op threads for the port's CPU tests.

The suite runs under pytest-xdist, six workers on the box's cores, each
beside XLA's own thread pool. torch's default intra-op pool (a thread a
core) in every worker then puts several busy threads on each core, and
the JAX compiles that most port tests wait on run that much slower.
Importing this module caps torch at THREADS intra-op threads in the
process; every port test module imports it (xdist workers import every
test module while collecting, before any test runs). The port's plain
versions give the same bits at any thread count that they give at the
default: what the tests compare bitwise is integer or elementwise."""

import torch

THREADS = 1

torch.set_num_threads(THREADS)


def test_torch_threads_capped():
    assert torch.get_num_threads() == THREADS
