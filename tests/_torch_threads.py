"""One CPU thread for the port's tests and the processes they start.

The suite runs under several pytest-xdist workers, each of which starts
reference and gloo-rank processes, on a machine of a few cores.  Torch's
default intra-op pool (a thread a core, spinning between parallel
regions) in every one of them oversubscribes the cores many times over,
and the port's tests, small tensors all, gain nothing from it.  So each
port test module runs its in-process torch work on one thread
(`one_torch_thread`, autouse: import it into the module) and starts its
processes with `subprocess_env` (one OpenMP / BLAS thread).  The gloo
rank workers set one torch thread themselves.
"""
import os

import pytest
import torch

ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def subprocess_env(**extra) -> dict:
    """The environment for a process a port test starts: this one's, one
    OpenMP / BLAS thread, and ``extra``."""
    return {**os.environ, **ONE_THREAD, **extra}
