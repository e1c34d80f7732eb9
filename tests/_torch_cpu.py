"""One intra-op thread for the port's CPU tests.

The Tier-1 run takes the test files six at once on eight cores (``-n 6
--dist loadfile``). torch starts one OpenMP thread a core in every worker,
so six workers put ~48 spinning threads on 8 cores, and a test made of
many small torch ops spends its time waiting on them: the port's eight
slowest files took 3708.6 s, six at once, with torch's default threads
and 945.1 s with one. Every ``tests/test_torch_*.py`` that runs on the CPU
imports :func:`one_intra_op_thread` (autouse, module scope), and a test
that starts interpreters gives them :func:`child_env`.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for torch (its OpenMP and MKL pools) while the
    module's tests run, the caller's count restored after them."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def child_env(**extra):
    """The environment of an interpreter a test starts: one OpenMP and one
    MKL thread, as :func:`one_intra_op_thread` gives the test's own
    process, and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
