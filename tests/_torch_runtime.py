"""The fixture of the port's runtime tests.

``tests/conftest.py``'s ``ray_start`` starts a ``ray_tpu`` cluster; this
one starts a ``ray_tpu_torch`` cluster, and a test module imports it from
here.  This module, and every test module that uses it, imports no JAX
and nothing of ``ray_tpu``: cloudpickle ships a test module's functions
by reference, so the cluster's workers import the test module itself.
"""

import os

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_start():
    """Module-scoped local cluster with 16 CPUs (reference:
    ray_start_regular)."""
    # Generous CPU count: module-scoped tests accumulate long-lived actors.
    ray_tpu_torch.init(num_cpus=16, log_level=os.environ.get(
        "RT_TEST_LOG_LEVEL", "WARNING"))
    yield
    ray_tpu_torch.shutdown()



@pytest.fixture
def ray_start_fresh():
    """Function-scoped cluster for tests that mutate cluster state."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
