"""parallel.mesh.initialize_distributed: a no-op only for one process or an
already initialised one; every other failure propagates."""

import jax
import pytest

from intentbev.parallel.mesh import initialize_distributed


@pytest.mark.parametrize("kwargs", [{}, {"num_processes": 1}])
def test_single_process_is_a_no_op(kwargs):
    initialize_distributed(**kwargs)
    assert not jax.distributed.is_initialized()


def test_real_errors_propagate():
    with pytest.raises((RuntimeError, ValueError)):
        initialize_distributed(coordinator_address="localhost:1",
                               num_processes=2, process_id=5)
