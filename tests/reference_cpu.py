"""Where the reference's side of a port test runs: on jax's CPU device at
``highest`` matmul precision, whatever devices jax sees.  On a machine
with a GPU, jax would otherwise place the reference's calls on the GPU at
its default matmul precision, and they would miss the tolerances the port
is held to.  Import the fixture into a test module to apply it to every
test there::

    from reference_cpu import reference_on_cpu  # noqa: F401
"""

import jax
import pytest


@pytest.fixture(autouse=True)
def reference_on_cpu():
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        yield
