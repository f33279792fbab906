"""Test configuration.

The suite runs on an 8-device virtual CPU platform, so multi-device
sharding is validated without accelerators (SURVEY.md §4).  It reuses the
driver entry's ``_bootstrap_virtual_cpu`` (ONE definition of the
bootstrap): it guards the already-set-XLA_FLAGS and already-initialized-JAX
cases with a clear diagnostic instead of the opaque "mesh needs N devices"
error, and verifies the device count actually materialized.  The
persistent compile cache is off, so test runs leave nothing in the
checkout.

``pytest -m gpu`` selects the tests that need the card (``chip_smoke.py``
runs them there); for that selection the real device is kept.  Whether a
card is present is decided in the ``gpu`` fixture, never at import time.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _bootstrap_virtual_cpu  # noqa: E402


def pytest_configure(config):
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    if config.getoption("markexpr", "") != "gpu":
        _bootstrap_virtual_cpu(8)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev
