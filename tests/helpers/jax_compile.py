"""A fixture for the port's JAX-parity tests whose time is the JAX side's
compile: XLA compiles the reference's programs with most of its
optimizations off inside the test, and restores the setting after.

At the tests' tiny shapes the programs run in microseconds either way, and
their compile takes about a quarter less. What the reference computes moves
only by floating-point reassociation (~1e-7 relative), far inside every
tolerance these tests hold the port to.
"""

import jax
import pytest


@pytest.fixture
def unoptimized_xla():
    previous = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", previous)
