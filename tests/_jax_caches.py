"""An autouse fixture for the port's test files, which compile JAX
functions: every compiled JAX executable is dropped when a file starts and
when it ends.

XLA keeps each executable's code in memory mappings of its own, the kernel
caps the mappings of a process (``vm.max_map_count``, 65530 by default),
and JAX's caches keep every executable alive. One pytest worker runs many
files one after another, so a worker whose files compile much reached the
cap and aborted inside whatever compile came next ("LLVM compilation
error: Cannot allocate memory", then a crashed worker), a test that passes
on its own. Clearing the caches frees the mappings; a function that is
called again compiles anew.

A test file takes it with ``from _jax_caches import fresh_jax_caches``.
"""
import gc

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def fresh_jax_caches():
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
