"""Test-session config: deterministic hypothesis profiles + jit-cache
hygiene.

Property tests must be reproducible on CI's CPU runners — a flaky random
draw that only fails on one runner is worse than no property test.  Two
profiles:

  * ``ci``  — fixed derandomized draws, bounded example counts, no
    deadline (CPU runners are slow and jit compiles blow any per-example
    deadline).  Selected by CI via HYPOTHESIS_PROFILE=ci.
  * ``dev`` — the same bounds but randomized draws, for local fuzzing.

`hypothesis` itself is a soft dependency (tests/_hypothesis_compat.py);
without it this conftest is a no-op and the property tests skip.
"""

import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def _drop_jit_caches_between_modules():
    # Modules don't share jitted shapes, but their compiled executables all
    # stay alive for the whole session; with XLA:CPU the accumulated
    # compiler state can segfault a later module's compile (the full-suite
    # run dies inside backend_compile on a while_loop that compiles fine
    # when its module runs alone).  Dropping the caches at module teardown
    # keeps each module's compile environment like a fresh process.
    yield
    import jax

    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "ci", derandomize=True, max_examples=25, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.register_profile(
        "dev", max_examples=25, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ModuleNotFoundError:  # property tests skip via _hypothesis_compat
    pass
