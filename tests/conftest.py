"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without a multi-card host per
SURVEY.md §4 ("Distributed tier"): force the host platform and 8
virtual devices *before* jax initializes.  Set
``ORBIT_TPU_TEST_PLATFORM=gpu`` to run on the ambient GPU instead (the
``gpu``-marked tests need it: ``chip_smoke.py`` runs them that way; the
distributed tier skips on one card).
"""

import os

_platform = os.environ.get("ORBIT_TPU_TEST_PLATFORM", "cpu")
if _platform not in ("cpu", "gpu"):
    raise ValueError(
        f"ORBIT_TPU_TEST_PLATFORM must be 'cpu' or 'gpu', got {_platform!r}"
    )
if _platform == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import signal  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Honor ``@pytest.mark.timeout(seconds)`` without the
    pytest-timeout plugin (not installable in this environment):
    a SIGALRM raised in the main thread fails the test in bounded
    time — the multihost process tests would otherwise hang CI
    indefinitely on a wedged ``jax.distributed`` rendezvous."""
    marker = item.get_closest_marker("timeout")
    if marker is None or not hasattr(signal, "SIGALRM"):
        return (yield)
    seconds = int(marker.args[0])

    def _on_alarm(signum, frame):
        raise TimeoutError(
            f"test exceeded its timeout mark of {seconds}s"
        )

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(seconds)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (decided here, at run
    time — never while the module is collected)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: ORBIT_TPU_TEST_PLATFORM=gpu "
                    "python -m pytest -m gpu, or python chip_smoke.py)")
    return jax.devices()[0]
