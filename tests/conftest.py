"""Test configuration: an 8-device virtual CPU mesh unless told otherwise.

Multi-device sharding tests run on the host platform with
``--xla_force_host_platform_device_count=8`` (the standard JAX fake-backend
trick; the reference has no distributed tests to model, SURVEY.md section 4).
Must run before the first ``import jax``.  A process that sets
``JAX_PLATFORMS`` itself keeps its choice.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip where JAX
finds none; ``chip_smoke.py`` runs them on the card, in its own process:

    python chip_smoke.py          # includes ``pytest -m gpu tests/``
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# The CLI entry point turns on the persistent compile cache; test processes
# (several xdist workers in one checkout) keep theirs in memory only.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (the full tier; also RADAR_SLAM_FULL=1)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped where JAX finds none (run on the "
        "card by chip_smoke.py)")
    config.addinivalue_line(
        "markers",
        "slow: heavy (>~7 s) tests -- skipped by default so the iteration "
        "suite stays under ~5 min; run the full tier with --runslow or "
        "RADAR_SLAM_FULL=1 (VERDICT r03 item 9)")


def pytest_collection_modifyitems(config, items):
    if (config.getoption("--runslow")
            or os.environ.get("RADAR_SLAM_FULL") == "1"):
        return
    skip = pytest.mark.skip(
        reason="slow tier: run with --runslow or RADAR_SLAM_FULL=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests where JAX has no GPU backend.  Decided here,
    per test, and never at import: every xdist worker must collect the same
    tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")


@pytest.fixture
def gpu_device():
    """The first GPU device (only reachable from ``gpu``-marked tests)."""
    return jax.devices("gpu")[0]


_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _periodic_cache_clear():
    """Drop jax's executable/tracing caches every ~30 tests.

    XLA:CPU's compiler segfaulted reproducibly (three times, in
    `backend_compile_and_load`, at whichever heavy jit happened to land
    past the ~180-accumulated-executables mark of a full-suite run) while
    every shorter run passes.  Periodic clearing keeps the compiler
    inside whatever per-process resource pool it exhausts; the cost is a
    few recompiles of shared programs per suite."""
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % 30 == 0:
        jax.clear_caches()


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]
