import importlib.util
import os
import sys

# tests run on a virtual 8-device CPU mesh so the sharded population engine
# (shard_map over the population axis) is exercised for real; this must be set
# before jax initializes.  The dry-run's 512-device flag stays process-local
# to launch/dryrun.py.  Keep kernels on the ref path by default.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

# -- per-test timeout guard ---------------------------------------------------
# The streaming population engines run flush/flight worker *threads*; a
# regression that deadlocks one must fail the suite, not hang CI.  Prefer the
# real pytest-timeout plugin when installed (requirements-dev.txt); otherwise
# fall back to a faulthandler watchdog that dumps every thread's stack and
# aborts the process.  Tune with PYTEST_TIMEOUT (seconds, 0 disables).
_HAVE_PYTEST_TIMEOUT = importlib.util.find_spec("pytest_timeout") is not None
_TEST_TIMEOUT_S = float(os.environ.get("PYTEST_TIMEOUT") or "600")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips elsewhere")
    if not _HAVE_PYTEST_TIMEOUT:
        config.addinivalue_line(
            "markers", "timeout(seconds): pytest-timeout's per-test limit (without the "
                       "plugin the watchdog below guards every test)")
    if not (_HAVE_PYTEST_TIMEOUT and _TEST_TIMEOUT_S > 0):
        return
    try:
        explicit = config.getoption("timeout")
    except ValueError:  # plugin present but disabled (-p no:timeout)
        return
    if explicit is None:  # 0 is an explicit opt-out (e.g. pdb sessions)
        config.option.timeout = _TEST_TIMEOUT_S
        config.option.timeout_method = "thread"


if not _HAVE_PYTEST_TIMEOUT and _TEST_TIMEOUT_S > 0:
    import faulthandler

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_protocol(item, nextitem):
        faulthandler.dump_traceback_later(_TEST_TIMEOUT_S, exit=True)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


ROSENBROCK_SPACE = [
    {"name": "x", "type": "float", "range": [-2.0, 2.0]},
    {"name": "y", "type": "float", "range": [-1.0, 3.0]},
]


def rosenbrock(cfg):
    x, y = float(cfg["x"]), float(cfg["y"])
    return -((1 - x) ** 2 + 100 * (y - x * x) ** 2)


@pytest.fixture
def rosenbrock_problem():
    return ROSENBROCK_SPACE, rosenbrock
