"""The environment and the time of a test's child process."""
import os
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# The JAX side of a bit-parity test: without FMA instructions XLA rounds
# a*b+c twice, like the CUDA kernels and their twins (tests/test_torch_raster.py),
# on one CPU device in place of the worker's eight.
NO_FMA = ("--xla_cpu_max_isa=AVX", "--xla_force_host_platform_device_count=1")

# When the running test's time limit ends, on time.monotonic()'s clock: set
# by the suite's conftest.py, None outside a test.
deadline = None
# a child's time is what is left of its test's limit less this, so that the
# child is killed and reported first; outside a test it is OUTSIDE_S
MARGIN_S, OUTSIDE_S = 30, 1200


def subprocess_env(*xla_flags):
    """The worker's environment, with the repo first on PYTHONPATH and
    ``xla_flags`` after the worker's XLA_FLAGS (the last of two settings of a
    flag wins). The thread budget of conftest.py comes with it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    env["XLA_FLAGS"] = " ".join([os.environ.get("XLA_FLAGS", ""), *xla_flags]).strip()
    return env


def time_left():
    """A child's timeout, in seconds: see MARGIN_S."""
    if deadline is None:
        return OUTSIDE_S
    return max(deadline - time.monotonic() - MARGIN_S, 1)
