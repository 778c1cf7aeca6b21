"""The test suite's harness, which pytest loads before tests/conftest.py:
every test process runs at one thread, and every test under a time limit."""
import faulthandler
import os
import signal
import time

# The thread budget: one thread for torch, OpenMP, the BLAS, OpenCV and
# XLA's Eigen in every test process. The suite runs 6 workers on 8 cores,
# and each of their JAX subprocesses ran 30 threads: a gate's JAX side ran
# faster on one core than beside another gate on all eight. Subprocesses
# inherit it through os.environ (tests/_proc.py). XLA's CPU client still
# sizes its own pools by the cores the process may use.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
            "OPENCV_FOR_THREADS_NUM"):
    os.environ[var] = "1"
ONE_EIGEN_THREAD = "--xla_cpu_multi_thread_eigen=false"
if ONE_EIGEN_THREAD not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {ONE_EIGEN_THREAD}".strip()

import pytest  # noqa: E402
import torch  # noqa: E402

from tests import _proc  # noqa: E402

torch.set_num_threads(1)
torch.set_num_interop_threads(1)

# Each test's time limit, setup and teardown included (a module fixture
# does its work in the setup of the file's first test); ``limit(seconds)``
# raises it for one test or file.
LIMIT_S = 300
# A wait inside C++ (an XLA rendezvous, a lock) never returns to the
# interpreter, so SIGALRM's handler cannot run: this long after the limit
# the worker prints every thread's stack and exits. xdist reports the test
# as failed and gives the rest of its file to a fresh worker.
HANG_GRACE_S = 60
# the stack goes to the terminal's stderr, not to a test's captured one
STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    config.stash[STDERR] = os.dup(2)
    # xdist's loadfile scheduler queues the files with the most tests first,
    # so the long one-test files (the gates) started last and set the run's
    # tail: it takes them in collection order, longest limit first
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    """Files in the order of their longest time limit, longest first: a
    limit is about 3x its test's time, so the longest files start first."""
    longest = {}
    for item in items:
        marker = item.get_closest_marker("limit")
        path = item.nodeid.split("::")[0]
        longest[path] = max(longest.get(path, LIMIT_S), marker.args[0] if marker else LIMIT_S)
    items.sort(key=lambda item: -longest[item.nodeid.split("::")[0]])


def pytest_unconfigure(config):
    os.close(config.stash[STDERR])


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    """xdist's loadfile scheduler queues every file of a dead worker again,
    the files it finished and the test it died in too: a fresh worker given a
    finished file as an empty batch waits for ever, and one given the test
    dies in it again. Count the test as done and drop the finished files."""
    queue = getattr(sched, "workqueue", {})
    for scope, unit in list(queue.items()):
        if crashitem in unit:
            unit[crashitem] = True
        if all(unit.values()):
            del queue[scope]


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    marker = item.get_closest_marker("limit")
    limit = marker.args[0] if marker else LIMIT_S

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit} s", pytrace=True)

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + HANG_GRACE_S, exit=True,
                                      file=item.config.stash[STDERR])
    _proc.deadline = time.monotonic() + limit
    try:
        yield
    finally:
        _proc.deadline = None
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
