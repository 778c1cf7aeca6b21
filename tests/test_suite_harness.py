"""The suite's harness: every worker runs at the thread budget of the
root conftest.py, a child process started with ``tests/_proc.py``'s
``subprocess_env`` runs at it too and keeps its caller's XLA flags, a
child's ``time_left`` ends before its test's time limit, the files with
the longest time limits are queued first, and a test that runs past its
time limit fails alone, in its call, in a module fixture's setup or in a
wait that no signal interrupts, and the next test runs."""
import os
import subprocess
import sys

import pytest
import torch

from tests import _proc
from tests._proc import NO_FMA, REPO, subprocess_env

pytest_plugins = ["pytester"]

BUDGET = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "OPENCV_FOR_THREADS_NUM")


def test_worker_runs_at_the_budget():
    import cv2

    assert torch.get_num_threads() == 1 and torch.get_num_interop_threads() == 1
    assert cv2.getNumThreads() == 1
    assert all(os.environ[var] == "1" for var in BUDGET)
    assert "--xla_cpu_multi_thread_eigen=false" in os.environ["XLA_FLAGS"].split()


def test_child_runs_at_the_budget_with_its_flags(tmp_path):
    code = ("import os, cv2, jax, torch, tests._proc\n"
            "print(torch.get_num_threads(), cv2.getNumThreads(), len(jax.devices()))\n"
            f"print(*(os.environ[v] for v in {BUDGET!r}))\n"
            "print(os.environ['XLA_FLAGS'])\n")
    res = subprocess.run([sys.executable, "-c", code], env=subprocess_env(*NO_FMA),
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    threads, budget, flags = res.stdout.splitlines()
    # NO_FMA's one device overrides the worker's eight: the last setting wins
    assert threads.split() == ["1", "1", "1"] and budget.split() == ["1"] * len(BUDGET)
    flags = flags.split()
    assert flags[:len(os.environ["XLA_FLAGS"].split())] == os.environ["XLA_FLAGS"].split()
    assert flags[-len(NO_FMA):] == list(NO_FMA)
    assert "--xla_cpu_multi_thread_eigen=false" in flags


@pytest.mark.limit(100)
def test_child_ends_before_the_limit(monkeypatch):
    assert 60 < _proc.time_left() <= 100 - _proc.MARGIN_S
    monkeypatch.setattr(_proc, "deadline", _proc.deadline - 80)
    assert _proc.time_left() == 1


def test_child_outside_a_test_keeps_its_timeout(monkeypatch):
    monkeypatch.setattr(_proc, "deadline", None)
    assert _proc.time_left() == _proc.OUTSIDE_S


class _Item:
    def __init__(self, nodeid, limit=None):
        self.nodeid, self.limit = nodeid, limit

    def get_closest_marker(self, name):
        return pytest.mark.limit(self.limit).mark if self.limit else None


def test_files_queue_longest_limit_first(request):
    conftest = request.config.pluginmanager.get_plugin(str(REPO / "conftest.py"))
    items = [_Item("a.py::t1"), _Item("a.py::t2"), _Item("b.py::t", 400), _Item("c.py::t1"),
             _Item("c.py::t2", 500), _Item("d.py::t", 10)]
    conftest.pytest_collection_modifyitems(items)
    assert [i.nodeid for i in items] == ["c.py::t1", "c.py::t2", "b.py::t", "a.py::t1",
                                         "a.py::t2", "d.py::t"]
    assert getattr(request.config.option, "loadscopereorder", False) is False


CALLS = """
import subprocess, sys, time

import pytest


@pytest.mark.limit(1)
def test_sleeps():
    time.sleep(60)


@pytest.mark.limit(1)
def test_waits_on_a_child():
    subprocess.run([sys.executable, "-c", "import time; time.sleep(60)"])


def test_after_calls():
    pass
"""

FIXTURE = """
import time

import pytest

pytestmark = pytest.mark.limit(1)


@pytest.fixture(scope="module")
def slow():
    time.sleep(60)


def test_uses_slow(slow):
    pass


def test_after_fixture():
    pass
"""


HANG = """
import signal, time

import pytest


@pytest.mark.limit(1)
def test_hangs_where_no_signal_arrives():
    signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
    time.sleep(60)


def test_after_hang():
    pass
"""


def test_time_limit_fails_only_the_test_past_it(pytester, monkeypatch):
    conftest = (REPO / "conftest.py").read_text()
    assert "HANG_GRACE_S = 60\n" in conftest
    pytester.makeconftest(conftest.replace("HANG_GRACE_S = 60\n", "HANG_GRACE_S = 2\n"))
    monkeypatch.setenv("PYTHONPATH", subprocess_env()["PYTHONPATH"])  # its `from tests import _proc`
    pytester.makepyfile(test_calls=CALLS, test_fixture=FIXTURE, test_hang=HANG)
    res = pytester.runpytest_subprocess("-p", "xdist", "-n", "2", "--dist", "loadfile",
                                        "-p", "no:randomly", "-p", "no:cacheprovider",
                                        "-W", "ignore::pytest.PytestUnknownMarkWarning",
                                        timeout=240)
    res.assert_outcomes(passed=3, failed=3, errors=1)
    out = res.stdout.str()
    for test in ("test_calls.py::test_sleeps", "test_calls.py::test_waits_on_a_child",
                 "test_fixture.py::test_uses_slow"):
        assert f"{test} ran past its time limit of 1 s" in out, out[-4000:]
    # SIGALRM blocked, as in a wait inside C++: the worker dumps its stack and
    # exits after the grace, and a fresh worker runs the rest of the file
    assert "crashed while running 'test_hang.py::test_hangs_where_no_signal_arrives'" in out
    assert "Timeout (0:00:03)!" in res.stderr.str() + out
    assert res.duration < 60, res.duration
