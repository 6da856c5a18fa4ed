"""The per-test time limit and the scheduling of the long tests, both in the
repository's root conftest.py: an overrun fails with the limit in its
message, the next test runs unaffected, no timer outlives its test, the hook
is a no-op where it cannot arm SIGALRM, and under ``--dist loadfile`` a long
test is a unit of its own, sent out first."""

import pathlib
import re
import signal
import threading
import time

import pytest

needs_alarm = pytest.mark.skipif(not hasattr(signal, "SIGALRM"),
                                 reason="the platform has no SIGALRM")

INI = """
[pytest]
markers =
    cuda: needs an NVIDIA GPU
    time_limit(seconds): per-test time limit
"""

INNER = """
import signal
import time

import pytest


@pytest.mark.time_limit(1)
def test_overruns():
    time.sleep(3)


def test_next_runs_under_the_default():
    left = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 1 < left <= {default}, left


@pytest.mark.cuda
def test_cuda_runs_unbounded():
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0
"""

OUTSIDE = """
import signal


def test_outside_tests_runs_unbounded():
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0
"""

FINISH = """

def pytest_unconfigure(config):
    print("ARMED_AFTER", signal.getitimer(signal.ITIMER_REAL)[0])
"""

LOGGED = """
import os
import signal


def log(name):
    with open({log!r}, "a") as f:
        f.write(os.environ["PYTEST_XDIST_WORKER"] + " " + name + "\\n")
"""


@pytest.fixture
def hooks(pytestconfig):
    """The root conftest module, as pytest registered it."""
    return pytestconfig.pluginmanager.get_plugin(
        str(pytestconfig.rootpath / "conftest.py"))


def _run(pytester, hooks, extra, *args):
    pytester.makeini(INI)
    pytester.makeconftest(pathlib.Path(hooks.__file__).read_text() + extra)
    return pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-p", "no:randomly", *args)


@needs_alarm
def test_overrun_fails_and_leaves_the_next_test_unaffected(pytester, hooks):
    pytester.mkdir("tests")
    pytester.path.joinpath("tests", "test_inner.py").write_text(
        INNER.format(default=hooks.DEFAULT_TIME_LIMIT))
    pytester.mkdir("other")
    pytester.path.joinpath("other", "test_outside.py").write_text(OUTSIDE)
    t0 = time.monotonic()
    res = _run(pytester, hooks, FINISH, "-q", "tests", "other")
    res.assert_outcomes(passed=3, failed=1)
    res.stdout.fnmatch_lines([
        "*test_overruns exceeded its time limit of 1 s*",
        "ARMED_AFTER 0.0"])
    assert time.monotonic() - t0 < 60


@needs_alarm
def test_long_tests_go_out_first_as_units_of_their_own(pytester, hooks):
    log = pytester.path / "order.log"
    pytester.mkdir("tests")
    pytester.path.joinpath("tests", "test_a.py").write_text(
        LOGGED.format(log=str(log)) + "".join(
            f"\n\ndef test_{i}():\n    log('a{i}')\n" for i in range(4)))
    pytester.path.joinpath("tests", "test_b.py").write_text(
        LOGGED.format(log=str(log))
        + "\n\ndef test_quick():\n    log('b_quick')\n"
        + "\n\ndef test_long():\n    log('b_long')\n"
        + "    assert 200 < signal.getitimer(signal.ITIMER_REAL)[0] <= 300\n")
    res = _run(pytester, hooks,
               '\nLONG_TESTS = {"tests/test_b.py::test_long": 100.0}\n',
               "-q", "-n", "2", "--dist", "loadfile", "tests")
    res.assert_outcomes(passed=6)
    lines = [line.split() for line in log.read_text().splitlines()]
    worker_of = dict((name, worker) for worker, name in lines)
    first_of = {}
    for worker, name in lines:
        first_of.setdefault(worker, name)
    assert first_of[worker_of["b_long"]] == "b_long"
    assert len({worker_of[f"a{i}"] for i in range(4)}) == 1


@needs_alarm
def test_context_manager_fails_the_body_and_disarms(hooks):
    before = signal.getitimer(signal.ITIMER_REAL)[0]
    handler = signal.getsignal(signal.SIGALRM)
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="body exceeded its time limit of 0.5 s"):
        with hooks.time_limit(0.5, "body"):
            time.sleep(3)
    assert time.monotonic() - t0 < 2
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is handler
    # the hook's own timer for this test was armed before the body ran
    assert before > 0


@needs_alarm
def test_no_op_without_sigalrm_or_off_the_main_thread(hooks, monkeypatch):
    armed = signal.getitimer(signal.ITIMER_REAL)

    def body():
        with hooks.time_limit(0.05, "body"):
            time.sleep(0.2)

    worker = threading.Thread(target=body)
    worker.start()
    worker.join()
    monkeypatch.delattr(signal, "SIGALRM")
    body()
    # the outer timer was neither disarmed nor re-armed by either body
    left = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 0 < left <= armed[0]


def test_long_tests_name_tests_that_exist(hooks, pytestconfig):
    for nodeid in hooks.LONG_TESTS:
        path, *names = nodeid.split("::")
        text = (pytestconfig.rootpath / path).read_text()
        for name in names:
            assert re.search(rf"^\s*(def|class) {name.split('[')[0]}\b",
                             text, re.M), nodeid
