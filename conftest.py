"""Bounds on the time of the tests under ``tests/``.

Each phase of a test (setup, call, teardown) runs under a SIGALRM timer of
``DEFAULT_TIME_LIMIT`` seconds; ``@pytest.mark.time_limit(seconds)`` sets
another limit for one test, and each test of ``LONG_TESTS`` gets three times
its measured time.  A phase that overruns fails with a message naming the
limit, so a hang costs one limit and one failure instead of the whole run.
Where SIGALRM is missing, or the test does not run on the main thread, no
timer is armed; nor for the ``cuda`` tests, whose first call may build a
kernel with nvcc for minutes.  The signal is handled between Python
bytecodes: a call stuck inside native code is failed only once it returns.

Under ``pytest-xdist``'s ``--dist loadfile`` each file runs whole on one
worker, so a file that holds several tests of minutes ends the run long
after the other workers.  Here each test of ``LONG_TESTS`` is a unit of work
of its own, sent out before the files, longest first; every other test runs
with its file, as ``loadfile`` has it.
"""

import contextlib
import signal
import threading

import pytest

pytest_plugins = ["pytester"]

DEFAULT_TIME_LIMIT = 180.0

# Tests that take more than 90 s alone: seconds each took in a run of
# ``tests/`` with ``-n 6 --dist loadfile`` on 8 CPU cores.
LONG_TESTS = {
    "tests/test_distributions.py::test_rsample_batched[coo]": 452.4,
    "tests/test_distributions.py::test_rsample_batched[csr]": 421.9,
    "tests/test_distributions.py::test_rsample_statistics[csr-False-True]": 175.3,
    "tests/test_distributions.py::test_rsample_statistics[coo-False-True]": 170.8,
    "tests/test_dia.py::TestHybridDia::test_chunk_residual_engine_parity": 142.9,
    "tests/test_distributions.py::test_native_variant[csr]": 142.5,
    "tests/test_distributions.py::test_native_variant[coo]": 127.2,
    "tests/test_distributions.py::test_optimization_smoke[csr]": 106.9,
    "tests/test_distributions.py::test_optimization_smoke[coo]": 97.8,
    "tests/test_fuzz.py::test_spmm_and_grads[7x100nnz300coo]": 91.3,
}


@contextlib.contextmanager
def time_limit(seconds: float, what: str = "test"):
    """Fail the body with ``pytest.fail`` once it has run ``seconds``.

    A no-op where SIGALRM is missing or off the main thread.  The timer is
    always disarmed and the previous SIGALRM handler restored on exit.
    """
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{what} exceeded its time limit of {seconds:g} s")

    alarm = signal.SIGALRM
    previous = signal.signal(alarm, expire)
    try:
        signal.setitimer(signal.ITIMER_REAL, seconds)
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(alarm, previous)


def _limit(item):
    """The item's time limit in seconds, or None where it runs unbounded."""
    if (item.get_closest_marker("cuda")
            or not item.path.is_relative_to(item.config.rootpath / "tests")):
        return None
    mark = item.get_closest_marker("time_limit")
    if mark:
        return float(mark.args[0])
    if item.nodeid in LONG_TESTS:
        return 3 * LONG_TESTS[item.nodeid]
    return DEFAULT_TIME_LIMIT


def _bounded(item, what):
    seconds = _limit(item)
    return (contextlib.nullcontext() if seconds is None
            else time_limit(seconds, what))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _bounded(item, f"setup of {item.nodeid}"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _bounded(item, item.nodeid):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _bounded(item, f"teardown of {item.nodeid}"):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongTestsFirst(LoadFileScheduling):
        """``loadfile``, with each of ``LONG_TESTS`` a unit sent out first."""

        reordered = False

        def _split_scope(self, nodeid):
            if nodeid in LONG_TESTS:
                return nodeid
            return super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            if not self.reordered:
                for nodeid in sorted(LONG_TESTS, key=LONG_TESTS.get):
                    if nodeid in self.workqueue:
                        self.workqueue.move_to_end(nodeid, last=False)
                self.reordered = True
            super()._assign_work_unit(node)

    return LongTestsFirst(config, log)
