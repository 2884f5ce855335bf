"""A time limit for the port's test files whose JAX side runs Pallas kernels
in TPU interpret mode.

Interpret mode runs each Pallas call through host callbacks, and its
``get`` / ``store`` callbacks iterate JAX arrays, which dispatches new
computations from the callback's thread.  When the main thread dispatches
computations meanwhile (JAX called op by op, not under ``jax.jit``), the two
can deadlock, every thread idle on a futex for good.  So a JAX reference
call in interpret mode belongs under one ``jax.jit``, and each such file has
a time limit.

``stall_guard(seconds)`` makes a module-scoped autouse fixture that arms
``faulthandler.dump_traceback_later(seconds, exit=True)`` for the whole file:
if the file is not done by then, every thread's stack goes to the run's
stderr (not to pytest's capture, which a hard exit would lose) and the
process exits.  Under xdist the worker goes down, its test is reported as
failed and the run goes on, instead of the file eating the run's whole time
limit.  The guard is cancelled when the file ends.  Use it as
``_stall_guard = stall_guard(240)`` at module level, with a limit of a few
times the file's measured time.  ``scripts/stall_repro.py`` reproduces the
deadlock.
"""

import faulthandler
import os
import subprocess
import sys
import textwrap

import pytest


def _run_stderr(config):
    """A writable stream on the process's stderr as it was before pytest's
    capture took fd 2 (the xdist controller's stderr in a worker)."""
    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is None:
        return os.fdopen(os.dup(2), "w")
    with capman.global_and_fixture_disabled():
        return os.fdopen(os.dup(2), "w")


def stall_guard(seconds: float):
    """A module-scoped autouse fixture: the module's time limit."""

    @pytest.fixture(scope="module", autouse=True)
    def _guard(request):
        stream = _run_stderr(request.config)
        faulthandler.dump_traceback_later(seconds, exit=True, file=stream)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()
            stream.close()

    return _guard


def test_guard_dumps_every_thread_and_exits(tmp_path):
    """A file that outlives its limit prints the stacks of all its threads
    (the stalled test's frame among them) and its process exits, while the
    test that finishes in time passes."""
    (tmp_path / "test_stalls.py").write_text(textwrap.dedent("""
        import threading, time
        from tests.test_torch_stall_guard import stall_guard

        _stall_guard = stall_guard(2)

        def test_quick():
            pass

        def test_stalls_on_a_lock():
            lock = threading.Lock()
            lock.acquire()
            threading.Thread(target=time.sleep, args=(60,), daemon=True).start()
            lock.acquire()
    """))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         str(tmp_path / "test_stalls.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "Timeout (0:00:02)!" in proc.stderr
    assert "test_stalls_on_a_lock" in proc.stderr
    assert proc.stderr.count("Thread 0x") >= 2  # the main thread and the sleeper


def test_guard_is_cancelled_when_the_file_ends(tmp_path):
    """A file that ends within its limit leaves nothing armed: the process
    lives past the limit and exits 0."""
    (tmp_path / "test_quick.py").write_text(textwrap.dedent("""
        from tests.test_torch_stall_guard import stall_guard

        _stall_guard = stall_guard(1)

        def test_quick():
            pass

        def test_zz_after_the_file():
            pass
    """))
    (tmp_path / "test_zzz_later.py").write_text(
        "import time\n\ndef test_outlives_the_first_files_limit():\n    time.sleep(2)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         str(tmp_path)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Timeout" not in proc.stderr
