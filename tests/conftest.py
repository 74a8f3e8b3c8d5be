"""Test bootstrap: hypothesis stand-in + a stub-compatible ``timeout`` marker.

When the real ``hypothesis`` / ``pytest-timeout`` packages are installed they
are used as-is; otherwise minimal local fallbacks keep the same test sources
running (deterministic example drawing, SIGALRM-based timeouts).  The
``timeout`` marker is what lets a deadlocked async serving step fail fast in
the serving-conformance CI job instead of hanging the runner.
"""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_stub
    sys.modules['hypothesis'] = _hypothesis_stub
    sys.modules['hypothesis.strategies'] = _hypothesis_stub.strategies

try:
    import pytest_timeout  # noqa: F401
    _HAVE_PYTEST_TIMEOUT = True
except ImportError:
    _HAVE_PYTEST_TIMEOUT = False


def pytest_configure(config):
    config.addinivalue_line(
        'markers',
        'timeout(seconds): fail the test if it runs longer than this '
        '(pytest-timeout when installed, SIGALRM fallback otherwise)')
    config.addinivalue_line(
        'markers',
        'needs_cuda: runs only on a CUDA device (the test skips itself '
        'without one)')


if not _HAVE_PYTEST_TIMEOUT:
    import signal

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(item):
        marker = item.get_closest_marker('timeout')
        if marker is None or not hasattr(signal, 'SIGALRM'):
            yield
            return
        seconds = int(marker.args[0] if marker.args
                      else marker.kwargs.get('seconds', 60))

        def _alarm(signum, frame):
            raise TimeoutError(
                f'{item.nodeid} exceeded its {seconds}s timeout marker')

        old = signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(seconds)
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)
