"""Dynamic analysis gates for a test suite
(paddle_tpu/analyze/pytest_plugin.py; docs/analyze.md). Load it with
``pytest -p paddle_tpu_torch.analyze.pytest_plugin``:

* **Thread-leak gate** — an autouse fixture snapshots the live Python
  threads around every test and fails the test if it leaves new ones
  running (after a short grace for clean shutdown paths to finish). Opt
  a test out with ``@pytest.mark.allow_thread_leaks`` (and say why).
* **Retrace budget** — the ``max_retraces`` fixture returns the
  :func:`paddle_tpu_torch.analyze.max_retraces` context manager: a test
  declares how many programs a region may make (CUDA graph captures,
  ``torch.export`` loads) and fails if the live count exceeds it.

Plus the ``tree_analysis`` session-scoped fixture: ONE full-tree run of
``lint.lint_tree()`` over the port (all nine checkers including the
cross-module PTA006 lock graph) shared by every test that asserts on
tree-wide findings. Mark such tests ``@pytest.mark.analyze_tree``.
"""

import threading
import time

import pytest

# Seconds a finished test gets for its threads to wind down before the
# gate calls them leaked (cancellation handshakes poll at 100 ms —
# reader/decorator._cancellable_put — so 2 s is ~20 polls).
LEAK_GRACE_S = 2.0

# Thread-name prefixes never counted as leaks (test-harness machinery).
ALLOWED_THREAD_PREFIXES = ("pytest-timeout",)


def _leaked_threads(before):
    return [t for t in threading.enumerate()
            if t.ident not in before and t.is_alive()
            and not t.name.startswith(ALLOWED_THREAD_PREFIXES)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "allow_thread_leaks: opt a test out of the analyze thread-leak "
        "gate (justify in a comment)")
    config.addinivalue_line(
        "markers",
        "analyze_tree: test consumes the suite-wide single-run full-tree "
        "static analysis (session-scoped tree_analysis fixture)")


@pytest.fixture(autouse=True)
def _thread_leak_gate(request):
    """Fail any test that leaves threads running."""
    if request.node.get_closest_marker("allow_thread_leaks"):
        yield
        return
    before = {t.ident for t in threading.enumerate()}
    yield
    leaked = _leaked_threads(before)
    deadline = time.monotonic() + LEAK_GRACE_S
    while leaked and time.monotonic() < deadline:
        time.sleep(0.02)
        leaked = _leaked_threads(before)
    if leaked:
        pytest.fail(
            "test leaked %d thread(s): %s — join them or wire the "
            "cancellation idiom (data/feeder.py, "
            "reader/decorator._cancellable_put)"
            % (len(leaked), sorted(t.name for t in leaked)),
            pytrace=False)


@pytest.fixture(scope="session", name="tree_analysis")
def _tree_analysis_fixture():
    """ONE suite-wide static-analysis pass over the port's tree:
    ``{"findings": [Finding], "files": N}``."""
    from paddle_tpu_torch.analyze import lint

    findings, n_files = lint.lint_tree()
    return {"findings": findings, "files": n_files}


@pytest.fixture(name="max_retraces")
def _max_retraces_fixture():
    """The retrace-budget context manager as a fixture: ``with
    max_retraces(3) as w: ...`` fails the test when the region makes
    more than 3 programs; ``w.compiles``/``w.events`` expose the live
    count for exact-equality pins."""
    from paddle_tpu_torch.analyze import max_retraces as budget

    return budget
