"""The port's swallowed lock-order violations fail the test that made
them.

``LockOrderViolation`` subclasses ``AssertionError``, and several of the
port's paths wrap callbacks in a broad ``except Exception`` (the
worker's routes, the store's watch dispatcher, the supervised loops): a
violation raised in a port thread can be swallowed there and fail
nothing. The suite's own fixture counts only the JAX package's
violations. ``_no_swallowed_port_lock_violations`` diffs the port's
book (``xllm_service_tpu_torch.utils.locks.violations()``) around each
test and fails the test that added to it, unless the test is marked
``expected_lock_violations``. Every ``tests/test_torch_*.py`` imports
it, which makes it autouse there:

    from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401
"""

import threading

import pytest

from xllm_service_tpu_torch.utils import locks


def new_port_violations(node, before: int):
    """The port's violations recorded since ``before`` (its count when
    ``node`` started), or [] when ``node`` expects them."""
    if node.get_closest_marker("expected_lock_violations"):
        return []
    return locks.violations()[before:]


def check_port_lock_violations(node, before: int) -> None:
    new = new_port_violations(node, before)
    assert not new, (f"port lock-order violations were raised (and "
                     f"possibly swallowed) during this test: {new}")


@pytest.fixture(autouse=True)
def _no_swallowed_port_lock_violations(request):
    before = locks.violation_count()
    yield
    check_port_lock_violations(request.node, before)


def _swallowed_violation() -> None:
    """A port thread that takes two checked locks against their ranks
    and swallows the raise, as a broad ``except`` on a worker path
    would."""
    hi, lo = locks.CheckedLock("t.hi", 50), locks.CheckedLock("t.lo", 40)

    def body():
        try:
            with hi:
                with lo:
                    pass
        except Exception:  # noqa: BLE001 — swallowed on purpose
            pass

    t = threading.Thread(target=body)
    t.start()
    t.join()


@pytest.mark.expected_lock_violations
def test_a_swallowed_port_violation_fails_the_check(request):
    """The fixture's check, called on this test's node with the marker
    set aside, fails on a violation a port thread swallowed; the marker
    (which keeps the suite green) silences it."""
    before = locks.violation_count()
    _swallowed_violation()
    assert locks.violation_count() == before + 1

    class Unmarked:
        @staticmethod
        def get_closest_marker(name):
            return None

    with pytest.raises(AssertionError, match="t.lo"):
        check_port_lock_violations(Unmarked(), before)
    check_port_lock_violations(request.node, before)
    assert new_port_violations(Unmarked(), locks.violation_count()) == []
