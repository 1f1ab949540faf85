"""Supervised threads: no thread of this package dies silently.

A copy of the JAX package's ``utils/threads.py``. ``spawn()`` is the one
way this package starts a long-lived thread:

- a top-level handler that logs the traceback and counts the crash
  (``xllm_thread_crashes_total{root}``, mirrored into the worker's
  ``/metrics`` at scrape time by ``flush_metrics``) and emits a
  ``thread_crashed`` event when given an event log;
- an optional bounded-backoff restart for loops that must outlive any
  single failure (the worker's heartbeat loop): pass ``restart=`` a
  ``RetryPolicy`` (``utils/retry.py``, jittered, capped). Restarts are
  unbounded, only the backoff is bounded, and a run that stayed up longer
  than ``_HEALTHY_RUN_S`` resets the backoff ladder;
- a ``stop`` event, so shutdown interrupts the restart backoff instead
  of waiting it out.

``record_callback_error`` is the sibling for pool threads that swallow
a failed callback to protect their siblings (the store's watch
dispatcher, the guard's heal callbacks): it logs and counts
``xllm_callback_errors_total{root}``.

Both books are module-global (one process, one truth). Like
``threading.Thread``, the caller ``start()``s what ``spawn`` returns.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

_book_lock = make_lock("threads.book", 94)
_crashes: Dict[str, int] = {}
_callback_errors: Dict[str, int] = {}

# A supervised run that survived longer than this is healthy: the next
# crash starts the backoff ladder from the bottom.
_HEALTHY_RUN_S = 60.0

# The default restart policy of the worker's loops: capped exponential
# with full jitter (a fleet of loops crashing on the same hiccup must not
# restart in lockstep).
RESTART_POLICY = RetryPolicy(max_attempts=0, base_delay_s=0.2,
                             max_delay_s=10.0, jitter=0.5)


def record_crash(root: str, exc: BaseException,
                 events: Any = None, restarting: bool = False) -> None:
    """The supervised handler's body: log the traceback and count the
    crash, then (best-effort) emit ``thread_crashed``."""
    logger.error(
        "supervised thread %r crashed%s: %r\n%s", root,
        " (restarting)" if restarting else " (NOT restarted)", exc,
        "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)))
    with _book_lock:
        _crashes[root] = _crashes.get(root, 0) + 1
    try:
        if callable(events) and not hasattr(events, "emit"):
            events = events()     # a provider resolved at crash time
        if events is not None:
            events.emit("thread_crashed", root=root, error=repr(exc),
                        restarting=restarting)
    except Exception as e:  # noqa: BLE001 — the crash is logged and
        # counted above; a broken sink must not mask it
        logger.warning("thread_crashed event emit failed: %s", e)


def record_callback_error(root: str, exc: BaseException) -> None:
    """Telemetry for pool threads that swallow a bad callback so that the
    pool survives: log and count, never raise."""
    logger.error(
        "callback on %r raised (swallowed so the pool survives): %r\n%s",
        root, exc,
        "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)))
    with _book_lock:
        _callback_errors[root] = _callback_errors.get(root, 0) + 1


def crash_counts() -> Dict[str, int]:
    with _book_lock:
        return dict(_crashes)


def callback_error_counts() -> Dict[str, int]:
    with _book_lock:
        return dict(_callback_errors)


def flush_metrics(registry: Any) -> None:
    """Mirror both books into a registry at scrape time:
    ``xllm_thread_crashes_total{root}`` and
    ``xllm_callback_errors_total{root}``, set from the books (idempotent
    across scrapes)."""
    crashes = crash_counts()
    cb = callback_error_counts()
    if crashes:
        fam = registry.counter(
            "xllm_thread_crashes_total",
            "uncaught exceptions that escaped a supervised thread root",
            labelnames=("root",))
        for root, n in crashes.items():
            fam.set_total(n, root=root)
    if cb:
        fam = registry.counter(
            "xllm_callback_errors_total",
            "callback errors swallowed by pool/dispatcher threads "
            "(the pool survives; the error is counted here)",
            labelnames=("root",))
        for root, n in cb.items():
            fam.set_total(n, root=root)


class SupervisedThread(threading.Thread):
    """A ``threading.Thread`` whose run() is wrapped in the supervised
    handler. Made by ``spawn()``."""

    def __init__(self, root: str, target: Callable[..., Any],
                 args: Tuple = (), kwargs: Optional[Dict] = None,
                 daemon: bool = True,
                 restart: Optional[RetryPolicy] = None,
                 events: Any = None,
                 stop: Optional[threading.Event] = None,
                 thread_name: Optional[str] = None) -> None:
        super().__init__(name=thread_name or root, daemon=daemon)
        self.root = root
        self._target_fn = target
        self._target_args = tuple(args)
        self._target_kwargs = dict(kwargs or {})
        self._restart = restart
        self._events = events
        self._stop_event = stop
        self.crashes = 0            # this thread's own crash count

    def _should_restart(self) -> bool:
        if self._restart is None:
            return False
        return not (self._stop_event is not None
                    and self._stop_event.is_set())

    def run(self) -> None:
        try:
            # Imported here: obs sits above utils in the import graph.
            # The profiler attributes this thread's CPU to its root.
            from xllm_service_tpu_torch.obs import profiler
            profiler.register_thread_root(self.root)
        except Exception:  # noqa: BLE001 — CPU attribution is
            pass           # best-effort; the root starts regardless
        attempt = 0
        while True:
            started = time.monotonic()
            try:
                self._target_fn(*self._target_args,
                                **self._target_kwargs)
                return              # a clean exit: the loop chose to end
            except Exception as e:
                self.crashes += 1
                restarting = self._should_restart()
                record_crash(self.root, e, events=self._events,
                             restarting=restarting)
                if not restarting:
                    return
                if time.monotonic() - started >= _HEALTHY_RUN_S:
                    attempt = 0     # a healthy run resets the ladder
                if not self._restart.sleep(attempt,
                                           stop_event=self._stop_event):
                    return          # shutdown interrupted the backoff
                attempt += 1
            except BaseException as e:
                # SystemExit and KeyboardInterrupt are deliberate:
                # recorded, never restarted through. SystemExit ends the
                # thread (as threading's bootstrap does); anything else
                # goes on to threading.excepthook.
                record_crash(self.root, e, events=self._events,
                             restarting=False)
                if isinstance(e, SystemExit):
                    return
                raise


def spawn(name: str, target: Callable[..., Any], *,
          args: Tuple = (), kwargs: Optional[Dict] = None,
          daemon: bool = True,
          restart: Optional[RetryPolicy] = None,
          events: Any = None,
          stop: Optional[threading.Event] = None,
          thread_name: Optional[str] = None) -> SupervisedThread:
    """A supervised thread, not started. ``name`` is the stable root id
    (the ``root`` label of ``xllm_thread_crashes_total`` and of the
    ``thread_crashed`` event), ``thread_name`` the thread's own name.
    ``events`` may be an ``EventLog`` or a zero-argument callable that
    returns one at crash time."""
    return SupervisedThread(name, target, args=args, kwargs=kwargs,
                            daemon=daemon, restart=restart,
                            events=events, stop=stop,
                            thread_name=thread_name)
