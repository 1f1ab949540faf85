"""Store guard: deadlined health tracking around the coordination store.

A copy of the JAX package's ``service/store_guard.py``. The worker
wraps its store in a ``StoreGuard``; every ``CoordinationStore`` call
goes through ``_call``, which

- fires the catalog's ``store.*`` failpoints (``store.fail_rpc``,
  ``store.hang``, ``store.partition``), so that an outage is a
  deterministic event in a test;
- times the call against a deadline (``XLLM_STORE_DEADLINE_S``, 5 s), so
  that a hung store surfaces as a failure;
- tracks consecutive failures through healthy -> flaky -> down
  (``XLLM_STORE_DOWN_THRESHOLD`` consecutive failures, 3, = down),
  visible as the ``xllm_store_health`` gauge (2/1/0) and the
  ``store_outage_open`` / ``store_outage_close`` events;
- while partitioned (``store.partition`` armed) suppresses incoming
  watch events, as a client cut off from the store hears nothing;
- on the down -> healthy transition runs the heal callbacks
  synchronously, before the healing call returns;
- fences writes: when the owner installed ``fence_check`` and it returns
  True, a write raises ``EpochFencedError``.

Its surface is this package's ``CoordinationStore`` (no ``delete`` or
``compare_create``: a worker never calls them), so ``put`` is the one
fenced write.

``StoreOutageError`` is this package's one outage class: the guard
raises it, and so does ``coordination_net.RemoteStore`` for a call the
store never answered.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from xllm_service_tpu_torch.service.coordination import (
    CoordinationStore, WatchCallback)
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)

HEALTHY, FLAKY, DOWN = 2, 1, 0
_HEALTH_NAMES = {HEALTHY: "healthy", FLAKY: "flaky", DOWN: "down"}


class StoreOutageError(RuntimeError):
    """A coordination-store call failed because the store is
    unreachable (injected or real). Callers treat it as 'the control
    plane is gone', never as 'the answer is no'."""


class EpochFencedError(RuntimeError):
    """A store write was rejected because a higher-epoch master exists:
    the writer must self-demote, not retry."""


def _as_float(raw: Optional[str], default: float) -> float:
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class StoreGuard(CoordinationStore):
    """Health-tracking, failpoint-firing, epoch-fencing wrapper around any
    ``CoordinationStore``. One guard per plane: health is the client's
    view of the store."""

    def __init__(self, store: CoordinationStore, failpoints=None,
                 events=None) -> None:
        self.inner = store
        self.failpoints = failpoints
        self.events = events
        # Guards the health state and the callback books only; never held
        # across an inner store call or a callback.
        self._mu = make_lock("store_guard", 74)
        self._consecutive_failures = 0
        self._health = HEALTHY
        self._outage_since: Optional[float] = None
        self.outages_opened = 0
        # A store slower than this is a failure, not a wait.
        self.deadline_s = _as_float(
            os.environ.get("XLLM_STORE_DEADLINE_S"), 5.0)
        # Consecutive failures before healthy -> down (flaky between).
        self.down_threshold = max(1, int(_as_float(
            os.environ.get("XLLM_STORE_DOWN_THRESHOLD"), 3)))
        # True when this process's epoch is behind the cluster's: writes
        # are then rejected.
        self.fence_check: Optional[Callable[[], bool]] = None
        # Down -> healthy listeners, run on the thread that saw the heal,
        # before its store call returns.
        self._heal_cbs: List[Callable[[], None]] = []
        self._suppressed_events = 0

    # -- the health state machine ------------------------------------------
    @property
    def health(self) -> int:
        """2 = healthy, 1 = flaky, 0 = down (the gauge's value)."""
        with self._mu:
            return self._health

    @property
    def is_down(self) -> bool:
        with self._mu:
            return self._health == DOWN

    def on_heal(self, cb: Callable[[], None]) -> None:
        with self._mu:
            self._heal_cbs.append(cb)

    def state(self) -> Dict[str, Any]:
        with self._mu:
            return {"health": _HEALTH_NAMES[self._health],
                    "consecutive_failures": self._consecutive_failures,
                    "outages_opened": self.outages_opened,
                    "outage_open_s": (
                        round(time.monotonic() - self._outage_since, 3)
                        if self._outage_since is not None else 0.0),
                    "suppressed_watch_events": self._suppressed_events}

    def _partitioned(self) -> bool:
        """While ``store.partition`` is armed this client hears nothing
        from the store (checked per watch event)."""
        if self.failpoints is None:
            return False
        return self.failpoints.fire("store.partition") is not None

    def _record_failure(self, op: str, exc: Exception) -> None:
        opened = False
        with self._mu:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.down_threshold:
                if self._health != DOWN:
                    opened = True
                    self._outage_since = time.monotonic()
                    self.outages_opened += 1
                self._health = DOWN
            else:
                self._health = min(self._health, FLAKY)
        if opened:
            logger.warning("coordination store declared DOWN after %d "
                           "consecutive failures (last: %s on %s)",
                           self.down_threshold, exc, op)
            if self.events is not None:
                self.events.emit("store_outage_open", op=op,
                                 error=str(exc))

    def _record_success(self) -> None:
        with self._mu:
            was = self._health
            self._consecutive_failures = 0
            self._health = HEALTHY
            if was != DOWN:
                return
            healed_after = (time.monotonic() - self._outage_since
                            if self._outage_since is not None else 0.0)
            self._outage_since = None
            cbs = list(self._heal_cbs)
        logger.info("coordination store healed after %.3fs outage",
                    healed_after)
        if self.events is not None:
            self.events.emit("store_outage_close",
                             outage_s=round(healed_after, 3))
        for cb in cbs:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 — one broken heal hook
                # must not hide the heal from the others; counted
                threads.record_callback_error("store_guard.heal", e)

    # -- the guarded call --------------------------------------------------
    def _call(self, op: str, fn: Callable, *args: Any) -> Any:
        fp = self.failpoints
        if fp is not None:
            if fp.fire("store.partition") is not None:
                exc: Exception = StoreOutageError(
                    f"store partitioned (failpoint store.partition): {op}")
                self._record_failure(op, exc)
                raise exc
            if fp.fire("store.fail_rpc") is not None:
                exc = StoreOutageError(
                    f"store rpc failed (failpoint store.fail_rpc): {op}")
                self._record_failure(op, exc)
                raise exc
            hang = fp.fire("store.hang")
            if hang is not None:
                # A slow store: sleep the armed seconds, capped by the
                # deadline, then fail as a timed-out call would.
                delay = float(hang) if hang is not True else self.deadline_s
                time.sleep(min(delay, self.deadline_s))
                exc = StoreOutageError(
                    f"store call deadline exceeded (failpoint "
                    f"store.hang, {self.deadline_s}s): {op}")
                self._record_failure(op, exc)
                raise exc
        t0 = time.monotonic()
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 — any backend failure is a
            # health event; the cause rides the chain
            self._record_failure(op, e)
            raise StoreOutageError(f"store {op} failed: {e}") from e
        took = time.monotonic() - t0
        if took > self.deadline_s:
            # Answered past the deadline: counted against health, and the
            # caller still gets its answer.
            self._record_failure(op, TimeoutError(
                f"{op} took {took:.3f}s > {self.deadline_s}s"))
            return out
        self._record_success()
        return out

    def _write(self, op: str, fn: Callable, *args: Any) -> Any:
        fence = self.fence_check
        if fence is not None and fence():
            raise EpochFencedError(
                f"store write {op} rejected: a higher-epoch master "
                f"exists — self-demote instead of dual-serving")
        return self._call(op, fn, *args)

    # -- the CoordinationStore surface -------------------------------------
    def put(self, key: str, value: str,
            lease_id: Optional[int] = None) -> None:
        self._write("put", self.inner.put, key, value, lease_id)

    def get(self, key: str) -> Optional[str]:
        return self._call("get", self.inner.get, key)

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        return self._call("get_prefix", self.inner.get_prefix, prefix)

    def lease_grant(self, ttl_s: float) -> int:
        return self._call("lease_grant", self.inner.lease_grant, ttl_s)

    def lease_keepalive(self, lease_id: int) -> bool:
        return self._call("lease_keepalive", self.inner.lease_keepalive,
                          lease_id)

    def lease_revoke(self, lease_id: int) -> None:
        self._call("lease_revoke", self.inner.lease_revoke, lease_id)

    def add_watch(self, prefix: str, callback: WatchCallback) -> int:
        def guarded(event) -> None:
            if self._partitioned():
                # A partitioned client hears nothing: the DELETE of a
                # lease that expires mid-outage must not reach it.
                with self._mu:
                    self._suppressed_events += 1
                return
            callback(event)
        return self._call("add_watch", self.inner.add_watch, prefix,
                          guarded)

    def cancel_watch(self, watch_id: int) -> None:
        self._call("cancel_watch", self.inner.cancel_watch, watch_id)

    def close(self) -> None:
        self.inner.close()
