"""Coordination store: the etcd-shaped metadata plane.

A copy of the JAX package's ``service/coordination.py``: keys, TTL
leases, ``compare_create`` transactions (the master's election) and
prefix watches.
``InMemoryStore`` serves a process that runs without a shared store
(a worker with ``--store-addr ''``, a master with ``--etcd-addr ''``)
and backs ``coordination_net.StoreServer``, which serves it over
HTTP/JSON to the masters and workers of both packages
(``coordination_net.RemoteStore``); ``etcd_store.EtcdStore`` speaks
etcd's v3 JSON gateway.

Key schema kept from the reference (instance_mgr.cpp:34-41,
scheduler.cpp:25): ``XLLM:{DEFAULT,PREFILL,DECODE,MIX,ENCODE}:<name>``,
``XLLM:LOADMETRICS:``, ``XLLM:CACHE:``, ``XLLM:SERVICE:MASTER``, and
``XLLM:SERVICE:ADDR`` for the master's address.
"""

from __future__ import annotations

import abc
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.utils import threads

# Watch event: ("PUT" | "DELETE", key, value-or-None)
WatchEvent = Tuple[str, str, Optional[str]]
WatchCallback = Callable[[WatchEvent], None]

# Current master's reachable addresses, JSON {service_id, rpc, http},
# written under the master's lease. Workers watch this key so heartbeats
# and generation pushes follow a replica takeover.
KEY_MASTER_ADDR = "XLLM:SERVICE:ADDR"
KEY_MASTER = "XLLM:SERVICE:MASTER"
KEY_LOADMETRICS = "XLLM:LOADMETRICS:"
KEY_CACHE = "XLLM:CACHE:"
# Fenced master epochs: each election mints XLLM:SERVICE:EPOCH:<n> via
# compare_create with NO lease. The keys are a monotonic ledger that
# survives master death, so a deposed master healing from a partition
# finds a higher epoch and demotes itself instead of serving beside the
# new leader.
KEY_EPOCH_PREFIX = "XLLM:SERVICE:EPOCH:"


def instance_prefix(instance_type: str) -> str:
    return f"XLLM:{instance_type}:"


class CoordinationStore(abc.ABC):
    """etcd-shaped KV interface (reference etcd_client.h:32-144)."""

    @abc.abstractmethod
    def put(self, key: str, value: str,
            lease_id: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    def get_prefix(self, prefix: str) -> Dict[str, str]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...

    @abc.abstractmethod
    def delete_prefix(self, prefix: str) -> int: ...

    @abc.abstractmethod
    def lease_grant(self, ttl_s: float) -> int: ...

    @abc.abstractmethod
    def lease_keepalive(self, lease_id: int) -> bool: ...

    @abc.abstractmethod
    def lease_revoke(self, lease_id: int) -> None: ...

    @abc.abstractmethod
    def compare_create(self, key: str, value: str,
                       lease_id: Optional[int] = None) -> bool:
        """Atomically create ``key`` iff absent (leader-election txn,
        reference etcd_client.cpp:47-62). True iff this caller created it."""

    @abc.abstractmethod
    def add_watch(self, prefix: str, callback: WatchCallback) -> int: ...

    @abc.abstractmethod
    def cancel_watch(self, watch_id: int) -> None: ...

    def put_json(self, key: str, value: Any,
                 lease_id: Optional[int] = None) -> None:
        self.put(key, json.dumps(value), lease_id)

    def get_json(self, key: str) -> Optional[Any]:
        v = self.get(key)
        return None if v is None else json.loads(v)

    def get_prefix_json(self, prefix: str) -> Dict[str, Any]:
        return {k: json.loads(v) for k, v in self.get_prefix(prefix).items()}

    def close(self) -> None:
        pass


class InMemoryStore(CoordinationStore):
    """Thread-safe in-process store with leases, revisions and watches.

    A sweeper thread expires leases: expiry deletes every key attached to
    the lease and fires DELETE watch events (how the master learns of a
    dead worker or a dead master). Watch callbacks run on one dispatcher
    thread, in revision order. A bounded event log serves the long-poll
    watchers of ``coordination_net.StoreServer`` (``events_since``)."""

    def __init__(self, sweep_interval_s: float = 0.05) -> None:
        self._lock = threading.RLock()
        self._data: Dict[str, str] = {}
        self._key_lease: Dict[str, int] = {}
        self._leases: Dict[int, float] = {}       # id → deadline
        self._lease_ttl: Dict[int, float] = {}
        self._next_lease = 1
        self._next_watch = 1
        self._watches: Dict[int, Tuple[str, WatchCallback]] = {}
        self.revision = 0
        self._events: List[Tuple[int, WatchEvent]] = []
        self._events_cv = threading.Condition(self._lock)
        self._max_events = 65536
        self._closed = threading.Event()
        self._dispatch_q: "queue.Queue" = queue.Queue()
        # Restarted with backoff after a crash, as the JAX store's: the
        # queue and the lease books outlive a restart.
        threads.spawn("coord.dispatch", self._dispatch_loop,
                      thread_name="coord-dispatch",
                      restart=threads.RESTART_POLICY).start()
        threads.spawn("coord.sweep", self._sweep_loop,
                      args=(sweep_interval_s,), thread_name="coord-sweeper",
                      restart=threads.RESTART_POLICY).start()

    # -- internal ---------------------------------------------------------
    def _emit(self, ev_type: str, key: str, value: Optional[str]) -> None:
        """Caller holds the lock."""
        self.revision += 1
        ev = (ev_type, key, value)
        self._events.append((self.revision, ev))
        if len(self._events) > self._max_events:
            del self._events[: self._max_events // 2]
        callbacks = [cb for pfx, cb in self._watches.values()
                     if key.startswith(pfx)]
        self._events_cv.notify_all()
        if callbacks:
            self._dispatch_q.put((callbacks, ev))

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            callbacks, ev = item
            for cb in callbacks:
                try:
                    cb(ev)
                except Exception as e:  # noqa: BLE001 — one broken
                    # watcher must not starve the others; counted
                    threads.record_callback_error("coord.dispatch", e)

    def _delete_locked(self, key: str) -> bool:
        if key not in self._data:
            return False
        del self._data[key]
        self._key_lease.pop(key, None)
        self._emit("DELETE", key, None)
        return True

    def _sweep_loop(self, interval: float) -> None:
        while not self._closed.wait(interval):
            now = time.monotonic()
            with self._lock:
                for lid in [lid for lid, dl in self._leases.items()
                            if dl <= now]:
                    self._revoke_locked(lid)

    def _revoke_locked(self, lease_id: int) -> None:
        self._leases.pop(lease_id, None)
        self._lease_ttl.pop(lease_id, None)
        for key in [k for k, l in self._key_lease.items() if l == lease_id]:
            self._delete_locked(key)

    # -- CoordinationStore ------------------------------------------------
    def put(self, key: str, value: str,
            lease_id: Optional[int] = None) -> None:
        with self._lock:
            if lease_id is not None and lease_id not in self._leases:
                raise KeyError(f"unknown lease {lease_id}")
            self._data[key] = value
            if lease_id is not None:
                self._key_lease[key] = lease_id
            else:
                self._key_lease.pop(key, None)
            self._emit("PUT", key, value)

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        with self._lock:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._delete_locked(key)

    def delete_prefix(self, prefix: str) -> int:
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
            for k in keys:
                self._delete_locked(k)
            return len(keys)

    def lease_grant(self, ttl_s: float) -> int:
        with self._lock:
            lid = self._next_lease
            self._next_lease += 1
            self._leases[lid] = time.monotonic() + ttl_s
            self._lease_ttl[lid] = ttl_s
            return lid

    def lease_keepalive(self, lease_id: int) -> bool:
        with self._lock:
            if lease_id not in self._leases:
                return False
            self._leases[lease_id] = (time.monotonic()
                                      + self._lease_ttl[lease_id])
            return True

    def lease_revoke(self, lease_id: int) -> None:
        with self._lock:
            self._revoke_locked(lease_id)

    def compare_create(self, key: str, value: str,
                       lease_id: Optional[int] = None) -> bool:
        with self._lock:
            if key in self._data:
                return False
            self.put(key, value, lease_id)
            return True

    def add_watch(self, prefix: str, callback: WatchCallback) -> int:
        with self._lock:
            wid = self._next_watch
            self._next_watch += 1
            self._watches[wid] = (prefix, callback)
            return wid

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            self._watches.pop(watch_id, None)

    # -- long-poll support (used by StoreServer) --------------------------
    def events_since(self, rev: int, prefix: str,
                     timeout_s: float = 10.0
                     ) -> Tuple[int, List[WatchEvent]]:
        """Block until an event with revision > ``rev`` under ``prefix``
        exists (or timeout). Returns (latest_revision, matching events)."""
        deadline = time.monotonic() + timeout_s
        with self._events_cv:
            while True:
                evs = [e for r, e in self._events
                       if r > rev and e[1].startswith(prefix)]
                if evs:
                    return self.revision, evs
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self.revision, []
                self._events_cv.wait(remaining)

    @property
    def oldest_retained_revision(self) -> int:
        with self._lock:
            return self._events[0][0] if self._events else self.revision + 1

    def close(self) -> None:
        self._closed.set()
        self._dispatch_q.put(None)
