"""Coordination store: the etcd-shaped metadata plane, as a worker
sees it.

A copy of the part of the JAX package's ``service/coordination.py``
interface and in-process store that a worker uses: keys, TTL leases and
prefix watches.
``InMemoryStore`` serves a worker that runs without a shared store
(``--store-addr ''``); ``coordination_net.RemoteStore`` reaches the
JAX package's ``StoreServer``, which masters and workers of both
packages share.

Key schema kept from the reference (instance_mgr.cpp:34-41,
scheduler.cpp:25): ``XLLM:{DEFAULT,PREFILL,DECODE,MIX,ENCODE}:<name>``
for registrations and ``XLLM:SERVICE:ADDR`` for the master's address.
"""

from __future__ import annotations

import abc
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from xllm_service_tpu_torch.utils import threads

# Watch event: ("PUT" | "DELETE", key, value-or-None)
WatchEvent = Tuple[str, str, Optional[str]]
WatchCallback = Callable[[WatchEvent], None]

# Current master's reachable addresses, JSON {service_id, rpc, http},
# written under the master's lease. Workers watch this key so heartbeats
# and generation pushes follow a replica takeover.
KEY_MASTER_ADDR = "XLLM:SERVICE:ADDR"


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
    def lease_grant(self, ttl_s: float) -> int: ...

    @abc.abstractmethod
    def lease_keepalive(self, lease_id: int) -> bool: ...

    @abc.abstractmethod
    def lease_revoke(self, lease_id: int) -> None: ...

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

    def close(self) -> None:
        pass


class InMemoryStore(CoordinationStore):
    """Thread-safe in-process store with leases, revisions and watches.

    A sweeper thread expires leases: expiry deletes every key attached to
    the lease and fires DELETE watch events. Watch callbacks run on one
    dispatcher thread, in revision order."""

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
        self._closed = threading.Event()
        self._dispatch_q: "queue.Queue" = queue.Queue()
        threads.spawn("coord.dispatch", self._dispatch_loop).start()
        threads.spawn("coord.sweep", self._sweep_loop,
                      args=(sweep_interval_s,)).start()

    # -- internal ---------------------------------------------------------
    def _emit(self, ev_type: str, key: str, value: Optional[str]) -> None:
        """Caller holds the lock."""
        self.revision += 1
        callbacks = [cb for pfx, cb in self._watches.values()
                     if key.startswith(pfx)]
        if callbacks:
            self._dispatch_q.put((callbacks, (ev_type, key, value)))

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

    def add_watch(self, prefix: str, callback: WatchCallback) -> int:
        with self._lock:
            wid = self._next_watch
            self._next_watch += 1
            self._watches[wid] = (prefix, callback)
            return wid

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            self._watches.pop(watch_id, None)

    def close(self) -> None:
        self._closed.set()
        self._dispatch_q.put(None)
