"""The worker's client of the networked coordination plane.

``RemoteStore`` implements ``CoordinationStore`` against the JAX
package's ``StoreServer`` (``python -m
xllm_service_tpu.service.coordination_net``), the store that masters and
workers of both packages share; a copy of the JAX package's client.
Watches are long-polls on the store's revision counter, so a remote
watcher sees the PUT/DELETE stream in order.

A call the store never answered (connection refused, reset, timed out)
raises ``StoreOutageError`` (the one class, ``service/store_guard.py``):
the heartbeat loop tells an outage, during which the worker keeps
serving, from a lease the store says is dead.
"""

from __future__ import annotations

import http.client
import logging
import threading
from typing import Dict, Optional
from urllib.parse import quote

from xllm_service_tpu_torch.service.coordination import (
    CoordinationStore, InMemoryStore, WatchCallback)
from xllm_service_tpu_torch.service.httpd import http_json
from xllm_service_tpu_torch.service.store_guard import StoreOutageError
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)


def _q(s: str) -> str:
    return quote(s, safe="")


class RemoteStore(CoordinationStore):
    """Client-side ``CoordinationStore`` over a ``StoreServer``."""

    def __init__(self, address: str, timeout: float = 10.0) -> None:
        self.address = address
        self.timeout = timeout
        self._watches: Dict[int, threading.Event] = {}
        self._next_watch = 1
        self._lock = make_lock("coordination_net", 60)
        # Watch-reconnect pacing, jittered so a fleet of watchers does
        # not hammer a restarting store in lockstep.
        self._watch_retry = RetryPolicy(base_delay_s=0.25, max_delay_s=5.0)

    def _call(self, method: str, path: str, obj=None):
        try:
            status, resp = http_json(method, self.address, path, obj,
                                     timeout=self.timeout)
        except (OSError, http.client.HTTPException) as e:
            raise StoreOutageError(f"store {path} unreachable: {e}") from e
        if status != 200:
            raise RuntimeError(f"store {path} -> {status}: {resp}")
        return resp

    def put(self, key: str, value: str,
            lease_id: Optional[int] = None) -> None:
        self._call("POST", "/kv/put",
                   {"key": key, "value": value, "lease_id": lease_id})

    def get(self, key: str) -> Optional[str]:
        return self._call("GET", f"/kv/get?key={_q(key)}")["value"]

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        return self._call("GET", f"/kv/prefix?prefix={_q(prefix)}")["kvs"]

    def lease_grant(self, ttl_s: float) -> int:
        return self._call("POST", "/lease/grant",
                          {"ttl_s": ttl_s})["lease_id"]

    def lease_keepalive(self, lease_id: int) -> bool:
        return self._call("POST", "/lease/keepalive",
                          {"lease_id": lease_id})["ok"]

    def lease_revoke(self, lease_id: int) -> None:
        self._call("POST", "/lease/revoke", {"lease_id": lease_id})

    def add_watch(self, prefix: str, callback: WatchCallback) -> int:
        with self._lock:
            wid = self._next_watch
            self._next_watch += 1
            stop = threading.Event()
            self._watches[wid] = stop
        threads.spawn("coordination_net.watch_loop", self._watch_loop,
                      args=(prefix, callback, stop),
                      thread_name=f"remote-watch-{wid}").start()
        return wid

    def _deliver(self, callback: WatchCallback, ev) -> None:
        try:
            callback(ev)
        except Exception as e:  # noqa: BLE001 — a broken callback must
            # not kill the watch loop; counted
            threads.record_callback_error("coordination_net.watch_loop", e)

    def _watch_loop(self, prefix: str, callback: WatchCallback,
                    stop: threading.Event) -> None:
        # Deliver only future events: start at the server's current
        # revision, not 0.
        rev: Optional[int] = None
        attempt = 0
        while not stop.is_set() and rev is None:
            try:
                rev = self._call("GET", "/rev")["rev"]
            except Exception:  # noqa: BLE001 — store still booting or
                # unreachable; this loop is the retry
                self._watch_retry.sleep(attempt, stop_event=stop)
                attempt += 1
        # The last state this watcher delivered per key: the baseline of
        # a resync after the store's log moved past (or behind) ``rev``.
        known: Dict[str, str] = {}
        attempt = 0
        while not stop.is_set():
            try:
                status, resp = http_json(
                    "GET", self.address,
                    f"/watch?prefix={_q(prefix)}&rev={rev}&timeout=5",
                    timeout=self.timeout + 10)
                if status != 200:
                    self._watch_retry.sleep(attempt, stop_event=stop)
                    attempt += 1
                    continue
                attempt = 0
                # A younger log (the store restarted) or a compacted one:
                # re-bootstrap from get_prefix and deliver the diff.
                resync = resp["rev"] < rev or resp.get("compacted")
                rev = resp["rev"]
                if resync:
                    logger.warning("watch on %r lost the store's event "
                                   "log; resyncing", prefix)
                    self._resync(prefix, known, callback)
                    continue
                for ev_type, key, value in resp["events"]:
                    if stop.is_set():
                        return
                    if ev_type == "DELETE":
                        known.pop(key, None)
                    else:
                        known[key] = value
                    self._deliver(callback, (ev_type, key, value))
            except Exception:  # noqa: BLE001 — store restarting or
                # unreachable
                self._watch_retry.sleep(attempt, stop_event=stop)
                attempt += 1

    def _resync(self, prefix: str, known: Dict[str, str],
                callback: WatchCallback) -> None:
        """Synthetic DELETEs for keys that vanished, PUTs for new or
        changed values."""
        current = self.get_prefix(prefix)
        for key in [k for k in known if k not in current]:
            known.pop(key)
            self._deliver(callback, ("DELETE", key, None))
        for key, value in current.items():
            if known.get(key) != value:
                known[key] = value
                self._deliver(callback, ("PUT", key, value))

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            stop = self._watches.pop(watch_id, None)
        if stop:
            stop.set()

    def close(self) -> None:
        with self._lock:
            for stop in self._watches.values():
                stop.set()
            self._watches.clear()


def connect_store(addr: str) -> CoordinationStore:
    """'' → a fresh in-process store; 'etcd://host:port' → ``EtcdStore``
    (an etcd v3 JSON gateway, ``service/etcd_store.py``); 'host:port' →
    ``RemoteStore`` against a ``StoreServer``."""
    if not addr:
        return InMemoryStore()
    if addr.startswith("etcd://"):
        from xllm_service_tpu_torch.service.etcd_store import EtcdStore
        return EtcdStore(addr[len("etcd://"):])
    return RemoteStore(addr)
