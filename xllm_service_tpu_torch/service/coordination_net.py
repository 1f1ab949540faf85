"""Networked coordination plane: ``InMemoryStore`` served over HTTP.

A copy of the JAX package's ``service/coordination_net.py``, the
deployment's equivalent of the reference's external etcd cluster. One
process runs ``StoreServer`` (``python -m
xllm_service_tpu_torch.service.coordination_net --port 0`` prints
``coordination store serving on <host:port>``); every master and worker
connects a ``RemoteStore``, which implements the same
``CoordinationStore`` interface. The wire is the JAX store's, so the
masters and workers of both packages share either package's server.
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
from xllm_service_tpu_torch.service.httpd import (
    HttpServer, Request, Response, Router, http_json)
from xllm_service_tpu_torch.service.store_guard import StoreOutageError
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)


def _q(s: str) -> str:
    return quote(s, safe="")


class StoreServer:
    """HTTP facade over an ``InMemoryStore``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: Optional[InMemoryStore] = None) -> None:
        self.store = store or InMemoryStore()
        router = Router()
        router.route("POST", "/kv/put", self._put)
        router.route("GET", "/kv/get", self._get)
        router.route("GET", "/kv/prefix", self._prefix)
        router.route("POST", "/kv/delete", self._delete)
        router.route("POST", "/kv/delete_prefix", self._delete_prefix)
        router.route("POST", "/lease/grant", self._grant)
        router.route("POST", "/lease/keepalive", self._keepalive)
        router.route("POST", "/lease/revoke", self._revoke)
        router.route("POST", "/txn/compare_create", self._compare_create)
        router.route("GET", "/watch", self._watch)
        router.route("GET", "/rev", self._rev)
        self._srv = HttpServer(host, port, router)

    @property
    def address(self) -> str:
        return self._srv.address

    def start(self) -> "StoreServer":
        self._srv.start()
        return self

    def stop(self) -> None:
        self._srv.stop()
        self.store.close()

    # -- handlers ---------------------------------------------------------
    def _put(self, req: Request) -> Response:
        d = req.json()
        try:
            self.store.put(d["key"], d["value"], d.get("lease_id"))
        except KeyError as e:
            return Response.json({"ok": False, "error": str(e)}, status=400)
        return Response.json({"ok": True})

    def _get(self, req: Request) -> Response:
        v = self.store.get(req.param("key"))
        return Response.json({"value": v})

    def _prefix(self, req: Request) -> Response:
        return Response.json({"kvs": self.store.get_prefix(
            req.param("prefix"))})

    def _delete(self, req: Request) -> Response:
        return Response.json(
            {"deleted": self.store.delete(req.json()["key"])})

    def _delete_prefix(self, req: Request) -> Response:
        return Response.json(
            {"count": self.store.delete_prefix(req.json()["prefix"])})

    def _grant(self, req: Request) -> Response:
        return Response.json(
            {"lease_id": self.store.lease_grant(req.json()["ttl_s"])})

    def _keepalive(self, req: Request) -> Response:
        return Response.json(
            {"ok": self.store.lease_keepalive(req.json()["lease_id"])})

    def _revoke(self, req: Request) -> Response:
        self.store.lease_revoke(req.json()["lease_id"])
        return Response.json({"ok": True})

    def _compare_create(self, req: Request) -> Response:
        d = req.json()
        created = self.store.compare_create(d["key"], d["value"],
                                            d.get("lease_id"))
        return Response.json({"created": created})

    def _rev(self, req: Request) -> Response:
        return Response.json({"rev": self.store.revision})

    def _watch(self, req: Request) -> Response:
        rev = int(req.param("rev", "0"))
        timeout = min(float(req.param("timeout", "10")), 30.0)
        if rev > self.store.revision:
            # A resume revision from the FUTURE: the client watched a
            # previous incarnation of this store (we restarted, wiped).
            # Answer immediately with the real revision so the client's
            # regression handling can re-bootstrap, instead of blocking
            # the long-poll until the new log catches up.
            return Response.json({"rev": self.store.revision,
                                  "compacted": False, "events": []})
        # Events older than the bounded log's head are gone; tell the
        # watcher so it can resync instead of silently missing deletes.
        compacted = rev + 1 < self.store.oldest_retained_revision
        new_rev, events = self.store.events_since(
            rev, req.param("prefix"), timeout)
        return Response.json({"rev": new_rev, "compacted": compacted,
                              "events": [list(e) for e in events]})


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

    def delete(self, key: str) -> bool:
        return self._call("POST", "/kv/delete", {"key": key})["deleted"]

    def delete_prefix(self, prefix: str) -> int:
        return self._call("POST", "/kv/delete_prefix",
                          {"prefix": prefix})["count"]

    def lease_grant(self, ttl_s: float) -> int:
        return self._call("POST", "/lease/grant",
                          {"ttl_s": ttl_s})["lease_id"]

    def lease_keepalive(self, lease_id: int) -> bool:
        return self._call("POST", "/lease/keepalive",
                          {"lease_id": lease_id})["ok"]

    def lease_revoke(self, lease_id: int) -> None:
        self._call("POST", "/lease/revoke", {"lease_id": lease_id})

    def compare_create(self, key: str, value: str,
                       lease_id: Optional[int] = None) -> bool:
        return self._call("POST", "/txn/compare_create",
                          {"key": key, "value": value,
                           "lease_id": lease_id})["created"]

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


def main(argv=None) -> int:
    """Standalone coordination-store server (the deployment's 'etcd')."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        description="xllm-service-tpu coordination store server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=12379)
    args = parser.parse_args(argv)
    server = StoreServer(args.host, args.port).start()
    print(f"coordination store serving on {server.address}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
