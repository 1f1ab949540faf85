"""etcd v3 client of the worker's coordination plane.

A copy of the JAX package's ``service/etcd_store.py`` ``EtcdStore``: the
reference coordinates its whole fleet through an etcd cluster (TTL
leases, the create-if-absent election txn, prefix watches), and this is
how a worker of this package joins such a deployment
(``connect_store("etcd://host:port")``).

Transport is etcd's JSON gateway (``/v3/kv/range`` and the rest, etcd
>= 3.4; ``api_prefix`` covers ``/v3beta`` / ``/v3alpha``): HTTP/JSON
with base64 keys, no grpc. A watch holds one streaming POST per prefix
and reconnects from the last seen revision when the stream drops, so no
event is lost across a reconnect; when compaction ate that revision it
resyncs by diffing the prefix against what it last delivered. A
callback that raises is counted as
``xllm_callback_errors_total{root="etcd.watch_loop"}`` and its event
dropped, never redelivered in a loop.

The servers are the JAX package's: ``MockEtcdServer`` in tests and the
native ``csrc/xllm_etcd.cpp``, which ``chip_smoke.py`` builds with g++.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import threading
from typing import Dict, Optional, Tuple

from xllm_service_tpu_torch.service.coordination import (
    CoordinationStore, WatchCallback)
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)


def _safe_callback(callback: WatchCallback, ev) -> None:
    """Deliver one watch event; a raising callback is counted and its
    event dropped for it (watchers tolerate a resync)."""
    try:
        callback(ev)
    except Exception as e:  # noqa: BLE001 — counted, the loop goes on
        threads.record_callback_error("etcd.watch_loop", e)


def _b64(s: str) -> str:
    return base64.b64encode(s.encode("utf-8")).decode("ascii")


def _ub64(s: str) -> str:
    return base64.b64decode(s).decode("utf-8")


def range_end_for_prefix(prefix: str) -> str:
    """etcd's prefix convention: range_end is the prefix with its last
    byte + 1 (trailing 0xff bytes drop); an empty or all-0xff prefix
    scans from "\\0" (every key)."""
    b = bytearray(prefix.encode("utf-8"))
    while b:
        if b[-1] < 0xFF:
            b[-1] += 1
            return base64.b64encode(bytes(b)).decode("ascii")
        b.pop()
    return base64.b64encode(b"\0").decode("ascii")


class EtcdStore(CoordinationStore):
    """``CoordinationStore`` over an etcd v3 JSON gateway at ``addr``
    ("host:port")."""

    def __init__(self, addr: str, api_prefix: str = "/v3",
                 timeout_s: float = 5.0) -> None:
        host, _, port = addr.partition(":")
        self._host, self._port = host, int(port or 2379)
        self._api = api_prefix.rstrip("/")
        self._timeout = timeout_s
        # Read timeout of a watch stream's socket: an idle watch is
        # normal, an endless silence is a dead peer; on expiry the loop
        # reconnects from its revision and loses nothing.
        self._watch_timeout_s = float(
            os.environ.get("XLLM_ETCD_WATCH_TIMEOUT_S", "300") or 300)
        # Jittered reconnect pacing, reset by a healthy stream.
        self._watch_retry = RetryPolicy(base_delay_s=0.1,
                                        max_delay_s=2.0)
        self._watches: Dict[int, Tuple[threading.Event,
                                       Optional[http.client.HTTPConnection]]] \
            = {}
        self._watch_seq = 0
        self._lock = make_lock("etcd.watches", 60)

    # -- plumbing ----------------------------------------------------------
    def _call(self, path: str, body: Dict) -> Dict:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)
        try:
            conn.request("POST", self._api + path, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"etcd {path} -> {resp.status}: {data[:200]!r}")
            return json.loads(data) if data else {}
        finally:
            conn.close()

    # -- KV ----------------------------------------------------------------
    def put(self, key: str, value: str,
            lease_id: Optional[int] = None) -> None:
        body = {"key": _b64(key), "value": _b64(value)}
        if lease_id is not None:
            body["lease"] = str(lease_id)
        self._call("/kv/put", body)

    def get(self, key: str) -> Optional[str]:
        out = self._call("/kv/range", {"key": _b64(key)})
        kvs = out.get("kvs") or []
        # protojson drops empty fields: an empty value has no "value".
        return _ub64(kvs[0].get("value", "")) if kvs else None

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        out = self._call("/kv/range", {
            "key": _b64(prefix), "range_end": range_end_for_prefix(prefix)})
        return {_ub64(kv["key"]): _ub64(kv.get("value", ""))
                for kv in out.get("kvs") or []}

    def delete(self, key: str) -> bool:
        out = self._call("/kv/deleterange", {"key": _b64(key)})
        return int(out.get("deleted", 0)) > 0

    def delete_prefix(self, prefix: str) -> int:
        out = self._call("/kv/deleterange", {
            "key": _b64(prefix), "range_end": range_end_for_prefix(prefix)})
        return int(out.get("deleted", 0))

    # -- leases ------------------------------------------------------------
    def lease_grant(self, ttl_s: float) -> int:
        out = self._call("/lease/grant",
                         {"TTL": str(max(1, int(round(ttl_s))))})
        return int(out["ID"])

    def lease_keepalive(self, lease_id: int) -> bool:
        try:
            out = self._call("/lease/keepalive", {"ID": str(lease_id)})
        except RuntimeError:
            return False
        result = out.get("result", out)
        return int(result.get("TTL", 0)) > 0

    def lease_revoke(self, lease_id: int) -> None:
        try:
            self._call("/kv/lease/revoke", {"ID": str(lease_id)})
        except RuntimeError:
            # Older gateways serve /lease/revoke instead.
            self._call("/lease/revoke", {"ID": str(lease_id)})

    # -- txn ---------------------------------------------------------------
    def compare_create(self, key: str, value: str,
                       lease_id: Optional[int] = None) -> bool:
        """The election txn: create iff the key was never written
        (CREATE revision 0; reference etcd_client.cpp:47-62)."""
        put_op = {"key": _b64(key), "value": _b64(value)}
        if lease_id is not None:
            put_op["lease"] = str(lease_id)
        out = self._call("/kv/txn", {
            "compare": [{"key": _b64(key), "target": "CREATE",
                         "result": "EQUAL", "create_revision": "0"}],
            "success": [{"request_put": put_op}],
        })
        return bool(out.get("succeeded", False))

    # -- watches -----------------------------------------------------------
    def add_watch(self, prefix: str, callback: WatchCallback) -> int:
        with self._lock:
            self._watch_seq += 1
            wid = self._watch_seq
            stop = threading.Event()
            self._watches[wid] = (stop, None)
        # Supervised and restarted: the loop's own reconnect handles a
        # dropped stream, the restart a crash outside it.
        t = threads.spawn("etcd.watch_loop", self._watch_loop,
                          args=(wid, prefix, callback, stop),
                          thread_name=f"etcd-watch-{wid}",
                          restart=threads.RESTART_POLICY, stop=stop)
        t.start()
        return wid

    def _watch_loop(self, wid: int, prefix: str, callback: WatchCallback,
                    stop: threading.Event) -> None:
        next_rev = 0                 # 0 = from now; > 0 = resume point
        # The value last delivered per key: the resync's diff base.
        known: Dict[str, str] = {}
        attempt = 0
        while not stop.is_set():
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._watch_timeout_s)
            with self._lock:
                if wid not in self._watches:
                    return           # cancelled between iterations
                self._watches[wid] = (stop, conn)
            if stop.is_set():        # a cancel raced the registration
                conn.close()
                return
            try:
                req = {"create_request": {
                    "key": _b64(prefix),
                    "range_end": range_end_for_prefix(prefix)}}
                if next_rev:
                    req["create_request"]["start_revision"] = str(next_rev)
                conn.request("POST", self._api + "/watch", json.dumps(req),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                attempt = 0          # the stream is up
                for line in resp:     # one JSON object a line
                    if stop.is_set():
                        return
                    line = line.strip()
                    if not line:
                        continue
                    msg = json.loads(line)
                    result = msg.get("result", msg)
                    header_rev = int(result.get("header", {})
                                     .get("revision", 0))
                    if header_rev:
                        next_rev = header_rev + 1
                    if result.get("canceled") \
                            or int(result.get("compact_revision", 0)):
                        # Compaction ate the resume point: resync by the
                        # state diff, then reconnect.
                        self._resync(prefix, known, callback)
                        break
                    for ev in result.get("events") or []:
                        kv = ev.get("kv", {})
                        key = _ub64(kv.get("key", ""))
                        if ev.get("type") == "DELETE":
                            known.pop(key, None)
                            _safe_callback(callback,
                                           ("DELETE", key, None))
                        else:
                            value = _ub64(kv.get("value", ""))
                            known[key] = value
                            _safe_callback(callback,
                                           ("PUT", key, value))
            except Exception as e:  # noqa: BLE001 — reconnect from next_rev
                if not stop.is_set():
                    logger.debug("etcd watch %d reconnecting: %s", wid, e)
                    self._watch_retry.sleep(attempt, stop_event=stop)
                    attempt += 1
            finally:
                conn.close()

    def _resync(self, prefix: str, known: Dict[str, str],
                callback: WatchCallback) -> None:
        """Synthetic DELETEs for keys that vanished, PUTs for new or
        changed ones."""
        try:
            current = self.get_prefix(prefix)
        except Exception as e:  # noqa: BLE001 — the next reconnect retries
            logger.warning("etcd watch resync of %r failed: %s", prefix, e)
            return
        for key in list(known):
            if key not in current:
                known.pop(key)
                _safe_callback(callback, ("DELETE", key, None))
        for key, value in current.items():
            if known.get(key) != value:
                known[key] = value
                _safe_callback(callback, ("PUT", key, value))

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            entry = self._watches.pop(watch_id, None)
        if entry:
            stop, conn = entry
            stop.set()
            if conn is not None:
                try:
                    conn.sock and conn.sock.close()
                except Exception:  # noqa: BLE001 — a dead socket is
                    pass            # what a cancel wants

    def close(self) -> None:
        with self._lock:
            wids = list(self._watches)
        for wid in wids:
            self.cancel_watch(wid)
