"""HTTP client half of the worker's cluster plane: one JSON request to
the service or the coordination store.

A copy of the JAX package's ``service/httpd.py`` ``http_json`` and its
keep-alive pool (the worker's HTTP server stays the standard library's
``ThreadingHTTPServer``, ``runtime/worker.py``). Pooled connections are
dropped once idle longer than ``_MAX_IDLE_S``, well under a server's
keep-alive timeout, so a reused socket is never one the peer already
closed; a request that provably never reached the peer is retried once
on a fresh connection.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from http.client import HTTPConnection
from typing import Any, Dict, List, Tuple

_MAX_IDLE_S = 20.0
_MAX_IDLE_PER_ADDR = 8


class _NoDelayHTTPConnection(HTTPConnection):
    """TCP_NODELAY client connection: on a reused keep-alive socket the
    header and body writes are separate small segments, and with Nagle
    on the second waits out the peer's delayed ACK."""

    def connect(self) -> None:
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


_idle: Dict[str, List[Tuple[HTTPConnection, float]]] = {}
_idle_lock = threading.Lock()


def _get_conn(address: str, timeout: float) -> Tuple[HTTPConnection, bool]:
    """→ (connection, reused)."""
    now = time.monotonic()
    conn, stale = None, []
    with _idle_lock:
        conns = _idle.get(address)
        while conns:
            cand, last = conns.pop()
            if now - last <= _MAX_IDLE_S:
                conn = cand
                break
            stale.append(cand)
    for c in stale:
        c.close()
    if conn is None:
        return _NoDelayHTTPConnection(address, timeout=timeout), False
    conn.timeout = timeout
    if conn.sock is not None:
        conn.sock.settimeout(timeout)
    return conn, True


def _put_conn(address: str, conn: HTTPConnection) -> None:
    with _idle_lock:
        conns = _idle.setdefault(address, [])
        if len(conns) < _MAX_IDLE_PER_ADDR:
            conns.append((conn, time.monotonic()))
            return
    conn.close()


_SEND_ERRORS = (http.client.CannotSendRequest, ConnectionResetError,
                BrokenPipeError)


def http_json(method: str, address: str, path: str, obj: Any = None,
              timeout: float = 30.0) -> Tuple[int, Any]:
    """One JSON request to ``address`` ("host:port") over a pooled
    keep-alive connection. Returns (status, parsed-json-or-None)."""
    body = None if obj is None else json.dumps(obj).encode("utf-8")
    hdrs = {"Content-Type": "application/json"}
    while True:
        conn, reused = _get_conn(address, timeout)
        try:
            conn.request(method, path, body=body, headers=hdrs)
        except _SEND_ERRORS:
            conn.close()
            if reused:
                continue      # request never delivered — safe to retry
            raise
        except Exception:
            conn.close()
            raise
        try:
            resp = conn.getresponse()
            data = resp.read()
            parsed = json.loads(data.decode("utf-8")) if data else None
        except http.client.RemoteDisconnected:
            # No response at all on a reused socket: the peer closed it
            # (restart) and never saw the request.
            conn.close()
            if reused:
                continue
            raise
        except Exception:
            # The peer may have executed the request: no retry.
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            _put_conn(address, conn)
        return resp.status, parsed
