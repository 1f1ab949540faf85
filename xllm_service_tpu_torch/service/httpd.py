"""HTTP client half of the worker's cluster plane: one JSON (or raw
bytes) request to the service, the coordination store or a peer worker,
and the progressive readers of the PD handoff's streamed answers.

A copy of the JAX package's ``service/httpd.py`` ``http_json`` and its
keep-alive pool with its reuse counters (``flush_conn_pool_metrics``,
``xllm_http_conn_pool_*{plane}``), ``http_stream_status`` / ``http_stream`` and
``iter_sse_events`` (the worker's HTTP server stays the standard
library's ``ThreadingHTTPServer``, ``runtime/worker.py``). Pooled
connections are dropped once idle longer than ``_MAX_IDLE_S``, well
under a server's keep-alive timeout, so a reused socket is never one the
peer already closed; a request that provably never reached the peer is
retried once on a fresh connection.
"""

from __future__ import annotations

import http.client
import json
import socket
import time
from http.client import HTTPConnection
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from xllm_service_tpu_torch.utils.locks import make_lock

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
_idle_lock = make_lock("httpd.connpool", 92)
# Reuse counters, under _idle_lock: a get served from the pool or by a
# fresh connection, a put dropped past the per-address cap, an idle
# connection aged out.
_stats = {"hits_total": 0, "misses_total": 0, "overflow_total": 0,
          "expired_total": 0}


def conn_pool_stats() -> Dict[str, int]:
    """The keep-alive pool's counters and its idle connections."""
    with _idle_lock:
        return dict(_stats, idle=sum(len(v) for v in _idle.values()))


def flush_conn_pool_metrics(registry, plane: str) -> None:
    """Mirror the pool's counters into ``registry`` under the exporting
    plane's label, as the JAX package's exporter names them."""
    for k, v in conn_pool_stats().items():
        name = f"xllm_http_conn_pool_{k}"
        if k.endswith("_total"):
            registry.counter(name, labelnames=("plane",)).set_total(
                v, plane=plane)
        else:
            registry.gauge(name, labelnames=("plane",)).set(
                v, plane=plane)


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
        _stats["expired_total"] += len(stale)
        _stats["hits_total" if conn is not None else "misses_total"] += 1
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
        _stats["overflow_total"] += 1
    conn.close()


_SEND_ERRORS = (http.client.CannotSendRequest, ConnectionResetError,
                BrokenPipeError)


def _body(obj: Any, raw: Optional[bytes]
          ) -> Tuple[Optional[bytes], Dict[str, str]]:
    """A request's body and headers: ``raw`` as an octet stream, else
    ``obj`` as JSON."""
    if raw is not None:
        return raw, {"Content-Type": "application/octet-stream"}
    body = None if obj is None else json.dumps(obj).encode("utf-8")
    return body, {"Content-Type": "application/json"}


def http_json(method: str, address: str, path: str, obj: Any = None,
              timeout: float = 30.0,
              raw: Optional[bytes] = None) -> Tuple[int, Any]:
    """One request to ``address`` ("host:port") over a pooled keep-alive
    connection, its body ``obj`` as JSON or ``raw`` bytes. Returns
    (status, parsed-json-or-None)."""
    body, hdrs = _body(obj, raw)
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


def http_stream_status(method: str, address: str, path: str,
                       obj: Any = None, timeout: float = 600.0,
                       raw: Optional[bytes] = None
                       ) -> Tuple[int, "_StreamBody"]:
    """Connect eagerly and return (status, body iterator) on a fresh
    connection, so that a caller can act on the status before it reads
    the body. The caller exhausts or closes the iterator."""
    conn = _NoDelayHTTPConnection(address, timeout=timeout)
    try:
        body, hdrs = _body(obj, raw)
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
    except Exception:
        conn.close()
        raise
    return resp.status, _StreamBody(resp, conn)


class _StreamBody:
    """A response body that yields its chunks as they arrive and can be
    closed without having been iterated (closing a generator that never
    started cannot run its ``finally``)."""

    def __init__(self, resp, conn) -> None:
        self._resp = resp
        self._conn = conn

    def __iter__(self) -> Iterator[bytes]:
        try:
            while True:
                chunk = self._resp.read1(65536)
                if not chunk:
                    return
                yield chunk
        finally:
            self._conn.close()

    def close(self) -> None:
        self._conn.close()


def http_stream(method: str, address: str, path: str, obj: Any = None,
                timeout: float = 600.0,
                raw: Optional[bytes] = None) -> Iterator[bytes]:
    """The response body's chunks as they arrive (``raw`` sends an
    octet-stream body instead of JSON: the KV handoff's payloads)."""
    _, body = http_stream_status(method, address, path, obj=obj,
                                 timeout=timeout, raw=raw)
    yield from body


def iter_sse_events(chunks: Iterable[bytes]) -> Iterator[str]:
    """The ``data:`` payloads of an SSE byte stream, reassembled across
    chunk boundaries."""
    buf = b""
    for chunk in chunks:
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            for line in event.decode("utf-8").splitlines():
                if line.startswith("data: "):
                    yield line[len("data: "):]
                elif line.startswith("data:"):
                    yield line[len("data:"):]
