"""HTTP for the worker: the routed server with its admission control,
and the client half of the cluster plane.

A copy of the JAX package's ``service/httpd.py``.

The server half: ``Request`` and ``Response`` (``json``, ``error``,
``sse``), a ``Router`` of exact and prefix routes per method (a route's
exception becomes a 500), and ``Admission``, the server-wide cap on
concurrent entry requests (``max_concurrency``: an int, None or a
zero-argument callable read live). Past the cap a new request is
answered ``503`` with ``Retry-After: 1``, ``Connection: close`` and the
``overloaded_error`` body before its body is read; the routes that
start with one of ``admission_exempt`` (``_ADMISSION_EXEMPT`` and the
worker's control and continuation verbs) are never shed. A slot is
held for the whole handler, streaming included. ``HttpServer`` is the
factory: the native epoll front door (``service/native_httpd.py`` over
``csrc/xllm_httpd.cpp``) when its library builds, else
``PyHttpServer``, the standard library's threaded server
(``XLLM_NATIVE_HTTPD=0`` forces it). Both speak HTTP/1.1 keep-alive
with Nagle off and a 60 s idle timeout, and send a stream as chunked
transfer, one write a frame; ``kind`` says which one runs.

The client half: ``http_json`` and its keep-alive pool with its reuse
counters (``flush_conn_pool_metrics``, ``xllm_http_conn_pool_*{plane}``),
``http_stream_status`` / ``http_stream`` and ``iter_sse_events``.
Pooled connections are dropped once idle longer than ``_MAX_IDLE_S``,
well under a server's keep-alive timeout, so a reused socket is never
one the peer already closed; a request that provably never reached the
peer is retried once on a fresh connection.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)
from urllib.parse import parse_qs, urlparse

from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.threads import spawn

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class Request:
    def __init__(self, method: str, path: str, query: Dict[str, List[str]],
                 headers: Dict[str, str], body: bytes) -> None:
        self.method = method
        self.path = path
        self.query = query
        # Header names are case-insensitive: kept lowercased.
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body

    def param(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self) -> Any:
        if not self.body:
            return {}
        return json.loads(self.body.decode("utf-8"))


class Response:
    """``body`` for a buffered answer; ``stream`` (an iterable of byte
    chunks) for a progressive one, each chunk sent as it is produced.
    ``on_close`` runs exactly once when the server is done with the
    response, also when a stream was never started (closing a generator
    that never started does not run its ``finally``)."""

    def __init__(self, status: int = 200, body: Optional[bytes] = None,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None,
                 stream: Optional[Iterable[bytes]] = None,
                 on_close: Optional[Callable[[], None]] = None) -> None:
        self.status = status
        self.body = body if body is not None else b""
        self.content_type = content_type
        self.headers = headers or {}
        self.stream = stream
        self.on_close = on_close

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status, body=json.dumps(obj).encode("utf-8"))

    @classmethod
    def error(cls, status: int, message: str,
              err_type: str = "invalid_request_error") -> "Response":
        """The OpenAI error envelope."""
        return cls.json(
            {"error": {"message": message, "type": err_type, "code": status}},
            status=status)

    @classmethod
    def sse(cls, chunks: Iterable[bytes]) -> "Response":
        return cls(content_type="text/event-stream",
                   headers={"Cache-Control": "no-cache"}, stream=chunks)


Handler = Callable[[Request], Response]


def overloaded_response() -> Response:
    """The shed request's answer, on both servers."""
    resp = Response.error(503, "server at max_concurrency",
                          "overloaded_error")
    resp.headers = {"Retry-After": "1", "Connection": "close"}
    return resp


class Admission:
    """The server-wide cap on concurrent requests. Past the limit a new
    request gets an immediate 503 with ``Retry-After`` instead of a
    thread pile-up: the refusal class the master re-dispatches, so an
    overloaded worker shifts load instead of failing requests.

    ``limit`` is an int, None (no cap) or a zero-argument callable that
    returns either, read at each admission (a live options object). A
    slot is held for the handler's whole life, streaming included."""

    def __init__(self, limit=None) -> None:
        self._limit = limit
        self._active = 0
        self._lock = threading.Lock()
        self.rejected_total = 0

    def _current_limit(self) -> Optional[int]:
        lim = self._limit() if callable(self._limit) else self._limit
        return None if not lim or lim <= 0 else lim

    @property
    def active(self) -> int:
        return self._active

    def try_enter(self) -> bool:
        with self._lock:
            lim = self._current_limit()
            if lim is not None and self._active >= lim:
                self.rejected_total += 1
                return False
            self._active += 1
            return True

    def probe(self) -> bool:
        """The admission check without claiming a slot (a refusal counts):
        the native front door sheds a large upload with it at header
        time, before the body is buffered; ``try_enter`` still decides at
        dispatch."""
        with self._lock:
            lim = self._current_limit()
            if lim is not None and self._active >= lim:
                self.rejected_total += 1
                return False
            return True

    def leave(self) -> None:
        with self._lock:
            self._active -= 1


# Admission bites at request entry (the client-facing /v1/* routes),
# never on the control plane (liveness, observability and the knobs
# must not starve under the congestion they diagnose) or on the
# continuation of an admitted request (/rpc/*: shedding it corrupts a
# stream in flight). A server adds its own control and continuation
# verbs (the worker: /sleep, /kv/import, /encode, ...).
_ADMISSION_EXEMPT = ("/metrics", "/hello", "/admin/", "/rpc/")


class Router:
    """Exact-path and prefix routes per method."""

    def __init__(self) -> None:
        self._exact: Dict[Tuple[str, str], Handler] = {}
        self._prefix: List[Tuple[str, str, Handler]] = []

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._exact[(method.upper(), path)] = handler

    def route_prefix(self, method: str, prefix: str,
                     handler: Handler) -> None:
        self._prefix.append((method.upper(), prefix, handler))

    def dispatch(self, req: Request) -> Response:
        h = self._exact.get((req.method, req.path))
        if h is None:
            for method, prefix, ph in self._prefix:
                if req.method == method and req.path.startswith(prefix):
                    h = ph
                    break
        if h is None:
            return Response.error(404, f"no route for {req.method} {req.path}")
        try:
            return h(req)
        except Exception as e:  # noqa: BLE001 — a route's error is a 500
            logger.exception("%s %s failed", req.method, req.path)
            return Response.error(500, f"internal error: {e}",
                                  "internal_error")


def close_response(resp: Response) -> None:
    """The server is done with ``resp``: close a stream (a started
    generator's ``finally``), then run ``on_close`` (which also covers
    a stream never started)."""
    if resp.stream is not None and hasattr(resp.stream, "close"):
        try:
            resp.stream.close()
        except Exception:  # noqa: BLE001 — the answer is already resolved
            logger.exception("closing a response stream failed")
    if resp.on_close is not None:
        try:
            resp.on_close()
        except Exception:  # noqa: BLE001 — a failing finish hook must not
            logger.exception("a response's on_close failed")  # kill the
            # server thread


class _RequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Keep-alive with Nagle on holds a small segment for the peer's
    # delayed ACK (~40 ms).
    disable_nagle_algorithm = True
    # An idle keep-alive connection frees its thread after this long;
    # clients drop pooled connections well before (_MAX_IDLE_S).
    timeout = 60.0
    router: Router                              # set by PyHttpServer
    admission: Optional[Admission] = None       # set by PyHttpServer
    admission_exempt: Tuple[str, ...] = _ADMISSION_EXEMPT

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _handle(self) -> None:
        parsed = urlparse(self.path)
        # Admission before the body read: a shed request pays no upload,
        # and its connection closes instead of draining.
        counted = (self.admission is not None
                   and not parsed.path.startswith(self.admission_exempt))
        if counted and not self.admission.try_enter():
            self.close_connection = True
            try:
                self._write(overloaded_response())
            except (BrokenPipeError, ConnectionResetError):
                pass
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            req = Request(self.command, parsed.path, parse_qs(parsed.query),
                          dict(self.headers.items()), body)
            resp = self.router.dispatch(req)
        except BaseException:
            if counted:
                self.admission.leave()
            raise
        try:
            self._write(resp)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True    # the client went away
        finally:
            if counted:
                self.admission.leave()
            close_response(resp)

    def _write(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        if resp.stream is None:
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            if resp.body:
                self.wfile.write(resp.body)
            self.wfile.flush()
            return
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for chunk in resp.stream:
                if not chunk:
                    continue
                # One write (one segment under NODELAY) a frame.
                self.wfile.write(b"".join(
                    (f"{len(chunk):X}\r\n".encode(), chunk, b"\r\n")))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            raise
        except Exception as e:  # noqa: BLE001 — the producer failed
            # Close without the terminating chunk: the client sees a
            # truncated answer, never a falsely complete one.
            logger.warning("%s: stream ended by %r", self.path, e)
            self.close_connection = True
            return
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    do_GET = _handle
    do_POST = _handle
    do_PUT = _handle
    do_DELETE = _handle


class PyHttpServer:
    """The standard library's threaded server (a thread per connection)
    bound to (host, port); port 0 picks a free one. ``max_concurrency``
    and ``admission_exempt`` as in ``Admission``."""

    kind = "python"

    def __init__(self, host: str, port: int, router: Router,
                 max_concurrency=None,
                 admission_exempt: Tuple[str, ...] = _ADMISSION_EXEMPT
                 ) -> None:
        self.router = router
        self.admission = (Admission(max_concurrency)
                          if max_concurrency is not None else None)
        handler = type("BoundHandler", (_RequestHandler,),
                       {"router": router, "admission": self.admission,
                        "admission_exempt": tuple(admission_exempt)})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._srv.daemon_threads = True
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "PyHttpServer":
        self._thread = spawn("httpd.serve", self._srv.serve_forever,
                             thread_name=f"httpd-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def HttpServer(host: str, port: int, router: Router,  # noqa: N802
               max_concurrency=None,
               admission_exempt: Tuple[str, ...] = _ADMISSION_EXEMPT):
    """The native epoll front door when its library builds, else
    ``PyHttpServer``; ``XLLM_NATIVE_HTTPD=0`` forces the latter. Both
    have ``start``, ``stop``, ``address``, ``port``, ``admission`` and
    ``kind`` (``"native"`` or ``"python"``)."""
    from xllm_service_tpu_torch.service.native_httpd import NativeHttpServer
    try:
        srv = NativeHttpServer(host, port, router,
                               max_concurrency=max_concurrency,
                               admission_exempt=admission_exempt)
    except OSError:
        # No library, or the bind failed: the Python server's bind
        # reports a real port conflict the same way.
        srv = PyHttpServer(host, port, router,
                           max_concurrency=max_concurrency,
                           admission_exempt=admission_exempt)
    logger.info("front door at %s: the %s server", srv.address, srv.kind)
    return srv


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

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
