"""The native epoll front door: a ctypes bridge to ``csrc/xllm_httpd.cpp``.

A copy of the JAX package's ``service/native_httpd.py``. The C++ library
owns every socket in one epoll thread (accept, parse, keep-alive, the
60 s idle sweep, buffered and chunked writes); a complete request comes
up through a ctypes callback on its dispatch thread. Routing, admission
and the handlers stay in Python, with the semantics of
``httpd.PyHttpServer``:

- a request past ``max_concurrency`` gets the canned 503 at once, on the
  dispatch thread, with no handler thread;
- a body larger than 64 KiB is shed at header time, before it is
  buffered (``Admission.probe`` from the epoll thread);
- handlers run on a bounded ``ThreadPoolExecutor`` of reused threads
  (the cap at boot plus 32, at least 64); a request that finds every
  pool thread busy (held streams, a live raise of the cap) gets a
  thread of its own instead of queueing;
- a stream's chunks are buffered in C++, so a slow reader never blocks
  its producer; a producer that fails mid-stream aborts the connection
  without the terminating chunk.

The library is built with g++ at first use into the port's own
``build/torch_native/`` (never the JAX package's ``build/native/``: the
two packages' builds do not race). ``XLLM_NATIVE_HTTPD=0`` (or
``XLLM_DISABLE_NATIVE``) forces the Python server, as does a library
that does not build; ``httpd.HttpServer`` makes the choice.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs

from xllm_service_tpu_torch.service.httpd import (_ADMISSION_EXEMPT,
                                                  Admission, Request,
                                                  Response, close_response,
                                                  overloaded_response)
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.threads import spawn

logger = logging.getLogger(__name__)

# The headers blob is "key\0value\0...": it crosses as pointer + length
# (a c_char_p would stop at the first NUL).
_CB_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64)
# The early shed (epoll thread, header-complete, large bodies only):
# 1 = go on, 0 = answer the canned 503 without reading the body.
_ADMIT_TYPE = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p,
                               ctypes.c_char_p, ctypes.c_char_p)

_native_lock = make_lock("native_httpd.lib", 96)
_native_lib: Optional[ctypes.CDLL] = None
_native_tried = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _build() -> Optional[str]:
    root = _repo_root()
    src = os.path.join(root, "csrc", "xllm_httpd.cpp")
    if not os.path.exists(src):
        return None
    out_dir = os.path.join(root, "build", "torch_native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libxllm_httpd.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    cxx = os.environ.get("CXX", "g++")
    # A process-unique name renamed into place: a concurrent process never
    # loads a half-written library.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        # No compiler, or it failed: the Python server serves.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return so


def _bind(lib: ctypes.CDLL) -> None:
    lib.xllm_httpd_start.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                     _CB_TYPE, _ADMIT_TYPE, ctypes.c_void_p]
    lib.xllm_httpd_start.restype = ctypes.c_int64
    lib.xllm_httpd_port.argtypes = [ctypes.c_int64]
    lib.xllm_httpd_port.restype = ctypes.c_int32
    lib.xllm_httpd_run.argtypes = [ctypes.c_int64]
    lib.xllm_httpd_run.restype = ctypes.c_int32
    lib.xllm_httpd_set_shed_response.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.xllm_httpd_set_shed_response.restype = ctypes.c_int32
    lib.xllm_httpd_stop.argtypes = [ctypes.c_int64]
    lib.xllm_httpd_respond.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.xllm_httpd_respond.restype = ctypes.c_int32
    lib.xllm_httpd_stream_begin.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_int64]
    lib.xllm_httpd_stream_begin.restype = ctypes.c_int32
    lib.xllm_httpd_stream_chunk.argtypes = [
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int64]
    lib.xllm_httpd_stream_chunk.restype = ctypes.c_int32
    for name in ("xllm_httpd_stream_end", "xllm_httpd_stream_abort"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int64, ctypes.c_uint64]
        fn.restype = ctypes.c_int32


def _load() -> Optional[ctypes.CDLL]:
    global _native_lib, _native_tried
    with _native_lock:
        if _native_tried:
            return _native_lib
        _native_tried = True
        if os.environ.get("XLLM_NATIVE_HTTPD", "1") == "0" \
                or os.environ.get("XLLM_DISABLE_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            _bind(lib)
            _native_lib = lib
        except (OSError, AttributeError):
            # A library that does not load, or a stale one without a
            # newer export: the Python server serves.
            _native_lib = None
        return _native_lib


def _parse_headers_blob(blob: bytes) -> Dict[str, str]:
    # "key\0value\0...", keys already lowercased by the parser.
    out: Dict[str, str] = {}
    parts = blob.split(b"\0")
    for i in range(0, len(parts) - 1, 2):
        if parts[i]:
            out[parts[i].decode("latin-1")] = parts[i + 1].decode("latin-1")
    return out


def _headers_blob(headers: Dict[str, str]) -> bytes:
    out = bytearray()
    for k, v in headers.items():
        out += k.encode("latin-1") + b"\0" + str(v).encode("latin-1") + b"\0"
    return bytes(out)


def _canned(resp: Response) -> bytes:
    """``resp`` as raw HTTP/1.1 bytes (the C++ side's canned shed)."""
    head = [b"HTTP/1.1 503 Service Unavailable",
            b"Content-Type: " + resp.content_type.encode()]
    head += [f"{k}: {v}".encode() for k, v in resp.headers.items()]
    head.append(b"Content-Length: " + str(len(resp.body)).encode())
    return b"\r\n".join(head) + b"\r\n\r\n" + resp.body


class NativeHttpServer:
    """``httpd.PyHttpServer``'s surface over the epoll library. Raises
    ``OSError`` when the library is unavailable or the bind fails (the
    ``HttpServer`` factory then builds the Python server)."""

    kind = "native"

    def __init__(self, host: str, port: int, router,
                 max_concurrency=None,
                 admission_exempt: Tuple[str, ...] = _ADMISSION_EXEMPT
                 ) -> None:
        lib = _load()
        if lib is None:
            raise OSError("native httpd unavailable")
        self._lib = lib
        self.router = router
        self.admission = (Admission(max_concurrency)
                          if max_concurrency is not None else None)
        self._exempt = tuple(admission_exempt)
        self._stopped = False
        self._stop_lock = threading.Lock()
        # The callbacks must outlive the server: C++ calls through them
        # until xllm_httpd_stop has joined its threads.
        self._cb = _CB_TYPE(self._on_request)
        self._admit_cb = _ADMIT_TYPE(self._on_admit_early)
        self._h = lib.xllm_httpd_start(host.encode(), port, self._cb,
                                       self._admit_cb, None)
        if self._h <= 0:
            raise OSError(f"cannot bind {host}:{port}")
        self.host = host
        self.port = int(lib.xllm_httpd_port(self._h))
        shed = _canned(overloaded_response())
        lib.xllm_httpd_set_shed_response(self._h, shed, len(shed))
        # Reused handler threads, sized from the cap at boot; a request
        # that finds them all busy (held streams, a raised cap, long
        # polls) gets a thread of its own rather than a queue.
        limit = (self.admission._current_limit()
                 if self.admission is not None else None)
        self._pool_cap = max((limit or 0) + 32, 64)
        self._pool_busy = 0
        self._pool_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=self._pool_cap,
            thread_name_prefix=f"httpd-native-{self.port}")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "NativeHttpServer":
        # Bound since construction (connections wait in the backlog);
        # accepting starts here, once the owner is wired up.
        self._lib.xllm_httpd_run(self._h)
        return self

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        # ctypes drops the GIL around the call, so a callback in flight
        # can finish while the C++ side joins its threads.
        self._lib.xllm_httpd_stop(self._h)
        # Streams in flight see the dead connection (a nonzero chunk rc)
        # and unwind on their own; nothing queued dispatches after this.
        self._pool.shutdown(wait=False, cancel_futures=True)

    # --- the request path: dispatch thread -> handler threads -----------

    def _on_admit_early(self, _user, method, path) -> int:
        try:
            if self.admission is None \
                    or path.decode("latin-1").startswith(self._exempt):
                return 1
            return 1 if self.admission.probe() else 0
        except Exception:  # noqa: BLE001 — never wedge the epoll thread
            logger.exception("early admission check failed")
            return 1

    def _on_request(self, _user, rid, method, path, query, headers_ptr,
                    headers_len, body_ptr, body_len) -> None:
        try:
            path_s = path.decode("latin-1")
            req = Request(
                method.decode("latin-1"), path_s,
                parse_qs(query.decode("latin-1")) if query else {},
                _parse_headers_blob(
                    ctypes.string_at(headers_ptr, headers_len)
                    if headers_ptr and headers_len else b""),
                ctypes.string_at(body_ptr, body_len)
                if body_ptr and body_len else b"")
            counted = (self.admission is not None
                       and not path_s.startswith(self._exempt))
            if counted and not self.admission.try_enter():
                # Shed on this thread: overload costs no handler thread.
                resp = overloaded_response()
                self._respond(rid, resp.status, dict(
                    resp.headers, **{"Content-Type": resp.content_type}),
                    resp.body)
                return
            try:
                self._submit(rid, req, counted)
            except BaseException:
                if counted:
                    self.admission.leave()
                raise
        except Exception:  # noqa: BLE001 — a bad request must not end
            logger.exception("native httpd dispatch failed")  # dispatch
            self._respond(rid, 500, {"Content-Type": "application/json"},
                          b'{"error":{"message":"dispatch error"}}')

    def _submit(self, rid: int, req: Request, counted: bool) -> None:
        with self._pool_lock:
            overflow = self._pool_busy >= self._pool_cap
            if not overflow:
                self._pool_busy += 1
        if overflow:
            spawn("native_httpd.overflow", self._run,
                  args=(rid, req, counted),
                  thread_name=f"httpd-native-{self.port}-ovf").start()
            return
        try:
            self._pool.submit(self._run_pooled, rid, req, counted)
        except BaseException:
            # A submit racing stop(): _run_pooled's finally never runs.
            with self._pool_lock:
                self._pool_busy -= 1
            raise

    def _run_pooled(self, rid: int, req: Request, counted: bool) -> None:
        try:
            self._run(rid, req, counted)
        except Exception as e:  # noqa: BLE001 — the pool thread survives
            threads.record_callback_error("native_httpd.pool", e)
        finally:
            with self._pool_lock:
                self._pool_busy -= 1

    def _run(self, rid: int, req: Request, counted: bool) -> None:
        try:
            resp = self.router.dispatch(req)
        except BaseException:
            if counted:
                self.admission.leave()
            raise
        try:
            self._write(rid, req, resp)
        finally:
            if counted:
                self.admission.leave()
            close_response(resp)

    def _respond(self, rid: int, status: int, headers: Dict[str, str],
                 body: bytes) -> None:
        blob = _headers_blob(headers)
        self._lib.xllm_httpd_respond(self._h, rid, status, blob, len(blob),
                                     body, len(body))

    def _write(self, rid: int, req: Request, resp: Response) -> None:
        headers = {"Content-Type": resp.content_type}
        headers.update(resp.headers)
        if resp.stream is None:
            self._respond(rid, resp.status, headers, resp.body)
            return
        blob = _headers_blob(headers)
        self._lib.xllm_httpd_stream_begin(self._h, rid, resp.status, blob,
                                          len(blob))
        try:
            for chunk in resp.stream:
                if not chunk:
                    continue
                if self._lib.xllm_httpd_stream_chunk(
                        self._h, rid, chunk, len(chunk)) != 0:
                    break       # the client went away: stop producing
        except Exception as e:  # noqa: BLE001 — the producer failed
            # Close without the terminating chunk: the client sees a
            # truncated answer, never a falsely complete one.
            logger.warning("%s: stream ended by %r", req.path, e)
            self._lib.xllm_httpd_stream_abort(self._h, rid)
            return
        self._lib.xllm_httpd_stream_end(self._h, rid)
