"""RequestTracer: per-request JSONL trace appender.

A copy of the JAX package's ``service/tracer.py``: the same behaviour
and names, importing only this package (and no device code).

Rebuild of ``http_service/request_tracer.{h,cpp}``: when enabled, every
inbound/outbound payload of a request is appended as
``{"timestamp", "service_request_id", "data"}`` lines under a mutex
(request_tracer.cpp:37-59), wired into request handling as a
``trace_callback``.
"""

from __future__ import annotations

import json
import os
import threading


import time
from typing import Any, Dict, Optional
from xllm_service_tpu_torch.utils.locks import make_lock


class RequestTracer:
    def __init__(self, path: str = "trace/trace.jsonl",
                 enable: bool = False) -> None:
        self.enable = enable
        self.path = path
        self._lock = make_lock("tracer", 90)
        self._f = None
        self._closed = False
        self._written = 0
        # Size cap (bytes) before rotation; 0 = unbounded, exactly the
        # pre-cap behavior. A capped tracer rotates ONCE to <path>.1
        # (replacing any previous rotation), so the worst case on disk
        # is 2x the cap instead of an unbounded stream of egress frames.
        try:
            self.max_bytes = int(os.environ.get(
                "XLLM_TRACE_MAX_BYTES", "0"))
        except ValueError:
            self.max_bytes = 0
        if enable:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _rotate_locked(self) -> None:
        """Caller holds the lock and the cap is exceeded: close, shift
        the full file to <path>.1, start fresh."""
        self._f.close()
        self._f = None
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            # Rotation impossible (permissions, cross-mount .1 path):
            # degrade to the pre-cap unbounded behavior instead of
            # paying a reopen + failed rename PER LINE under the global
            # lock — the exact churn the keep-the-file-open design
            # exists to avoid.
            self.max_bytes = 0
        self._written = 0

    def trace(self, service_request_id: str, data: Any) -> None:
        if not self.enable:
            return
        line = json.dumps({
            "timestamp": time.time(),
            "service_request_id": service_request_id,
            "data": data,
        })
        # One open for the process lifetime: per-frame egress tracing
        # calls this once per streamed token, and an open/close cycle
        # under the global lock would throttle every concurrent stream.
        with self._lock:
            if self._closed:
                # A late trace() racing close() (an SSE stream draining
                # while the service shuts down) must not silently
                # reopen the file the caller just finalized.
                return
            if self._f is None:
                self._f = open(self.path, "a", encoding="utf-8")
                try:
                    self._written = os.fstat(self._f.fileno()).st_size
                except OSError:
                    self._written = 0
            self._f.write(line + "\n")
            self._f.flush()
            # Byte length, not character count: the cap is seeded from
            # os.fstat and documented as XLLM_TRACE_MAX_BYTES — counting
            # characters lets multibyte traces overrun the 2x-cap disk
            # bound.
            self._written += len(line.encode("utf-8")) + 1
            if self.max_bytes > 0 and self._written >= self.max_bytes:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None

    def reopen(self) -> None:
        """Explicitly arm a closed tracer again (tests / hot reconfig);
        the implicit reopen-on-late-trace race is what close() seals."""
        with self._lock:
            self._closed = False

    def callback_for(self, service_request_id: str):
        """Bind a per-request trace callback (reference
        http_service/service.cpp:258-264)."""
        if not self.enable:
            return None

        def cb(stage: str, data: Dict[str, Any]) -> None:
            self.trace(service_request_id, {"stage": stage, **data})
        return cb

    def egress_for(self, service_request_id: str):
        """Per-WRITE egress tracer for streamed responses — the response
        half of ``--enable_request_trace`` (the reference captures every
        outbound payload via the CallData trace callback,
        common/call_data.h:151-162). Each write to the client becomes one
        trace line, so response corruption (a malformed frame, a
        truncated stream, an out-of-order delta) is debuggable from the
        trace alone. In the relay topology a write is a transport chunk
        (may carry several SSE frames, or split one); in the RPC fan-in
        topology it is exactly one assembler frame. ``backslashreplace``
        keeps the line lossless when a multibyte character straddles a
        chunk boundary (``replace`` would forge corruption that never
        reached the client). Returns None when disabled so hot paths
        skip even the closure call."""
        if not self.enable:
            return None
        seq = [0]

        def cb(frame: bytes) -> None:
            self.trace(service_request_id, {
                "stage": "egress",
                "seq": seq[0],
                "frame": frame.decode("utf-8", errors="backslashreplace"),
            })
            seq[0] += 1
        return cb
