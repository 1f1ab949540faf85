"""Small shared helpers: short uuids, ordered fan-in pools, ports, json paths.

A copy of the JAX package's ``utils/misc.py``: the same behaviour and
names, importing only this package (and no device code).

Python equivalents of the reference's ``common/`` substrate: ``ShortUUID``
(xllm/uuid.h), the 128 single-thread output pools that preserve per-request
token order (scheduler.h:113-120), port availability checks (utils.cpp:43-66)
and dot-path JSON access (json_reader.h).
"""

from __future__ import annotations

import queue
import secrets
import socket
import threading


from typing import Any, Callable, Dict, List, Optional
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.threads import spawn

_ALPHABET = "23456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def short_uuid(length: int = 22) -> str:
    """URL-safe short random id (reference: common/xllm/uuid.{h,cpp}).

    One ``token_bytes`` call, not ``secrets.choice`` per character — the
    per-character form costs an urandom syscall each and profiled at
    ~4 ms per id on the request hot path (ids are identifiers, not key
    material; the tiny modulo bias is irrelevant)."""
    raw = secrets.token_bytes(length)
    n = len(_ALPHABET)
    return "".join(_ALPHABET[b % n] for b in raw)


def is_port_available(port: int, host: str = "127.0.0.1") -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
            return True
        except OSError:
            return False


def pick_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def json_path(d: Dict[str, Any], path: str, default: Any = None) -> Any:
    """Dot-path JSON access: ``json_path(cfg, "a.b.c")``
    (reference: common/json_reader.h)."""
    cur: Any = d
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return default
    return cur


class _SerialWorker:
    """A single-thread executor draining a FIFO queue."""

    def __init__(self, name: str) -> None:
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        # Supervised (utils/threads.py): the per-callback handler below
        # protects siblings from a bad callback; the spawn handler makes
        # a crash of the drain loop itself visible instead of silent.
        self._thread = spawn("misc.fanin", self._run, thread_name=name)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:
                # A bad callback must not kill the pool (its siblings'
                # token streams ride the same thread) — but the drop is
                # logged + counted (xllm_callback_errors_total), not
                # printed to an untailed stderr (xlint rule 16).
                threads.record_callback_error("misc.fanin", e)

    def stop(self) -> None:
        self._q.put(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)


class OrderedFanInPools:
    """N single-thread pools; each request is pinned to one pool so its token
    stream is delivered in order while different requests run concurrently.

    Reproduces the reference's 128-pool token fan-in design
    (scheduler/scheduler.h:113-120, scheduler.cpp:348-369).
    """

    def __init__(self, num_pools: int = 128) -> None:
        self._pools = [_SerialWorker(f"fanin-{i}") for i in range(num_pools)]
        self._lock = make_lock("misc.pool", 90)
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def pool_for(self, request_id: str) -> int:
        with self._lock:
            idx = self._assignment.get(request_id)
            if idx is None:
                idx = self._next % len(self._pools)
                self._next += 1
                self._assignment[request_id] = idx
            return idx

    def submit(self, request_id: str, fn: Callable[[], None]) -> None:
        self._pools[self.pool_for(request_id)].submit(fn)

    def release(self, request_id: str) -> None:
        with self._lock:
            self._assignment.pop(request_id, None)

    def drain(self) -> None:
        """Block until every queued callback has run (test helper)."""
        done = threading.Barrier(len(self._pools) + 1)
        for p in self._pools:
            p.submit(lambda: done.wait())
        done.wait()

    def stop(self) -> None:
        for p in self._pools:
            p.stop()
        for p in self._pools:
            p.join(timeout=5)


class AtomicCounter:
    def __init__(self, start: int = 0) -> None:
        self._v = start
        self._lock = make_lock("misc.counter", 91)

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._v += n
            return self._v

    @property
    def value(self) -> int:
        with self._lock:
            return self._v
