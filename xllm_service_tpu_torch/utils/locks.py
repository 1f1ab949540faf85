"""Named, ranked locks: the lock-order check and its contention sampler.

A copy of the JAX package's ``utils/locks.py``. Every lock of this
package's worker carries a NAME and a RANK from the table below. With
``XLLM_LOCK_CHECK`` on (the test suite sets it in ``tests/conftest.py``)
a thread may only acquire a lock whose rank is STRICTLY GREATER than
every lock it already holds; equal ranks mean "never held together".
An inversion raises ``LockOrderViolation`` at once, deterministically,
instead of deadlocking once in a thousand runs.

Rank table (acquire order low -> high). A name the JAX package also has
keeps its rank there; the rest are this package's own, each with why:

     5  worker.hb           serializes heartbeat build + send
     8  worker.reg          registration revoke -> grant -> put (store
                            calls run under it: store locks rank above)
     9  worker.loop         this package only: held by the engine loop
                            across one runtime's step, its outputs'
                            dispatch (worker.live) and its records, and
                            by /sleep and /wakeup before worker.engine
    10  worker.live         request registries
    20  worker.engine       engine step / submit, the vision tower's run
    22  kv_cache.tier       host spill tier (never calls out; taken under
                            worker.engine)
    25  worker.kvfetch      staged block-fetch wire tickets (dict only;
                            releases happen outside)
    27  worker.kvchunk      this package only: the decode side's staged
                            /kv/chunk parts (dict only, never calls out)
    60  coordination_net,   store transports (watch books only)
        etcd.watches
    74  store_guard         store-health state machine (never held
                            across an inner store call, a heal callback
                            or an event emit)
    75  obs.failpoints      arming state (trips are counted outside)
    80  obs.events          the worker's event ring (never calls out)
    85  obs.steptrace       step flight-recorder ring (never calls out)
    87  worker.embedcache   embedding cache and the beat's digest deltas
                            (the tower runs outside it)
    89  worker.addr         master address + config-stale pair
    90  worker.vision       the tower's one-time build
    90  worker.flip         this package only: the count of sleeps and
                            wakes waiting for worker.loop (taken under
                            it; a counter, never calls out)
    92  httpd.connpool      keep-alive pool dict only
    93  obs.registry        metrics families (never calls out)
    94  obs.spans           span ring (never calls out)
    94  threads.book        supervised-thread crash / callback books
    95  hashing.native      the native hashing library's load
    97  kernels.build       this package only: the one-time nvcc build of
                            the CUDA kernels (like etcd_native.build)

Left raw on purpose: ``InMemoryStore``'s re-entrant lock (as the JAX
store's, its own single-class discipline) and ``runtime/kv_wire.py``'s
staging lock, which a ``threading.Condition`` waits on (a checked lock
cannot back a Condition: its ownership probe re-acquires the lock).

Unset, ``make_lock`` returns a plain ``threading.Lock`` and costs
nothing.

Contention telemetry: with ``XLLM_LOCK_PROFILE_SAMPLE=N`` (N >= 1) every
lock made here samples one acquisition in N into a per-name book
(``contention_snapshot()``): a non-blocking try-acquire tells a
contended acquisition, whose blocking wait is then timed.
``obs/profiler.flush_metrics`` mirrors the book as
``xllm_lock_wait_ms{lock,rank}`` / ``xllm_lock_contended_total{lock}``;
this module imports nothing of ``obs``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Tuple, Union


def enabled() -> bool:
    return os.environ.get("XLLM_LOCK_CHECK", "").strip() in (
        "1", "true", "yes")


def _profile_sample() -> int:
    """1-in-N acquisition sampling rate; 0 disables. Read once at
    import."""
    raw = os.environ.get("XLLM_LOCK_PROFILE_SAMPLE", "").strip()
    try:
        n = int(raw) if raw else 0
    except ValueError:
        return 0
    return n if n >= 1 else 0


PROFILE_SAMPLE = _profile_sample()

# Wait-time bucket edges (ms) of the contention book: a lock hold is
# typically tens of microseconds.
LOCK_WAIT_BUCKETS_MS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0,
    10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0)


class _LockBook:
    __slots__ = ("rank", "sampled", "contended", "wait_counts",
                 "wait_sum_ms")

    def __init__(self, rank: int) -> None:
        self.rank = rank
        self.sampled = 0
        self.contended = 0
        self.wait_counts = [0] * len(LOCK_WAIT_BUCKETS_MS)
        self.wait_sum_ms = 0.0


# Keyed by lock name (instances sharing a name aggregate). Guarded by a
# raw lock: innermost, dict updates only, invisible to the rank check.
_books: Dict[str, _LockBook] = {}
_books_lock = threading.Lock()


def _record_wait(name: str, rank: int, wait_ms: float,
                 contended: bool) -> None:
    with _books_lock:
        b = _books.get(name)
        if b is None:
            b = _books[name] = _LockBook(rank)
        b.sampled += 1
        if contended:
            b.contended += 1
        for i, edge in enumerate(LOCK_WAIT_BUCKETS_MS):
            if wait_ms <= edge:
                b.wait_counts[i] += 1
                break
        b.wait_sum_ms += wait_ms


def contention_snapshot() -> Dict[str, Dict[str, object]]:
    """Copy of the contention book: ``{name: {rank, sampled, contended,
    wait_counts, wait_sum_ms}}``, counts of SAMPLED acquisitions;
    ``wait_counts`` align with ``LOCK_WAIT_BUCKETS_MS``."""
    with _books_lock:
        return {
            name: {
                "rank": b.rank,
                "sampled": b.sampled,
                "contended": b.contended,
                "wait_counts": list(b.wait_counts),
                "wait_sum_ms": b.wait_sum_ms,
            }
            for name, b in _books.items()
        }


class LockOrderViolation(AssertionError):
    pass


# Raised violations also count here: a broad ``except Exception`` on a
# worker path may swallow the raise, the count stays.
_violations: List[str] = []


def violation_count() -> int:
    return len(_violations)


def violations() -> List[str]:
    return list(_violations)


_tls = threading.local()


def _held() -> List[Tuple[str, int]]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


class CheckedLock:
    """Lock wrapper enforcing the rank order (module docstring).
    ``check=False`` keeps the name, rank and contention sampling and
    skips the order check (only ``XLLM_LOCK_PROFILE_SAMPLE`` set)."""

    def __init__(self, name: str, rank: int, reentrant: bool = False,
                 check: bool = True):
        self.name = name
        self.rank = rank
        self._reentrant = reentrant
        self._check = check
        self._lock: Union[threading.Lock, threading.RLock] = (
            threading.RLock() if reentrant else threading.Lock())
        self._owner = -1
        self._depth = 0
        self._sample_ctr = 0    # racy on purpose: skews sampling only

    def _acquire_profiled(self) -> bool:
        if self._lock.acquire(False):
            _record_wait(self.name, self.rank, 0.0, False)
            return True
        t0 = time.perf_counter()
        ok = self._lock.acquire()
        _record_wait(self.name, self.rank,
                     (time.perf_counter() - t0) * 1000.0, True)
        return ok

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            self._lock.acquire()
            self._depth += 1
            return True
        if self._check:
            held = _held()
            if held and held[-1][1] >= self.rank:
                msg = (f"acquiring {self.name!r} (rank {self.rank}) "
                       f"while holding {held}: lock order must be "
                       f"strictly increasing (utils/locks.py rank table)")
                _violations.append(msg)
                raise LockOrderViolation(msg)
        if PROFILE_SAMPLE > 0 and blocking and timeout < 0:
            self._sample_ctr += 1
            if self._sample_ctr >= PROFILE_SAMPLE:
                self._sample_ctr = 0
                ok = self._acquire_profiled()
            else:
                ok = self._lock.acquire()
        else:
            ok = (self._lock.acquire(blocking) if timeout < 0
                  else self._lock.acquire(blocking, timeout))
        if ok:
            if self._check:
                _held().append((self.name, self.rank))
            if self._reentrant:
                self._owner = me
                self._depth = 1
        return ok

    def release(self) -> None:
        if self._reentrant:
            self._depth -= 1
            if self._depth > 0:
                self._lock.release()
                return
            self._owner = -1
        if self._check:
            held = _held()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] == self.name:
                    del held[i]
                    break
        self._lock.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") \
            else False


def make_lock(name: str, rank: int):
    """A plain Lock unset; a rank-checked one under XLLM_LOCK_CHECK; a
    sampling-only CheckedLock when only XLLM_LOCK_PROFILE_SAMPLE is
    set."""
    if enabled():
        return CheckedLock(name, rank)
    if PROFILE_SAMPLE > 0:
        return CheckedLock(name, rank, check=False)
    return threading.Lock()


def make_rlock(name: str, rank: int):
    if enabled():
        return CheckedLock(name, rank, reentrant=True)
    if PROFILE_SAMPLE > 0:
        return CheckedLock(name, rank, reentrant=True, check=False)
    return threading.RLock()
