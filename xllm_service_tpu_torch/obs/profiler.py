"""Hot-path profiler of the worker process: what its own Python costs.

The part of the JAX package's ``obs/profiler.py`` that a worker process
uses, under the same names:

- **Hot-path sections**: a CLOSED catalog (``SECTIONS``) of named timed
  regions, recorded by ``with profiler.section("span.write"):`` into
  per-thread books (no shared lock on the record path) and mirrored at
  scrape time into ``xllm_service_hotpath_ms{section}`` and
  ``xllm_service_hotpath_ops_total{section}``. Each thread also keeps a
  bounded tail of timed events, which ``recent_events`` merges for
  ``GET /admin/steptrace``'s ``sections``. The worker's sites are
  ``span.write`` (``obs/spans.py``), ``event.emit`` (``obs/events.py``)
  and ``sse.assemble`` (``service/response_handler.py``).
- **Lock contention**: ``utils/locks.py`` samples 1-in-N acquisitions
  (``XLLM_LOCK_PROFILE_SAMPLE``); ``flush_metrics`` mirrors the book as
  ``xllm_lock_wait_ms{lock,rank}`` / ``xllm_lock_contended_total{lock}``.
- **CPU per thread root**: supervised threads register their native tid
  under their root (``utils/threads.py``); scrape-time reads of
  ``/proc/self/task/<tid>/stat`` become
  ``xllm_thread_cpu_seconds_total{root}``.
- **Self-gauges**: RSS, process CPU% between scrapes, live threads, and
  GC pauses through ``gc.callbacks`` (``xllm_gc_pause_ms``,
  ``xllm_gc_collections_total{generation}``).

``XLLM_HOTPATH_PROFILE`` (default on) gates the section timers and
``XLLM_STEPTRACE`` (default on) the event tails; both are read at
import. Off, ``section()`` returns one shared no-op context manager.

State is process-global: books only grow (a dead thread's totals stay),
so the mirrored counters are monotonic.
"""

from __future__ import annotations

import collections
import gc
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.utils import locks as _locks

# The closed section catalog, the JAX package's names: add a name here,
# with what it spans, before any site uses it.
SECTIONS: Tuple[str, ...] = (
    "schedule",       # Scheduler.schedule(): policy walk + audit + plan
    "relay.frame",    # per-SSE-frame ledger work in the master's relay
    "span.write",     # SpanStore.record(): one stage write
    "event.emit",     # EventLog.emit(): one cluster event
    "store.call",     # one coordination-store RPC from the master loop
    "sse.assemble",   # building one outbound SSE frame from a delta
    "tokenize",       # chat-template apply + tokenizer encode
)

_SECTION_SET = frozenset(SECTIONS)

# Section bucket edges (ms): hot-path units of work take 10 us - 10 ms.
HOTPATH_BUCKETS_MS: Tuple[float, ...] = (
    0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0,
    10.0, 20.0, 50.0, 100.0, 500.0, 2000.0)

GC_PAUSE_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0,
    200.0, 500.0, 1000.0)


def _flag(name: str) -> bool:
    return os.environ.get(name, "1").strip() not in ("0", "false", "no")


ENABLED = _flag("XLLM_HOTPATH_PROFILE")
# The timed-event tail rides the step-trace flag too.
EVENTS_ENABLED = ENABLED and _flag("XLLM_STEPTRACE")

# Newest timed events kept per thread.
EVENT_TAIL = 256

try:
    _CLK_TCK = float(os.sysconf("SC_CLK_TCK"))
except (AttributeError, ValueError, OSError):
    _CLK_TCK = 100.0

try:
    _PAGE_SIZE = float(os.sysconf("SC_PAGE_SIZE"))
except (AttributeError, ValueError, OSError):
    _PAGE_SIZE = 4096.0


# -- section books: one dict per thread, listed once globally ---------------

class _Sect:
    __slots__ = ("counts", "sum_ms", "ops")

    def __init__(self) -> None:
        self.counts = [0] * len(HOTPATH_BUCKETS_MS)
        self.sum_ms = 0.0
        self.ops = 0


_tls = threading.local()
_all_books: List[Dict[str, _Sect]] = []
# (thread name, bounded deque of (section, t_wall_end, dur_ms)).
_all_event_tails: List[Tuple[str, Any]] = []
# Raw lock: guards the two lists only, never calls out, invisible to the
# rank check (this module sits above utils/locks.py).
_books_lock = threading.Lock()


def _thread_book() -> Dict[str, _Sect]:
    book = getattr(_tls, "book", None)
    if book is None:
        book = _tls.book = {}
        with _books_lock:
            _all_books.append(book)
    return book


def _thread_events():
    tail = getattr(_tls, "events", None)
    if tail is None:
        tail = _tls.events = collections.deque(maxlen=EVENT_TAIL)
        with _books_lock:
            _all_event_tails.append(
                (threading.current_thread().name, tail))
    return tail


class _NullSection:
    __slots__ = ()

    def __enter__(self) -> "_NullSection":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL = _NullSection()


class _Timer:
    __slots__ = ("name", "t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = 0.0

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dt_ms = (time.perf_counter() - self.t0) * 1000.0
        book = _thread_book()
        s = book.get(self.name)
        if s is None:
            s = book[self.name] = _Sect()
        for i, edge in enumerate(HOTPATH_BUCKETS_MS):
            if dt_ms <= edge:
                s.counts[i] += 1
                break
        s.sum_ms += dt_ms
        s.ops += 1
        if EVENTS_ENABLED:
            _thread_events().append((self.name, time.time(), dt_ms))
        return False


def section(name: str):
    """Context manager timing one hot-path section; ``name`` must be in
    ``SECTIONS``."""
    if name not in _SECTION_SET:
        raise ValueError(
            f"unknown hot-path section {name!r}: add it to "
            f"profiler.SECTIONS first (closed catalog)")
    if not ENABLED:
        return _NULL
    return _Timer(name)


def section_snapshot() -> Dict[str, Dict[str, Any]]:
    """Per-section totals over every thread's book: ``{name: {ops,
    sum_ms, counts}}`` (counts align with HOTPATH_BUCKETS_MS; samples
    past the last edge count in ops only)."""
    with _books_lock:
        books = list(_all_books)
    merged: Dict[str, Dict[str, Any]] = {}
    for book in books:
        for name, s in list(book.items()):
            m = merged.get(name)
            if m is None:
                m = merged[name] = {
                    "ops": 0, "sum_ms": 0.0,
                    "counts": [0] * len(HOTPATH_BUCKETS_MS)}
            m["ops"] += s.ops
            m["sum_ms"] += s.sum_ms
            for i, c in enumerate(s.counts):
                m["counts"][i] += c
    return merged


def thread_books() -> int:
    """The section books kept: one per thread that ever recorded."""
    with _books_lock:
        return len(_all_books)


def reset_sections() -> None:
    """Test helper: forget every thread's book and tail."""
    with _books_lock:
        _all_books.clear()
        _all_event_tails.clear()
    _tls.book = None
    _tls.events = None


def recent_events(window_s: float = 0.0,
                  limit: int = 2048) -> List[Dict[str, Any]]:
    """Every thread's timed-event tail merged, oldest first: ``[{name,
    t_wall, dur_ms, thread}]``; ``window_s`` keeps those within that
    many seconds of the newest."""
    with _books_lock:
        tails = [(tname, list(tail))
                 for tname, tail in _all_event_tails]
    out: List[Dict[str, Any]] = []
    for tname, tail in tails:
        for name, t_wall, dur_ms in tail:
            out.append({"name": name, "t_wall": t_wall,
                        "dur_ms": dur_ms, "thread": tname})
    out.sort(key=lambda e: (e["t_wall"], e["thread"], e["name"]))
    if window_s > 0 and out:
        horizon = out[-1]["t_wall"] - window_s
        out = [e for e in out if e["t_wall"] >= horizon]
    return out[-limit:]


# -- CPU per thread root (/proc/self/task/<tid>/stat) ------------------------

_roots_lock = threading.Lock()
_root_tids: Dict[str, set] = {}       # root -> live native tids
_tid_cpu_last: Dict[int, float] = {}  # tid -> last observed cpu seconds
_root_retired: Dict[str, float] = {}  # cpu seconds of exited threads


def register_thread_root(root: str) -> None:
    """Bind the calling thread's native tid to ``root`` (the supervised
    thread wrapper calls this at start)."""
    try:
        tid = threading.get_native_id()
    except Exception:  # noqa: BLE001 — no native tids: the root reports
        return         # no CPU series, and still starts
    with _roots_lock:
        _root_tids.setdefault(root, set()).add(tid)


def _cpu_s_of(path: str) -> Optional[float]:
    """utime + stime of a ``stat`` file, in seconds."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    # comm may hold spaces or parentheses: fields resume after the last ')'.
    rest = data.rsplit(b")", 1)[-1].split()
    try:
        return (int(rest[11]) + int(rest[12])) / _CLK_TCK
    except (IndexError, ValueError):
        return None


def thread_cpu_snapshot() -> Dict[str, float]:
    """Cumulative CPU seconds per root: live threads read from /proc,
    exited ones keep their last reading (the series stays monotonic)."""
    with _roots_lock:
        out: Dict[str, float] = {}
        for root, tids in _root_tids.items():
            live = 0.0
            for tid in list(tids):
                cur = _cpu_s_of(f"/proc/self/task/{tid}/stat")
                if cur is None:
                    _root_retired[root] = (
                        _root_retired.get(root, 0.0)
                        + _tid_cpu_last.pop(tid, 0.0))
                    tids.discard(tid)
                    continue
                _tid_cpu_last[tid] = cur
                live += cur
            out[root] = _root_retired.get(root, 0.0) + live
        for root, retired in _root_retired.items():
            out.setdefault(root, retired)
    return out


# -- process self stats and the GC pause hook --------------------------------

def process_rss_bytes() -> Optional[float]:
    try:
        with open("/proc/self/statm", "rb") as f:
            fields = f.read().split()
        return float(int(fields[1])) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return None


_cpu_lock = threading.Lock()
_cpu_last: Optional[Tuple[float, float]] = None  # (wall_s, cpu_s)


def process_cpu_percent() -> Optional[float]:
    """CPU% of this process since the previous call; None on the first
    call or off Linux."""
    global _cpu_last
    cpu = _cpu_s_of("/proc/self/stat")
    if cpu is None:
        return None
    now = time.monotonic()
    with _cpu_lock:
        last = _cpu_last
        _cpu_last = (now, cpu)
    if last is None or now <= last[0]:
        return None
    return 100.0 * (cpu - last[1]) / (now - last[0])


_gc_lock = threading.Lock()
_gc_t0: Optional[float] = None
_gc_pause_counts = [0] * len(GC_PAUSE_BUCKETS_MS)
_gc_pause_sum_ms = 0.0
_gc_pause_total = 0
_gc_collections: Dict[int, int] = {}
_gc_hook_installed = False


def _gc_callback(phase: str, info: Dict[str, Any]) -> None:
    # CPython's collector stops the world and does not nest: one slot
    # holds the start time.
    global _gc_t0, _gc_pause_sum_ms, _gc_pause_total
    if phase == "start":
        _gc_t0 = time.perf_counter()
        return
    if phase != "stop" or _gc_t0 is None:
        return
    dt_ms = (time.perf_counter() - _gc_t0) * 1000.0
    _gc_t0 = None
    gen = int(info.get("generation", -1))
    with _gc_lock:
        for i, edge in enumerate(GC_PAUSE_BUCKETS_MS):
            if dt_ms <= edge:
                _gc_pause_counts[i] += 1
                break
        _gc_pause_sum_ms += dt_ms
        _gc_pause_total += 1
        _gc_collections[gen] = _gc_collections.get(gen, 0) + 1


def install_gc_hook() -> None:
    global _gc_hook_installed
    with _gc_lock:
        if _gc_hook_installed:
            return
        _gc_hook_installed = True
    gc.callbacks.append(_gc_callback)


def gc_snapshot() -> Dict[str, Any]:
    with _gc_lock:
        return {
            "pause_counts": list(_gc_pause_counts),
            "pause_sum_ms": _gc_pause_sum_ms,
            "pause_total": _gc_pause_total,
            "collections": dict(_gc_collections),
        }


if ENABLED:
    install_gc_hook()


# -- scrape-time flush into a registry ---------------------------------------

def flush_metrics(registry) -> None:
    """Refresh the profiler's families in ``registry`` from the books
    (``Counter.set_total`` / ``Histogram.set_counts``); the worker's
    ``/metrics`` calls it before rendering."""
    hot_h = registry.histogram(
        "xllm_service_hotpath_ms",
        "per-section hot-path time (profiler catalog)",
        labelnames=("section",), buckets=HOTPATH_BUCKETS_MS)
    hot_c = registry.counter(
        "xllm_service_hotpath_ops_total",
        "per-section hot-path operations", labelnames=("section",))
    for name, m in section_snapshot().items():
        hot_h.set_counts(m["counts"], m["sum_ms"], total=m["ops"],
                         section=name)
        hot_c.set_total(m["ops"], section=name)

    contention = _locks.contention_snapshot()
    if contention:
        wait_h = registry.histogram(
            "xllm_lock_wait_ms",
            "sampled lock acquisition wait time "
            "(XLLM_LOCK_PROFILE_SAMPLE)",
            labelnames=("lock", "rank"),
            buckets=_locks.LOCK_WAIT_BUCKETS_MS)
        cont_c = registry.counter(
            "xllm_lock_contended_total",
            "sampled acquisitions that had to block",
            labelnames=("lock",))
        samp_c = registry.counter(
            "xllm_lock_sampled_total",
            "acquisitions sampled by the contention profiler",
            labelnames=("lock",))
        for name, b in contention.items():
            wait_h.set_counts(b["wait_counts"], b["wait_sum_ms"],
                              total=b["sampled"], lock=name,
                              rank=b["rank"])
            cont_c.set_total(b["contended"], lock=name)
            samp_c.set_total(b["sampled"], lock=name)

    cpu_c = registry.counter(
        "xllm_thread_cpu_seconds_total",
        "cumulative CPU seconds per supervised thread root",
        labelnames=("root",))
    for root, secs in thread_cpu_snapshot().items():
        cpu_c.set_total(secs, root=root)

    rss = process_rss_bytes()
    if rss is not None:
        registry.gauge("xllm_process_rss_bytes",
                       "resident set size").set(rss)
    pct = process_cpu_percent()
    if pct is not None:
        registry.gauge(
            "xllm_process_cpu_percent",
            "process CPU percent over the previous scrape window"
        ).set(pct)
    registry.gauge("xllm_process_threads",
                   "live thread count").set(threading.active_count())

    g = gc_snapshot()
    registry.histogram(
        "xllm_gc_pause_ms", "GC stop-the-world pause time",
        buckets=GC_PAUSE_BUCKETS_MS).set_counts(
            g["pause_counts"], g["pause_sum_ms"],
            total=g["pause_total"])
    gc_c = registry.counter("xllm_gc_collections_total",
                            "GC runs per generation",
                            labelnames=("generation",))
    for gen, n in g["collections"].items():
        gc_c.set_total(n, generation=gen)
