"""Per-request span timelines: where did this request's latency go?

A copy of the JAX package's ``obs/spans.py``. One span per
``service_request_id``: an ordered list of stage events, each stamped
with the recording process's monotonic clock (intervals within a plane)
and wall clock (ordering across planes: the master's and the worker's
monotonic clocks share no epoch). The master records ``received`` ->
``admitted`` -> ``scheduled`` -> ``dispatched`` -> ``first_token`` ->
``finished`` (``SERVICE_STAGES``); the worker records ``received`` ->
``encoded`` -> ``scheduled`` -> ``first_token`` -> ``faulted`` /
``finished`` (``WORKER_STAGES``) under the same correlation id (the
``x-xllm-request-id`` header, ``REQUEST_ID_HEADER``) and ships finished
spans on the heartbeat (``drain_finished`` / ``requeue``), which the
master folds in under ``plane="worker"`` (``merge_remote``) and serves
at ``GET /admin/trace/<id>``.

Storage is a bounded ring: the oldest span is evicted past ``capacity``
(``XLLM_SPAN_RING``), counted by ``eviction_count``
(``xllm_span_evictions_total``), and remembered in a small tombstone
ring so that ``/admin/trace/<id>`` answers 410 for an evicted id
(``was_evicted``). Thread-safe; rank ``obs.spans`` in the
``utils/locks.py`` table.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.utils.locks import make_lock


def _deep_copy(v: Any) -> Any:
    """Deep-enough copy for span/event payloads (dict/list/tuple of
    JSON-ish values). The read side copies; writers stay cheap. Shallow
    ``dict(...)`` is NOT enough: ``merge_remote`` nests per-plane attr
    dicts (and remote events can carry dict/list attr values) that
    would stay shared with the live span and mutate mid-render."""
    if isinstance(v, dict):
        return {k: _deep_copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_deep_copy(x) for x in v]
    return v


# Canonical service-plane stage order (docs/OBSERVABILITY.md); extra
# stages (e.g. "redispatch"/"redispatched") may interleave — the first
# occurrence per (stage, plane) wins (see record()).
SERVICE_STAGES = ("received", "admitted", "scheduled", "dispatched",
                  "first_token", "finished")
# "encoded" appears only on multimodal requests: the prefill worker
# records it once the EPD encode stage resolved (attrs say whether a
# remote ENCODE instance, a cache hit, or local fallback produced the
# embeddings — docs/EPD.md). "faulted" appears only on requests the
# engine-step fault boundary blamed and evicted (docs/ROBUSTNESS.md
# device-plane fault contract).
WORKER_STAGES = ("received", "encoded", "scheduled", "first_token",
                 "faulted", "finished")

DEFAULT_CAPACITY = 2048

# The correlation header the service stamps on every forwarded request;
# the worker tags its span stages with this id (defined here, not in
# http_service, so the worker doesn't import the whole service plane
# for one constant).
REQUEST_ID_HEADER = "x-xllm-request-id"


class SpanStore:
    """Ring buffer of span timelines keyed by correlation id."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("obs.spans", 94)
        # rid → {"request_id", "attrs", "events": [event...]}; insertion
        # order is eviction order.
        self._spans: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        # drain_finished queue. Always ⊆ the ring's keys (eviction
        # discards the mark too) so a plane that never drains — the
        # service, which drains nothing; only workers export — stays
        # bounded by ``capacity`` instead of leaking one id per request.
        self._finished: set = set()
        # Eviction visibility: a counter (exported as
        # ``xllm_span_evictions_total`` on both planes) plus a small
        # tombstone ring of evicted rids, so ``GET /admin/trace/<id>``
        # can answer "this id existed but fell off the ring" (HTTP 410)
        # instead of an indistinguishable 404.
        self._evictions = 0
        self._tombstones: "collections.deque[str]" = collections.deque(
            maxlen=max(64, self.capacity // 8))
        self._tombstone_set: set = set()

    # -- recording ------------------------------------------------------
    def _evict_overflow_locked(self) -> None:
        while len(self._spans) > self.capacity:
            old_rid, _old = self._spans.popitem(last=False)
            self._finished.discard(old_rid)
            self._evictions += 1
            if len(self._tombstones) == self._tombstones.maxlen:
                dead = self._tombstones.popleft()
                self._tombstone_set.discard(dead)
            self._tombstones.append(old_rid)
            self._tombstone_set.add(old_rid)

    def _span_locked(self, rid: str) -> Dict[str, Any]:
        span = self._spans.get(rid)
        if span is None:
            span = {"request_id": rid, "attrs": {}, "events": []}
            self._spans[rid] = span
            # A tombstoned rid coming back to life is live again, not
            # evicted (e.g. a worker requeue landing after an eviction).
            self._revive_tombstone_locked(rid)
            self._evict_overflow_locked()
        return span

    def _revive_tombstone_locked(self, rid: str) -> None:
        """Clear a tombstone for an rid that is live again — from BOTH
        structures: a stale deque copy left behind would, on its
        eventual popleft, discard the set entry backing a NEWER
        tombstone of the same rid."""
        if rid in self._tombstone_set:
            self._tombstone_set.discard(rid)
            try:
                self._tombstones.remove(rid)
            except ValueError:
                pass

    def annotate(self, rid: str, **attrs: Any) -> None:
        with self._lock:
            self._span_locked(rid)["attrs"].update(attrs)

    def record(self, rid: str, stage: str, plane: str = "service",
               t_mono: Optional[float] = None,
               t_wall: Optional[float] = None, **attrs: Any) -> None:
        """Record one stage event. Idempotent per (stage, plane): retry
        paths (redispatch, on_close backstops) may reach the same stage
        twice, and the FIRST occurrence is the truthful timestamp."""
        event = {"stage": stage, "plane": plane,
                 "t_mono": time.monotonic() if t_mono is None else t_mono,
                 "t_wall": time.time() if t_wall is None else t_wall}
        event.update(attrs)
        with profiler.section("span.write"):
            with self._lock:
                span = self._span_locked(rid)
                if any(e["stage"] == stage and e["plane"] == plane
                       for e in span["events"]):
                    return
                span["events"].append(event)
                if stage == "finished":
                    self._finished.add(rid)

    def merge_remote(self, rid: str, plane: str,
                     events: List[Dict[str, Any]],
                     source: str = "",
                     attrs: Optional[Dict[str, Any]] = None) -> None:
        """Fold another plane's exported events into this store (the
        heartbeat merge path). Remote monotonic stamps are meaningful
        only relative to each other; the wall stamps order them against
        local stages. Remote attrs land under ``attrs[<plane>]`` so the
        worker's view (e.g. the correlation header it actually read)
        never clobbers local keys."""
        with self._lock:
            span = self._span_locked(rid)
            if attrs:
                span["attrs"].setdefault(plane, {}).update(attrs)
            for e in events:
                ev = dict(e)
                ev["plane"] = plane
                if source:
                    ev.setdefault("source", source)
                if any(x["stage"] == ev.get("stage")
                       and x["plane"] == plane
                       and x.get("source") == ev.get("source")
                       for x in span["events"]):
                    continue
                span["events"].append(ev)

    # -- querying -------------------------------------------------------
    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        """A deep-enough copy of one span, events sorted by wall clock
        (cross-plane safe; stable for same-stamp events)."""
        with self._lock:
            span = self._spans.get(rid)
            if span is None:
                return None
            events = [_deep_copy(e) for e in span["events"]]
            attrs = _deep_copy(span["attrs"])
        events.sort(key=lambda e: e.get("t_wall", 0.0))
        return {"request_id": rid, "attrs": attrs, "events": events}

    def interval_ms(self, rid: str, a: str, b: str,
                    plane: str = "service") -> Optional[float]:
        """Monotonic-clock interval between two stages recorded by the
        SAME plane (None when either is missing)."""
        with self._lock:
            span = self._spans.get(rid)
            if span is None:
                return None
            ts = {e["stage"]: e["t_mono"] for e in span["events"]
                  if e["plane"] == plane and "t_mono" in e}
        if a not in ts or b not in ts:
            return None
        return 1000.0 * (ts[b] - ts[a])

    def eviction_count(self) -> int:
        """Spans dropped by ring overflow since construction (the
        ``xllm_span_evictions_total`` scrape-time mirror source)."""
        with self._lock:
            return self._evictions

    def was_evicted(self, rid: str) -> bool:
        """True when ``rid`` once held a span that the ring evicted (and
        it has not been re-created since). Bounded memory: only the most
        recent evictions are remembered — beyond the tombstone ring an
        evicted id degrades back to an honest 404."""
        with self._lock:
            return rid in self._tombstone_set and rid not in self._spans

    def tail(self, n: int, finished_only: bool = False
             ) -> List[Dict[str, Any]]:
        """Deep-enough copies of the newest ``n`` spans (insertion
        order), optionally only those that reached ``finished`` on some
        plane — the debug bundle's recent-request evidence. Copies are
        taken UNDER the lock (like ``get``): live spans mutate
        concurrently, and the incident-debug path must not 500 on a
        dict-changed-during-iteration race."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for span in reversed(self._spans.values()):
                if finished_only and not any(
                        e.get("stage") == "finished"
                        for e in span["events"]):
                    continue
                out.append({"request_id": span["request_id"],
                            "attrs": _deep_copy(span["attrs"]),
                            "events": [_deep_copy(e)
                                       for e in span["events"]]})
                if len(out) >= n:
                    break
        out.reverse()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- worker-side export (heartbeat path) ----------------------------
    def drain_finished(self) -> List[Dict[str, Any]]:
        """Pop every span that reached ``finished`` since the last
        drain, removing them from the ring (the exporter owns them now).
        On a failed ship, hand the batch back via ``requeue``."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            rids, self._finished = sorted(self._finished), set()
            for rid in rids:
                span = self._spans.pop(rid, None)
                if span is not None:
                    out.append({"request_id": rid,
                                "attrs": _deep_copy(span["attrs"]),
                                "events": [_deep_copy(e)
                                           for e in span["events"]]})
        return out

    def requeue(self, drained: List[Dict[str, Any]]) -> None:
        """Return an undeliverable drained batch so the next heartbeat
        retries it (ring bounds still apply)."""
        with self._lock:
            for rec in drained:
                rid = rec["request_id"]
                if rid in self._spans:
                    continue
                self._spans[rid] = {
                    "request_id": rid,
                    "attrs": _deep_copy(rec.get("attrs", {})),
                    "events": [_deep_copy(e)
                               for e in rec.get("events", [])]}
                self._revive_tombstone_locked(rid)
                self._finished.add(rid)
                self._evict_overflow_locked()
