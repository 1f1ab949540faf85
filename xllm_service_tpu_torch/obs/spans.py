"""Per-request span timelines of the worker plane.

A copy of the JAX package's ``obs/spans.py`` ``SpanStore``, the part a
worker uses. One span per ``service_request_id``: an ordered list of
stage events, each stamped with this process's monotonic clock
(intervals within the plane) and wall clock (ordering across planes).
The worker records ``received`` -> ``encoded`` -> ``scheduled`` ->
``first_token`` -> ``faulted`` / ``finished`` (``WORKER_STAGES``) under
the correlation id the master stamps on a forwarded request (the
``x-xllm-request-id`` header, ``REQUEST_ID_HEADER``). The heartbeat
ships finished spans (``drain_finished``) and hands back an undelivered
batch (``requeue``); the master merges them under ``plane="worker"`` and
serves the timeline at ``GET /admin/trace/<id>``.

The store is a bounded ring: the oldest span is evicted past
``capacity`` (the worker sizes it with ``XLLM_SPAN_RING``), counted by
``eviction_count`` (``xllm_span_evictions_total``). Thread-safe; rank
``obs.spans`` in the ``utils/locks.py`` table.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.utils.locks import make_lock


def _deep_copy(v: Any) -> Any:
    """Copy of a span payload (dict / list / tuple of JSON values): the
    read side copies, writers stay cheap."""
    if isinstance(v, dict):
        return {k: _deep_copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_deep_copy(x) for x in v]
    return v


# "encoded" only on multimodal requests, "faulted" only on requests the
# step fault boundary blamed.
WORKER_STAGES = ("received", "encoded", "scheduled", "first_token",
                 "faulted", "finished")

DEFAULT_CAPACITY = 2048

REQUEST_ID_HEADER = "x-xllm-request-id"


class SpanStore:
    """Ring buffer of span timelines keyed by correlation id."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("obs.spans", 94)
        # rid -> {"request_id", "attrs", "events"}; insertion order is
        # eviction order.
        self._spans: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        # The drain queue, always a subset of the ring's keys (eviction
        # discards the mark too).
        self._finished: set = set()
        self._evictions = 0

    # -- recording ------------------------------------------------------
    def _evict_overflow_locked(self) -> None:
        while len(self._spans) > self.capacity:
            old_rid, _old = self._spans.popitem(last=False)
            self._finished.discard(old_rid)
            self._evictions += 1

    def _span_locked(self, rid: str) -> Dict[str, Any]:
        span = self._spans.get(rid)
        if span is None:
            span = {"request_id": rid, "attrs": {}, "events": []}
            self._spans[rid] = span
            self._evict_overflow_locked()
        return span

    def annotate(self, rid: str, **attrs: Any) -> None:
        with self._lock:
            self._span_locked(rid)["attrs"].update(attrs)

    def record(self, rid: str, stage: str, plane: str = "service",
               t_mono: Optional[float] = None,
               t_wall: Optional[float] = None, **attrs: Any) -> None:
        """Record one stage event. Idempotent per (stage, plane): the
        first occurrence is the truthful timestamp."""
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

    # -- querying -------------------------------------------------------
    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        """A copy of one span, events sorted by wall clock."""
        with self._lock:
            span = self._spans.get(rid)
            if span is None:
                return None
            events = [_deep_copy(e) for e in span["events"]]
            attrs = _deep_copy(span["attrs"])
        events.sort(key=lambda e: e.get("t_wall", 0.0))
        return {"request_id": rid, "attrs": attrs, "events": events}

    def eviction_count(self) -> int:
        """Spans dropped by ring overflow since construction."""
        with self._lock:
            return self._evictions

    # -- export on the heartbeat ----------------------------------------
    def drain_finished(self) -> List[Dict[str, Any]]:
        """Pop every span that reached ``finished`` since the last drain
        (the exporter owns them now); on a failed ship, hand the batch
        back with ``requeue``."""
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
        """Return an undelivered drained batch so the next beat retries
        it (ring bounds still apply)."""
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
                self._finished.add(rid)
                self._evict_overflow_locked()
