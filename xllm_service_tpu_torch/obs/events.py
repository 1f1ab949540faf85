"""Structured event log: what happened to a worker or the cluster, when.

A copy of the JAX package's ``obs/events.py`` ``EventLog``: a bounded,
ordered, thread-safe ring of typed events. The worker keeps one
(``Worker.events``, 256 events) where ``thread_crashed`` (a supervised
thread's crash, ``utils/threads.py``), ``store_outage_open`` and
``store_outage_close`` (the store guard, ``service/store_guard.py``) and
``failpoint_tripped`` land. The master keeps the cluster's
(``XLLM_EVENT_RING``, 1024 events): instance lifecycle, role flips,
elections, redispatches, SLO breaches and watchdog anomalies, served at
``GET /admin/events?since=<seq>`` and in ``/admin/debug_bundle``.

- CLOSED taxonomy: ``EVENT_TYPES`` is the JAX package's catalogue,
  whole; ``emit()`` rejects anything else.
- Bounded and always on: the oldest events drop, with a drop counter so
  truncation is visible; ``since(seq)`` pages through the ring oldest
  first, and a gap in the sequence numbers is the sign of a drop.
- ``emit`` never calls out, so it is safe under every lock.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.utils.locks import make_lock


def _deep_copy(v: Any) -> Any:
    """A copy of dict/list/tuple values deep enough for the read side."""
    if isinstance(v, dict):
        return {k: _deep_copy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_deep_copy(x) for x in v]
    return v


# The complete event taxonomy, as the JAX package's.
EVENT_TYPES = (
    "instance_join",        # worker key seen in the store (pending)
    "instance_confirm",     # registration complete: instance routable
    "instance_remove",      # lease expiry / store DELETE cleanup
    "role_flip",            # dynamic PD role change
    "master_elected",       # this replica won/took over the election
    "master_lease_lost",    # this replica's lease expired under it
    "redispatch",           # request re-routed after a worker refusal
    "slo_breach_open",      # an SLO objective's burn rate crossed open
    "slo_breach_close",     # ... and recovered
    "anomaly_open",         # watchdog opened a per-instance anomaly
    "anomaly_close",        # ... and it cleared
    "request_recovered",    # mid-stream failover resumed a request
    "recovery_failed",      # ... or exhausted its retry budget
    "failpoint_tripped",    # an armed fault-injection site fired
    "cache_digest_mismatch",  # a worker's block hashing diverges from
                              # the service's
    "thread_crashed",       # an uncaught exception escaped a supervised
                            # thread root (attrs: root, error,
                            # restarting)
    "store_outage_open",    # the store guard declared the store down
    "store_outage_close",   # the store healed
    "master_demoted",       # this replica stopped being master
    "encode_fallback",      # a routed encode stage was not served by
                            # its chosen instance
    "engine_fault",         # a worker contained a step fault and blamed
                            # this request
    "request_quarantined",  # the poison ledger quarantined a prompt
)

DEFAULT_CAPACITY = 1024


class EventLog:
    """Bounded, ordered, thread-safe structured event ring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = make_lock("obs.events", 80)
        self._ring: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=self.capacity)
        self._seq = 0
        self._counts: Dict[str, int] = {t: 0 for t in EVENT_TYPES}
        self._dropped = 0

    def emit(self, type: str, **attrs: Any) -> int:
        """Append one event; returns its sequence number. ``type`` must
        be in ``EVENT_TYPES``."""
        if type not in EVENT_TYPES:
            raise ValueError(
                f"event type {type!r} is not in the obs/events.py "
                f"catalog {EVENT_TYPES}")
        with profiler.section("event.emit"):
            with self._lock:
                self._seq += 1
                if len(self._ring) == self.capacity:
                    self._dropped += 1
                self._ring.append({"seq": self._seq, "type": type,
                                   "t_wall": time.time(), "attrs": attrs})
                self._counts[type] += 1
                return self._seq

    def since(self, seq: int = 0,
              limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Events with sequence number > ``seq``, oldest first (the
        oldest ``limit`` of them)."""
        with self._lock:
            out = [dict(e, attrs=_deep_copy(e["attrs"]))
                   for e in self._ring if e["seq"] > seq]
        if limit is not None and len(out) > limit:
            out = out[:limit]
        return out

    def counts(self) -> Dict[str, int]:
        """Per-type totals since boot (not the ring's occupancy)."""
        with self._lock:
            return dict(self._counts)

    @property
    def latest_seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted from the ring."""
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
