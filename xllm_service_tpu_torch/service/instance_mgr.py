"""InstanceMgr: worker-instance lifecycle, routing state, PD flips,
multi-model serverless allocation.

A copy of the JAX package's ``service/instance_mgr.py``: the same
behaviour and names, importing only this package (and no device code).

Rebuild of the reference's largest component,
``scheduler/managers/instance_mgr.{h,cpp}`` (1452 LoC, SURVEY.md §2 #6):

- two-phase registration: store PUT → pending → first heartbeat confirms
  liveness → registered (instance_mgr.cpp:423-521, 553-604);
- removal on store DELETE (lease expiry = failure detection, :606-686);
- prefill/decode index arrays with O(1) swap-remove (:606-689) and
  round-robin pair selection (:170-186);
- load/latency/request-metrics books (:387-416, :734-817);
- SLO-aware pair selection with per-instance ``TimePredictor`` and
  prefill-overflow-onto-decode (:819-920);
- dynamic PD role flips (:922-970) with auto flip-back when decode drains
  (:812-816);
- multi-model serverless: heat tracking, awake/asleep model states,
  ``fork_master_and_sleep`` on registration, allocation with exhaustive
  coldest-subset eviction (:1067-1243).

Worker control is HTTP POSTs to the worker's endpoints (``/fork_master``,
``/sleep``, ``/wakeup``, ``/flip_role`` — the reference's raw-HTTP engine
control, instance_mgr.cpp:236-250). The transport is injectable so unit
tests can script workers without sockets.
"""

from __future__ import annotations

import itertools
import logging
import threading


import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from xllm_service_tpu_torch.config import InstanceType, ServiceOptions
from xllm_service_tpu_torch.service.coordination import (
    KEY_LOADMETRICS, CoordinationStore, instance_prefix)
from xllm_service_tpu_torch.service.httpd import http_json
from xllm_service_tpu_torch.service.instance_types import (
    Heartbeat, InstanceMetaInfo, LatencyMetrics, LoadMetrics, RequestMetrics,
    RequestPhase)
from xllm_service_tpu_torch.service.time_predictor import TimePredictor
from xllm_service_tpu_torch.utils.locks import make_rlock
from xllm_service_tpu_torch.utils.threads import spawn

logger = logging.getLogger(__name__)

MODEL_AWAKE = "awake"
MODEL_ASLEEP = "asleep"
MODEL_DRAINING = "draining"    # graceful shutdown: route nothing, wake never

# Default model memory footprints (GB) for the serverless allocator. The
# reference hardcodes its list (instance_mgr.cpp:217-225, flagged TODO);
# here it is a config default that ``ServiceOptions``-level config can
# override per deployment.
DEFAULT_MODEL_MEMORY_GB: Dict[str, float] = {}


class InstanceState:
    """Everything the service tracks about one registered worker."""

    def __init__(self, meta: InstanceMetaInfo) -> None:
        self.meta = meta
        self.instance_type = meta.instance_type
        self.load = LoadMetrics()
        self.latency = LatencyMetrics()
        self.req_metrics = RequestMetrics()
        self.predictor = TimePredictor.from_profiling(
            meta.ttft_profiling_data, meta.tpot_profiling_data)
        self.model_states: Dict[str, str] = {}
        self.last_heartbeat = time.monotonic()
        self.flipped_from: Optional[InstanceType] = None
        # Block-hash contract: False when the worker advertised a
        # page_size/hash_seed pair that diverges from the service's
        # (block_size, murmur seed) — its cache digests can never match
        # service-side digests, so the cluster index must not ingest
        # them and the fetch planner must not elect it a holder.
        self.digest_compatible = True
        # EPD embedding-cache advertisement (docs/EPD.md): hex image
        # digests this worker's embed cache currently holds, folded
        # from heartbeat deltas (embed_stored/embed_removed). Bounded
        # by the worker's own cache cap; the cost-aware encode pick
        # credits hits against it.
        self.embed_digests: Set[str] = set()

    @property
    def name(self) -> str:
        return self.meta.name


ControlFn = Callable[[str, str, Dict[str, Any]], Tuple[int, Any]]


def _default_control(address: str, path: str,
                     body: Dict[str, Any]) -> Tuple[int, Any]:
    return http_json("POST", address, path, body, timeout=120.0)


class InstanceMgr:
    def __init__(self, opts: ServiceOptions, store: CoordinationStore,
                 is_master: bool = True,
                 control: Optional[ControlFn] = None,
                 model_memory_gb: Optional[Dict[str, float]] = None,
                 serverless_models: Optional[List[str]] = None,
                 events=None) -> None:
        self.opts = opts
        self.store = store
        self.is_master = is_master
        self.control = control or _default_control
        # Cluster event log (obs.EventLog, optional): instance lifecycle
        # and role flips land there so a post-mortem can replay what the
        # cluster did. emit() never calls out and ranks above this
        # class's lock, so emitting under _lock is safe.
        self.events = events
        self.model_memory_gb = dict(model_memory_gb
                                    or DEFAULT_MODEL_MEMORY_GB)
        # Models every instance should hold as sleeping replicas
        # (fork_master_and_sleep, instance_mgr.cpp:229-260).
        self.serverless_models = list(serverless_models or [])

        self._lock = make_rlock("instance_mgr", 30)
        self._instances: Dict[str, InstanceState] = {}
        self._pending: Dict[str, InstanceMetaInfo] = {}
        self._removed: Set[str] = set()
        # Role index arrays with O(1) swap-remove.
        self._prefill_idx: List[str] = []
        self._decode_idx: List[str] = []
        self._pos: Dict[str, int] = {}          # name → position in its array
        self._rr_prefill = 0
        self._rr_decode = 0
        self._model_heat: Dict[str, float] = {}
        self._watch_ids: List[int] = []
        self._mix_names: Set[str] = set()
        # Removal hook: the scheduler fails in-flight requests routed to a
        # dead instance (set post-construction to avoid a ctor cycle).
        self.on_removed: Optional[Callable[[str], None]] = None
        # Post-heal settle window (guarded-by: instance_mgr): while
        # time.monotonic() < _delete_thaw_at, watch DELETEs are still
        # deferred — the watch replays blackout bookkeeping (or a
        # wiped-store resync's synthetic DELETEs) right after the guard
        # heals, before live workers have re-registered. The follow-up
        # resync at _post_heal_resync_at reconciles anything deferred.
        self._delete_thaw_at = 0.0
        self._post_heal_resync_at = 0.0

        for itype in InstanceType:
            self._watch_ids.append(store.add_watch(
                instance_prefix(itype.value), self._on_instance_event))
        if not is_master:
            self._watch_ids.append(store.add_watch(
                KEY_LOADMETRICS, self._on_loadmetrics_event))
        self._bootstrap()

    # ------------------------------------------------------------------
    # Bootstrap + store events
    # ------------------------------------------------------------------
    def _bootstrap(self) -> None:
        """Adopt instances already registered in the store
        (instance_mgr.cpp:68-154). They are live by definition of their
        lease still existing, so they skip the pending phase.

        The watches are registered BEFORE this runs (no event gap), so
        ``_on_instance_event`` can already be firing on the store's
        dispatch thread — registration must happen under the (re-entrant)
        lock (xlint thread-root-race finding XLINT13-002:
        ``_instances``/``_mix_names``/role arrays mutated from the init
        tail and the watch root with no common guard). The store reads
        stay OUTSIDE the lock: they are network I/O for the etcd/remote
        stores (blocking-under-lock)."""
        for itype in InstanceType:
            items = self.store.get_prefix_json(
                instance_prefix(itype.value))
            with self._lock:
                for key, val in items.items():
                    meta = InstanceMetaInfo.from_json(val)
                    if meta.name:
                        self._register(meta, from_bootstrap=True)

    def _on_instance_event(self, event) -> None:
        ev_type, key, value = event
        name = key.split(":", 2)[-1]
        if ev_type == "PUT":
            import json
            meta = InstanceMetaInfo.from_json(json.loads(value))
            with self._lock:
                if name in self._instances:
                    # Re-registration with new metadata (e.g. role flip
                    # confirmed by the worker re-writing its key).
                    self._instances[name].meta = meta
                    if meta.instance_type == InstanceType.MIX:
                        self._mix_names.add(name)
                        self._reseat_mix()
                    else:
                        self._set_role(name, meta.instance_type)
                        if name in self._mix_names:
                            # A seat holder leaving the MIX pool must
                            # hand the decode seat to the next MIX name.
                            self._mix_names.discard(name)
                            self._reseat_mix()
                elif self.is_master:
                    self._pending[name] = meta
                    self._removed.discard(name)
                    if self.events is not None:
                        self.events.emit(
                            "instance_join", instance=name,
                            instance_type=meta.instance_type.value)
                else:
                    # Replica path: heartbeats flow to the MASTER only, so
                    # a replica must treat store presence as registration
                    # (same rationale as _bootstrap: the key's lease is
                    # alive, and the master is the one gating liveness) —
                    # otherwise a standing replica can never route to
                    # workers that registered after it booted, and
                    # active-active serving / instant takeover both break.
                    # Load state arrives via the master's KEY_LOADMETRICS
                    # uploads; lease expiry arrives as a DELETE event.
                    self._removed.discard(name)
                    self._register(meta, from_bootstrap=True)
        elif ev_type == "DELETE":
            if getattr(self.store, "is_down", False):
                # Control-plane outage (service/store_guard.py): lease
                # expiry is frozen — a DELETE arriving while the store
                # is DOWN is bookkeeping fallout from the outage, not
                # evidence the worker died. Liveness is judged by the
                # direct worker→master heartbeats until the store
                # heals; resync_from_store reconciles afterwards
                # (docs/ROBUSTNESS.md outage contract).
                logger.warning("store outage: freezing DELETE for "
                               "instance %s (lease expiry ignored)", name)
                return
            with self._lock:
                settling = time.monotonic() < self._delete_thaw_at
            if settling:
                # The outage just healed: DELETEs arriving now are the
                # watch catching up on blackout bookkeeping (leases
                # that expired while we were blind) or a wiped-store
                # resync's synthetic DELETEs — live workers re-register
                # within a heartbeat, and the scheduled follow-up
                # resync removes the ones that really went silent.
                logger.warning("post-heal settle: deferring DELETE for "
                               "instance %s until the follow-up resync",
                               name)
                return
            self.remove_instance(name)

    def resync_from_store(self, settle: bool = True) -> None:
        """Post-outage reconciliation (docs/ROBUSTNESS.md outage
        contract), run from the store guard's heal callback:
        registrations that landed in the store while this plane was
        blind become live instances, and book entries whose store key
        vanished are dropped ONLY if their direct heartbeats also went
        silent — a worker whose lease expired during the blackout but
        that kept beating re-registers itself on ITS OWN heal path and
        must not be bounced here. Store reads stay outside the lock
        (same rationale as _bootstrap); re-runnable at any time.

        ``settle=True`` (the heal-callback invocation) also opens the
        post-heal settle window: watch DELETEs stay deferred while the
        watch replays blackout bookkeeping, and a follow-up
        ``resync_from_store(settle=False)`` is scheduled (driven by the
        master loop via :meth:`post_heal_resync_due`) to reconcile
        whatever the deferral skipped."""
        stale_deadline = max(3 * self.opts.heartbeat_interval_s, 3.0)
        if settle:
            # Long enough to cover one full remote watch long-poll
            # round (5s) plus the beat-staleness bound, so by the time
            # the follow-up resync runs, every synthetic DELETE has
            # been seen and a dead worker's beats HAVE gone stale.
            grace = 5.0 + stale_deadline
            with self._lock:
                self._delete_thaw_at = time.monotonic() + grace
                self._post_heal_resync_at = self._delete_thaw_at
        else:
            with self._lock:
                self._post_heal_resync_at = 0.0
        in_store: Set[str] = set()
        for itype in InstanceType:
            items = self.store.get_prefix_json(
                instance_prefix(itype.value))
            with self._lock:
                for _key, val in items.items():
                    meta = InstanceMetaInfo.from_json(val)
                    if not meta.name:
                        continue
                    in_store.add(meta.name)
                    if meta.name in self._instances:
                        continue
                    self._pending.pop(meta.name, None)
                    self._removed.discard(meta.name)
                    self._register(meta, from_bootstrap=True)
        now = time.monotonic()
        with self._lock:
            silent = [n for n, s in self._instances.items()
                      if n not in in_store
                      and now - s.last_heartbeat > stale_deadline]
        for name in silent:
            logger.warning("post-heal resync: %s absent from the store "
                           "and silent for > %.1fs of beats, removing",
                           name, stale_deadline)
            self.remove_instance(name)

    def post_heal_resync_due(self) -> bool:
        """True once the post-heal settle window has elapsed and the
        follow-up reconciliation hasn't run yet (master-loop driven)."""
        with self._lock:
            return self._post_heal_resync_at > 0.0 and \
                time.monotonic() >= self._post_heal_resync_at

    def _on_loadmetrics_event(self, event) -> None:
        """Replica path: learn load metrics from the master's uploads
        (instance_mgr.cpp:691-732)."""
        ev_type, key, value = event
        name = key[len(KEY_LOADMETRICS):]
        if ev_type != "PUT":
            return
        import json
        d = json.loads(value)
        with self._lock:
            inst = self._instances.get(name)
            if inst:
                inst.load = LoadMetrics.from_json(d.get("load"))
                inst.latency = LatencyMetrics.from_json(d.get("latency"))

    # ------------------------------------------------------------------
    # Registration / removal
    # ------------------------------------------------------------------
    def on_heartbeat(self, hb: Heartbeat) -> bool:
        """First heartbeat of a pending instance completes registration
        (instance_mgr.cpp:423-439). Returns True if the instance is (now)
        registered."""
        if self._heartbeat_locked(hb, None):
            return True
        # Unknown instance with nothing pending: the heartbeat raced
        # ahead of the watch's PUT. Read through to the store OUTSIDE
        # the lock — it is network I/O on the etcd/remote stores, and
        # on_heartbeat runs on the RPC fan-in path where every
        # scheduler/route thread contends for this lock (xlint
        # blocking-under-lock finding XLINT12-001) — then retry with
        # the fetched meta. _heartbeat_locked re-checks _removed under
        # the lock, so a removal landing mid-read still wins.
        with self._lock:
            if hb.name in self._removed:
                return False
        val = self.store.get_json(
            instance_prefix(hb.instance_type.value) + hb.name)
        if not val:
            return False
        return self._heartbeat_locked(hb, InstanceMetaInfo.from_json(val))

    def _heartbeat_locked(self, hb: Heartbeat,
                          fallback_meta: Optional[InstanceMetaInfo]
                          ) -> bool:
        """One locked heartbeat-apply attempt; ``fallback_meta`` is the
        out-of-lock store read-through result (None on the first try)."""
        stage: Optional[InstanceState] = None
        with self._lock:
            inst = self._instances.get(hb.name)
            if inst is None:
                meta = self._pending.pop(hb.name, None)
                if meta is None and hb.name not in self._removed:
                    meta = fallback_meta
                if meta is None:
                    return False
                inst = self._register(meta)
                if self.serverless_models and self.is_master:
                    stage = inst
            inst.last_heartbeat = time.monotonic()
            inst.load = hb.load
            inst.latency = hb.latency
            if hb.embed_stored or hb.embed_removed:
                inst.embed_digests.difference_update(hb.embed_removed)
                inst.embed_digests.update(hb.embed_stored)
                # Defensive bound: a worker that never reports
                # evictions must not grow this set without limit.
                if len(inst.embed_digests) > 4096:
                    inst.embed_digests = set(
                        list(inst.embed_digests)[-4096:])
            if hb.model_states:
                inst.model_states.update(hb.model_states)
        if stage is not None:
            # Control I/O OUTSIDE the lock (XLINT12-002): the staging
            # round trip can take up to the control timeout, and every
            # routing thread contends for the instance lock.
            self._fork_master_and_sleep(stage)
        return True

    def _register(self, meta: InstanceMetaInfo,
                  from_bootstrap: bool = False) -> InstanceState:
        inst = InstanceState(meta)
        # Block-hash single source of truth (docs/KV_CACHE.md): a worker
        # whose engine page size / murmur seed diverges from the
        # service's (block_size, seed) reports digests that can NEVER
        # match service-side digests — cache-aware scores for it would
        # be garbage and a fetch from it would adopt wrong-keyed blocks.
        # Fail loud (event + log) and quarantine its cache reporting;
        # the instance still serves traffic (correctness is unaffected,
        # only prefix reuse is off for it).
        if meta.page_size and (
                meta.page_size != self.opts.block_size
                or meta.hash_seed != self.opts.murmur_hash3_seed):
            inst.digest_compatible = False
            logger.error(
                "instance %s advertises block hashing (page_size=%d, "
                "seed=%d) incompatible with the service's (block_size="
                "%d, seed=%d): its prefix-cache digests are quarantined "
                "— fix block_size/page_size to re-enable prefix reuse",
                meta.name, meta.page_size, meta.hash_seed,
                self.opts.block_size, self.opts.murmur_hash3_seed)
            if self.events is not None:
                self.events.emit(
                    "cache_digest_mismatch", instance=meta.name,
                    worker_page_size=meta.page_size,
                    worker_hash_seed=meta.hash_seed,
                    service_block_size=self.opts.block_size,
                    service_hash_seed=self.opts.murmur_hash3_seed)
        self._instances[meta.name] = inst
        itype = meta.instance_type
        if itype == InstanceType.MIX:
            # MIX split: one MIX instance decodes, the rest prefill
            # (instance_mgr.cpp:497-514). The reference seats whichever
            # arrives first; with replicas registering from watch events
            # (different delivery order than the master's heartbeat
            # order) arrival order is NOT shared state, so the seat is
            # the lexicographically smallest live MIX name — every node
            # computes the same split from membership alone.
            self._mix_names.add(meta.name)
            self._set_role(meta.name, InstanceType.PREFILL)
            self._reseat_mix()
        else:
            self._set_role(meta.name, itype)
        for m in meta.models:
            inst.model_states[m] = MODEL_AWAKE
        # Serverless staging (_fork_master_and_sleep) is the CALLER's
        # job after releasing the lock: it is an up-to-120 s control
        # HTTP round trip, the same blocking-under-lock class as
        # XLINT12-001 (finding XLINT12-002). _register is always
        # invoked under self._lock, so it must never do I/O.
        if self.events is not None:
            self.events.emit(
                "instance_confirm", instance=meta.name,
                instance_type=inst.instance_type.value,
                models=list(meta.models), bootstrap=from_bootstrap)
        logger.info("registered instance %s type=%s models=%s",
                    meta.name, inst.instance_type.value, meta.models)
        return inst

    def _fork_master_and_sleep(self, inst: InstanceState) -> None:
        """Stage every serverless model on the new instance asleep
        (weights parked in host RAM, compiled programs kept) — the
        worker's /fork_master + /sleep per model
        (instance_mgr.cpp:229-260, SURVEY.md §7.1)."""
        with self._lock:
            extra = [m for m in self.serverless_models
                     if m not in inst.model_states]
        if not extra:
            return
        try:
            # The control round trip runs UNLOCKED (XLINT12-002); only
            # the resulting state flip goes back under the lock.
            status, _ = self.control(inst.meta.rpc_address, "/fork_master",
                                     {"models": extra})
            if status == 200:
                with self._lock:
                    for m in extra:
                        inst.model_states[m] = MODEL_ASLEEP
        except Exception as e:  # noqa: BLE001
            logger.warning("fork_master_and_sleep(%s) failed: %s",
                           inst.name, e)

    def _reseat_mix(self) -> None:
        """Re-derive the MIX decode seat (min live name) after MIX
        membership changes. Reassignments are routing-table-only: a MIX
        worker serves both phases, so flipping its classification needs
        no worker round trip."""
        if not self._mix_names:
            return
        seat = min(self._mix_names)
        for name in self._mix_names:
            want = (InstanceType.DECODE if name == seat
                    else InstanceType.PREFILL)
            inst = self._instances.get(name)
            if inst is not None and inst.instance_type != want:
                self._set_role(name, want)

    def _set_role(self, name: str, itype: InstanceType) -> None:
        self._remove_from_indexes(name)
        inst = self._instances[name]
        inst.instance_type = itype
        if itype in (InstanceType.PREFILL, InstanceType.DEFAULT):
            self._pos[name] = len(self._prefill_idx)
            self._prefill_idx.append(name)
        elif itype == InstanceType.DECODE:
            self._pos[name] = len(self._decode_idx)
            self._decode_idx.append(name)
        # ENCODE instances live only in _instances (EPD encode pool).

    def _remove_from_indexes(self, name: str) -> None:
        pos = self._pos.pop(name, None)
        if pos is None:
            return
        for arr in (self._prefill_idx, self._decode_idx):
            if pos < len(arr) and arr[pos] == name:
                last = arr.pop()
                if pos < len(arr):
                    arr[pos] = last
                    self._pos[last] = pos
                return
        # Name was in the other array's index space; linear fallback.
        for arr in (self._prefill_idx, self._decode_idx):
            if name in arr:
                i = arr.index(name)
                last = arr.pop()
                if i < len(arr):
                    arr[i] = last
                    self._pos[last] = i
                return

    def remove_instance(self, name: str) -> None:
        """Full cleanup on store DELETE / lease expiry
        (instance_mgr.cpp:606-686)."""
        with self._lock:
            self._pending.pop(name, None)
            if name not in self._instances:
                return
            self._remove_from_indexes(name)
            del self._instances[name]
            self._removed.add(name)
            if name in self._mix_names:
                self._mix_names.discard(name)
                self._reseat_mix()
        if self.events is not None:
            self.events.emit("instance_remove", instance=name)
        logger.info("removed instance %s", name)
        if self.on_removed is not None:
            try:
                self.on_removed(name)
            except Exception:  # noqa: BLE001
                logger.exception("on_removed(%s) hook failed", name)

    # ------------------------------------------------------------------
    # Accessors
    # ------------------------------------------------------------------
    def get(self, name: str) -> Optional[InstanceState]:
        with self._lock:
            return self._instances.get(name)

    def digest_ok(self, name: str) -> bool:
        """True when ``name`` is registered AND its block-hash contract
        matches the service's (see ``_register``). Gates cache-delta
        ingestion and holder election."""
        with self._lock:
            inst = self._instances.get(name)
            return inst is not None and inst.digest_compatible

    def names(self) -> List[str]:
        with self._lock:
            return list(self._instances)

    def _is_draining_locked(self, name: str) -> bool:
        """Drain is whole-worker: any model advertising "draining"
        means the instance must receive no new work of any kind (it is
        finishing in-flight requests before a graceful shutdown)."""
        inst = self._instances.get(name)
        return inst is not None and any(
            st == MODEL_DRAINING for st in inst.model_states.values())

    def prefill_instances(self) -> List[str]:
        with self._lock:
            return [n for n in self._prefill_idx
                    if not self._is_draining_locked(n)]

    def decode_instances(self) -> List[str]:
        with self._lock:
            return [n for n in self._decode_idx
                    if not self._is_draining_locked(n)]

    def encode_instances(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._instances.items()
                    if s.instance_type == InstanceType.ENCODE
                    and not self._is_draining_locked(n)]

    def get_next_encode_instance(self) -> Optional[str]:
        """RR over the EPD encode pool."""
        with self._lock:
            pool = [n for n, s in self._instances.items()
                    if s.instance_type == InstanceType.ENCODE
                    and not self._is_draining_locked(n)]
            if not pool:
                return None
            self._rr_encode = getattr(self, "_rr_encode", 0)
            name = pool[self._rr_encode % len(pool)]
            self._rr_encode += 1
            return name

    # Prior for the per-image encode cost before a worker has reported
    # a measured value (LatencyMetrics.encode_ms == 0.0).
    _ENCODE_MS_PRIOR = 50.0

    def select_encode_instance(self, digests: List[str],
                               audit: Optional[Dict[str, Any]] = None
                               ) -> Tuple[Optional[str], List[str]]:
        """Cost-aware EPD encode pick (docs/EPD.md): score every live
        ENCODE instance on measured per-image encode ms × the work it
        would actually do — queued jobs ahead plus THIS request's
        cache-missed images (heartbeat-advertised embed digests credit
        the hits). Returns (winner, ranked survivors); the survivors
        ride ``Routing.encode_fallbacks`` so the prefill worker's
        reroute on encode death is deterministic. (None, []) when no
        encode pool exists — the prefill worker encodes locally."""
        n_img = max(1, len(digests))
        scored: List[Tuple[float, str, Dict[str, Any]]] = []
        with self._lock:
            for name, s in self._instances.items():
                if s.instance_type != InstanceType.ENCODE \
                        or self._is_draining_locked(name):
                    continue
                queue = int(getattr(s.load, "encode_queue_depth", 0))
                enc_ms = float(getattr(s.latency, "encode_ms", 0.0)) \
                    or self._ENCODE_MS_PRIOR
                hits = sum(1 for d in digests if d in s.embed_digests)
                misses = len(digests) - hits
                # Queued jobs ahead are priced at one image each (the
                # queue ships depth, not image count); cache-hit images
                # skip the tower entirely.
                est_ms = enc_ms * (queue + misses)
                scored.append((est_ms, name, {
                    "queue": queue, "encode_ms": round(enc_ms, 3),
                    "cache_hits": hits, "est_ms": round(est_ms, 3)}))
        scored.sort(key=lambda t: (t[0], t[1]))
        if audit is not None:
            audit["encode"] = {
                "policy": "cost", "images": n_img,
                "candidates": {name: terms for _, name, terms in scored},
                "winner": scored[0][1] if scored else None,
            }
        if not scored:
            return None, []
        return scored[0][1], [name for _, name, _ in scored[1:]]

    def address_of(self, name: str) -> Optional[str]:
        inst = self.get(name)
        return inst.meta.rpc_address if inst else None

    def instance_table(self) -> List[Dict[str, Any]]:
        """Flight-recorder view of the live instance books (the debug
        bundle's cluster evidence): role, addresses, model states, last
        load/latency, and heartbeat age per registered instance."""
        now = time.monotonic()
        with self._lock:
            return [{"name": name,
                     "instance_type": s.instance_type.value,
                     "declared_type": s.meta.instance_type.value,
                     "rpc_address": s.meta.rpc_address,
                     "models": dict(s.model_states),
                     "load": s.load.to_json(),
                     "latency": s.latency.to_json(),
                     "heartbeat_age_s": round(now - s.last_heartbeat, 3),
                     "flipped_from": s.flipped_from.value
                     if s.flipped_from else None}
                    for name, s in self._instances.items()]

    def instance_info(self, name: str) -> Optional[Dict[str, Any]]:
        inst = self.get(name)
        return inst.meta.to_json() if inst else None

    # ------------------------------------------------------------------
    # Round-robin pair selection (instance_mgr.cpp:170-186)
    # ------------------------------------------------------------------
    def get_next_instance_pair(self) -> Tuple[Optional[str], Optional[str]]:
        with self._lock:
            prefill = decode = None
            prefills = [n for n in self._prefill_idx
                        if not self._is_draining_locked(n)]
            decodes = [n for n in self._decode_idx
                       if not self._is_draining_locked(n)]
            if prefills:
                prefill = prefills[self._rr_prefill % len(prefills)]
                self._rr_prefill += 1
            if decodes:
                decode = decodes[self._rr_decode % len(decodes)]
                self._rr_decode += 1
            if prefill is None:
                # Degenerate pool (e.g. a single MIX instance that took the
                # decode slot): decode workers can prefill too.
                prefill = decode
            return prefill, decode

    def least_loaded_instance(self, pool: Optional[List[str]] = None
                              ) -> Optional[str]:
        """Fallback pick when no cache overlap exists
        (instance_mgr.cpp:316-385)."""
        with self._lock:
            cands = pool if pool is not None else list(self._prefill_idx)
            best, best_score = None, None
            for name in cands:
                inst = self._instances.get(name)
                if inst is None or self._is_draining_locked(name):
                    continue
                score = (inst.load.waiting_requests
                         + inst.load.kv_cache_usage)
                if best_score is None or score < best_score:
                    best, best_score = name, score
            return best

    # ------------------------------------------------------------------
    # Request metrics ledger (instance_mgr.cpp:745-817)
    # ------------------------------------------------------------------
    def update_request_metrics(self, name: str, phase: str,
                               num_tokens: int = 0) -> None:
        with self._lock:
            inst = self._instances.get(name)
            if inst is None:
                return
            m = inst.req_metrics
            if phase == RequestPhase.SCHEDULE:
                m.num_prefill_requests += 1
                m.num_prefill_tokens += num_tokens
                if inst.predictor.has_ttft:
                    m.estimated_prefill_time_ms += \
                        inst.predictor.predict_ttft(num_tokens)
            elif phase == RequestPhase.UNSCHEDULE:
                m.num_prefill_requests = max(0, m.num_prefill_requests - 1)
                m.num_prefill_tokens = max(0, m.num_prefill_tokens
                                           - num_tokens)
                if inst.predictor.has_ttft:
                    m.estimated_prefill_time_ms = max(
                        0.0, m.estimated_prefill_time_ms
                        - inst.predictor.predict_ttft(num_tokens))
            elif phase == RequestPhase.PREFILL_FINISH:
                m.num_prefill_requests = max(0, m.num_prefill_requests - 1)
                m.num_prefill_tokens = max(0, m.num_prefill_tokens
                                           - num_tokens)
                if inst.predictor.has_ttft:
                    m.estimated_prefill_time_ms = max(
                        0.0, m.estimated_prefill_time_ms
                        - inst.predictor.predict_ttft(num_tokens))
                m.num_decode_requests += 1
                m.num_decode_tokens += num_tokens
            elif phase == RequestPhase.GENERATE:
                m.num_decode_tokens += num_tokens
            elif phase in (RequestPhase.FINISH_DECODE, RequestPhase.CANCEL):
                m.num_decode_requests = max(0, m.num_decode_requests - 1)
                m.num_decode_tokens = max(0, m.num_decode_tokens
                                          - num_tokens)
                # Auto flip-back when a flipped decode instance drains
                # (instance_mgr.cpp:812-816).
                if (m.num_decode_requests == 0
                        and inst.flipped_from == InstanceType.PREFILL):
                    self._flip_locked(name, InstanceType.PREFILL)

    # ------------------------------------------------------------------
    # SLO-aware selection + dynamic PD flips (instance_mgr.cpp:819-970)
    # ------------------------------------------------------------------
    def _backlog_ms(self, inst) -> float:
        """Heartbeat-advertised prefill backlog converted to time: the
        worker's queued-but-uncomputed prompt tokens over its measured
        prefill throughput (falling back to the planner's 4000 tok/s
        default until a measurement arrives). This is the P/D-Serve
        term: the service-side in-flight ledger alone misses prompts
        already sitting in a worker's own queue."""
        toks = getattr(inst.latency, "waiting_prefill_tokens", 0) or 0
        if toks <= 0:
            return 0.0
        rate = inst.latency.prefill_tok_s or 4000.0
        return 1000.0 * toks / rate

    def select_instance_pair_on_slo(self, num_prompt_tokens: int,
                                    audit: Optional[Dict[str, Any]] = None
                                    ) -> Tuple[Optional[str], Optional[str],
                                               float]:
        """Returns (prefill, decode, estimated_ttft_ms). ``audit``, when
        given, gains the prefill winner's backlog term so the routing
        decision stays explainable (attrs.schedule_decision)."""
        with self._lock:
            # Prefill: argmin of estimated prefill backlog — the
            # service-side ledger estimate PLUS the worker-advertised
            # queue converted to ms (falling back to
            # the decode pool when no dedicated prefill instance exists).
            best_p, best_p_time, best_p_backlog = None, float("inf"), 0.0
            for name in (self._prefill_idx or self._decode_idx):
                if self._is_draining_locked(name):
                    continue
                inst = self._instances[name]
                backlog = self._backlog_ms(inst)
                t = inst.req_metrics.estimated_prefill_time_ms + backlog
                if t < best_p_time:
                    best_p, best_p_time, best_p_backlog = name, t, backlog
            if audit is not None and best_p is not None:
                audit["backlog_ms"] = round(best_p_backlog, 3)
                audit["waiting_prefill_tokens"] = int(getattr(
                    self._instances[best_p].latency,
                    "waiting_prefill_tokens", 0) or 0)

            # Decode: first instance whose predicted TPOT meets the target,
            # else argmin predicted TPOT.
            target_tpot = self.opts.target_tpot_ms
            best_d, best_d_tpot = None, float("inf")
            for name in self._decode_idx:
                if self._is_draining_locked(name):
                    # A draining worker's emptying backlog makes it look
                    # MOST attractive to the SLO argmin — skip it.
                    continue
                inst = self._instances[name]
                m = inst.req_metrics
                tpot = inst.predictor.predict_tpot(
                    m.num_decode_tokens + num_prompt_tokens,
                    m.num_decode_requests + 1)
                if tpot <= target_tpot:
                    best_d, best_d_tpot = name, tpot
                    break
                if tpot < best_d_tpot:
                    best_d, best_d_tpot = name, tpot

            est_ttft = best_p_time
            if best_p is not None:
                inst = self._instances[best_p]
                if inst.predictor.has_ttft:
                    est_ttft = (best_p_time
                                + inst.predictor.predict_ttft(
                                    num_prompt_tokens))

            # Prefill overflow onto an idle decode instance
            # (instance_mgr.cpp:879-905).
            if (best_p is not None and est_ttft > self.opts.target_ttft_ms
                    and self._decode_idx):
                idle = [n for n in self._decode_idx
                        if self._instances[n].req_metrics.num_decode_requests
                        == 0 and n != best_d
                        # a draining worker is precisely the one
                        # guaranteed to look idle — never overflow to it
                        and not self._is_draining_locked(n)]
                if idle:
                    best_p = idle[0]
                    est_ttft = self._instances[best_p].predictor.predict_ttft(
                        num_prompt_tokens)

            # No decode meets TPOT and prefill pool has slack → flip a
            # prefill instance to decode (instance_mgr.cpp:907-917).
            if (best_d is not None and best_d_tpot > target_tpot
                    and len(self._prefill_idx) > 1):
                flip = next((n for n in self._prefill_idx
                             if n != best_p
                             and not self._is_draining_locked(n)), None)
                if flip:
                    self._flip_locked(flip, InstanceType.DECODE)
                    best_d = flip
            return best_p, best_d, est_ttft

    def flip_prefill_to_decode(self, name: str) -> bool:
        with self._lock:
            inst = self._instances.get(name)
            if inst is None or inst.instance_type != InstanceType.PREFILL:
                return False
            return self._flip_locked(name, InstanceType.DECODE)

    def flip_decode_to_prefill(self, name: str) -> bool:
        with self._lock:
            inst = self._instances.get(name)
            if inst is None or inst.instance_type != InstanceType.DECODE:
                return False
            return self._flip_locked(name, InstanceType.PREFILL)

    def _flip_locked(self, name: str, to_type: InstanceType) -> bool:
        inst = self._instances[name]
        from_type = inst.instance_type
        if from_type == to_type:
            return False
        inst.flipped_from = None if inst.flipped_from else from_type
        self._set_role(name, to_type)
        if self.events is not None:
            self.events.emit("role_flip", instance=name,
                             from_type=from_type.value,
                             to_type=to_type.value)
        logger.info("flipped %s %s→%s", name, from_type.value, to_type.value)
        # Fire-and-forget worker notification; a flip just changes which
        # compiled program set the worker prioritizes (SURVEY.md §7.1).
        def notify() -> None:
            try:
                self.control(inst.meta.rpc_address, "/flip_role",
                             {"instance_type": to_type.value})
            except Exception as e:  # noqa: BLE001
                logger.warning("flip notify %s failed: %s", name, e)
        spawn("instance_mgr.flip_notify", notify,
              events=lambda: self.events).start()
        return True

    # ------------------------------------------------------------------
    # Load metrics replication (master upload, instance_mgr.cpp:398-416)
    # ------------------------------------------------------------------
    def upload_load_metrics(self) -> None:
        with self._lock:
            snapshot = {name: {"load": inst.load.to_json(),
                               "latency": inst.latency.to_json()}
                        for name, inst in self._instances.items()}
        for name, val in snapshot.items():
            self.store.put_json(KEY_LOADMETRICS + name, val)

    # ------------------------------------------------------------------
    # Multi-model serverless (instance_mgr.cpp:1067-1243)
    # ------------------------------------------------------------------
    def update_model_heat(self, model: str) -> None:
        with self._lock:
            self._model_heat[model] = self._model_heat.get(model, 0.0) + 1.0

    def model_heat(self, model: str) -> float:
        with self._lock:
            return self._model_heat.get(model, 0.0)

    def get_awake_instance(self, model: str) -> Optional[str]:
        """Least-loaded instance where ``model`` is awake
        (instance_mgr.cpp:1087-1105)."""
        with self._lock:
            cands = [n for n, s in self._instances.items()
                     if s.model_states.get(model) == MODEL_AWAKE]
            return self.least_loaded_instance(cands) if cands else None

    def filter_model_awake(self, pool: List[str], model: str
                           ) -> List[str]:
        """Restrict ``pool`` to instances where ``model`` is awake.
        A pool with no per-model state at all (single-model deployments
        never populate ``model_states``) passes through unchanged —
        the filter only bites where model placement is actually
        tracked, so a model-blind fallback pick can't land on an
        instance that holds the model asleep or not at all."""
        with self._lock:
            states = [(n, self._instances[n].model_states.get(model)
                       if n in self._instances else None)
                      for n in pool]
        if not any(st is not None for _, st in states):
            return list(pool)
        return [n for n, st in states if st == MODEL_AWAKE]

    def allocate_instance_for_model(self, model: str) -> Optional[str]:
        """Wake ``model`` somewhere, evicting the coldest model subset if
        memory requires (instance_mgr.cpp:1107-1243)."""
        need_gb = self.model_memory_gb.get(model, 0.0)
        with self._lock:
            best: Optional[Tuple[str, List[str]]] = None
            best_heat = float("inf")
            for name, inst in self._instances.items():
                if model not in inst.model_states:
                    continue
                if inst.model_states[model] == MODEL_DRAINING:
                    # A draining instance must not be woken back up —
                    # it is finishing in-flight work before shutdown.
                    continue
                awake = [m for m, st in inst.model_states.items()
                         if st == MODEL_AWAKE]
                used = sum(self.model_memory_gb.get(m, 0.0) for m in awake)
                free = inst.meta.memory_budget_gb - used
                if free >= need_gb:
                    victims: List[str] = []
                    heat = 0.0
                else:
                    victims = self._select_eviction_candidates(
                        awake, need_gb - free)
                    if victims is None:
                        continue
                    heat = sum(self._model_heat.get(m, 0.0)
                               for m in victims)
                if heat < best_heat:
                    best, best_heat = (name, victims), heat
            if best is None:
                return None
            name, victims = best
            inst = self._instances[name]
        # Control calls outside the lock.
        for victim in victims:
            try:
                self.control(inst.meta.rpc_address, "/sleep",
                             {"model": victim})
                with self._lock:
                    inst.model_states[victim] = MODEL_ASLEEP
            except Exception as e:  # noqa: BLE001
                logger.warning("sleep(%s@%s) failed: %s", victim, name, e)
        try:
            status, _ = self.control(inst.meta.rpc_address, "/wakeup",
                                     {"model": model})
            if status != 200:
                return None
        except Exception as e:  # noqa: BLE001
            logger.warning("wakeup(%s@%s) failed: %s", model, name, e)
            return None
        with self._lock:
            inst.model_states[model] = MODEL_AWAKE
        return name

    def _select_eviction_candidates(self, awake: List[str],
                                    need_gb: float) -> Optional[List[str]]:
        """Exhaustive subset search: the subset freeing ≥ need_gb with
        minimum total heat, smallest size as tiebreak
        (instance_mgr.cpp:1188-1243)."""
        best: Optional[List[str]] = None
        best_key: Optional[Tuple[float, int]] = None
        for r in range(1, len(awake) + 1):
            for subset in itertools.combinations(awake, r):
                freed = sum(self.model_memory_gb.get(m, 0.0)
                            for m in subset)
                if freed < need_gb:
                    continue
                heat = sum(self._model_heat.get(m, 0.0) for m in subset)
                key = (heat, r)
                if best_key is None or key < best_key:
                    best, best_key = list(subset), key
            if best is not None:
                # Any larger subset has ≥ heat (heats are non-negative) at
                # larger size, so the first radius with a fit is optimal
                # only per-size; continue searching all sizes for min heat.
                pass
        return best

    # ------------------------------------------------------------------
    def stale_instances(self, timeout_s: float) -> List[str]:
        """Instances whose heartbeats stopped (the reference's dead
        ``detect_disconnected_instance_interval`` flag, implemented here —
        SURVEY.md §7.4)."""
        now = time.monotonic()
        with self._lock:
            return [n for n, s in self._instances.items()
                    if now - s.last_heartbeat > timeout_s]

    def close(self) -> None:
        for wid in self._watch_ids:
            try:
                self.store.cancel_watch(wid)
            except Exception:  # noqa: BLE001 — store may be mid-outage
                # at shutdown; the watch dies with the process anyway
                pass
