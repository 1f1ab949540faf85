"""Scheduler: per-request orchestration + cluster state + HA election.

A copy of the JAX package's ``service/scheduler.py``: the same behaviour
and names, importing only this package (and no device code).

Rebuild of ``scheduler/scheduler.{h,cpp}`` (SURVEY.md §2 #4, §3.2-3.5):

- ``schedule(request)``: chat template → tokenize → model heat → route
  (serverless awake/allocate for multi-model; the configured LB policy for
  the PD pair — composed, fixing the reference quirk where ``schedule()``
  bypasses ``lb_policy_``, scheduler.cpp:100-119 TODO, SURVEY.md §7.4);
- request registry keyed by ``service_request_id`` with per-request output
  callbacks (scheduler.cpp:197-302);
- token fan-in through N single-thread pools with per-request pinning so
  token order is preserved (scheduler.h:113-120, via
  ``utils.misc.OrderedFanInPools``);
- master election: ``compare_create`` on ``XLLM:SERVICE:MASTER`` with a TTL
  lease + keepalive; replicas watch the key and take over on expiry
  (scheduler.cpp:25-66, 158-175); the master uploads aggregated load
  metrics and the KV-cache index every ``master_upload_interval_s``
  (scheduler.cpp:138-146).
"""

from __future__ import annotations

import logging
import os
import threading


import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.config import ServiceOptions
from xllm_service_tpu_torch.nlp.chat_template import ChatTemplate
from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.nlp.tokenizer import Tokenizer, TokenizerFactory
from xllm_service_tpu_torch.service.coordination import (
    KEY_EPOCH_PREFIX, KEY_MASTER, KEY_MASTER_ADDR, CoordinationStore)
from xllm_service_tpu_torch.service.instance_mgr import InstanceMgr
from xllm_service_tpu_torch.service.store_guard import (
    EpochFencedError, StoreGuard)
from xllm_service_tpu_torch.service.instance_types import (
    Heartbeat, RequestPhase)
from xllm_service_tpu_torch.service.kvcache_mgr import GlobalKVCacheMgr
from xllm_service_tpu_torch.service.lb_policy import create_policy
from xllm_service_tpu_torch.service.recovery import PoisonLedger
from xllm_service_tpu_torch.utils.hashing import image_digest, prompt_digest
from xllm_service_tpu_torch.utils.misc import OrderedFanInPools, short_uuid
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.threads import spawn
from xllm_service_tpu_torch.utils.types import (
    OutputCallback, Request, RequestOutput, Routing, Status, StatusCode)
from xllm_service_tpu_torch.utils.locks import make_lock

logger = logging.getLogger(__name__)


def _env_float(raw: Optional[str], default: float) -> float:
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class _TrackedRequest:
    __slots__ = ("request", "output_callback", "created",
                 "prefill_name", "decode_name", "prefill_done",
                 "num_generated", "delivered", "pending", "recovery")

    def __init__(self, request: Request,
                 output_callback: OutputCallback) -> None:
        self.request = request
        self.output_callback = output_callback
        self.created = time.monotonic()
        self.prefill_name = request.routing.prefill_name
        self.decode_name = request.routing.decode_name
        self.prefill_done = False
        self.num_generated = 0
        # Delivered-token ledger: token ids whose TEXT has reached the
        # client (choice 0), appended by handle_generation (RPC fan-in)
        # or note_delivered (ledger-aware relay). Mid-stream recovery
        # re-prefills prompt + this ledger as forced context, so the
        # continuation is exactly-once by construction
        # (docs/ROBUSTNESS.md). ``pending`` holds ids the detokenizer
        # is still holding back (UTF-8 / multi-token grapheme): their
        # text was NEVER sent, so on recovery they are left OUT of the
        # forced context and regenerated — counting them as delivered
        # would silently drop their text at the resume boundary.
        self.delivered: List[int] = []
        self.pending: List[int] = []
        # Recovery context (service/recovery.py arms it): owner
        # ("relay"|"rpc"), the rewritten forward body + path needed to
        # resume, the per-request resume budget, and progress flags.
        # None = not recoverable; fail_requests_on_instance cancels.
        self.recovery: Optional[Dict[str, Any]] = None


class Scheduler:
    def __init__(self, opts: ServiceOptions, store: CoordinationStore,
                 control=None,
                 model_memory_gb: Optional[Dict[str, float]] = None,
                 serverless_models: Optional[List[str]] = None,
                 events=None) -> None:
        self.opts = opts
        self.store = store
        self.service_id = f"service-{short_uuid(8)}"
        # Decision-attributable observability (all optional — standalone
        # schedulers in unit tests run without them): the cluster event
        # log (obs.EventLog, shared with InstanceMgr/HttpService), and
        # the service plane's span ring + registry, wired by Master
        # AFTER HttpService exists so routing audits land on the
        # request's span and in xllm_schedule_decisions_total.
        self.events = events
        self.spans = None
        self.obs = None
        # Mid-stream failover (service/recovery.py, wired by HttpService
        # post-construction like spans/obs): when set,
        # fail_requests_on_instance hands recoverable RPC-mode requests
        # to it instead of cancelling, and relay-owned recoverable
        # requests are left to their relay generator's own resume loop.
        self.recovery = None
        # Poison ledger (service/recovery.py PoisonLedger): cluster-wide
        # engine-fault strikes keyed by request id AND prompt digest.
        # note_engine_fault() is the single strike point for every
        # response topology (docs/ROBUSTNESS.md).
        self.poison = PoisonLedger()

        self.tokenizer: Tokenizer = TokenizerFactory.create_tokenizer(
            opts.tokenizer_path)
        self.chat_template = ChatTemplate.from_model_dir(opts.tokenizer_path)

        # --- leader election (scheduler.cpp:25-66) -----------------------
        # Election triple: the role flag plus the fenced epochs
        # (docs/ROBUSTNESS.md). ``epoch`` is the monotonic epoch THIS
        # replica minted when it last won an election (0 = never won);
        # ``_cluster_epoch`` is the highest epoch observed anywhere. A
        # master whose epoch trails the cluster's has been deposed and
        # must demote, never write.
        self._elect_mu = make_lock("scheduler.elect", 88)
        self.is_master = False       # guarded-by: scheduler.elect
        self.epoch = 0               # guarded-by: scheduler.elect
        self._cluster_epoch = 0      # guarded-by: scheduler.elect
        self._lease_id = store.lease_grant(
            max(3 * opts.heartbeat_interval_s, 3.0))
        won = store.compare_create(
            KEY_MASTER, self.service_id, self._lease_id)
        epoch = self._mint_epoch() if won else self._read_cluster_epoch()
        with self._elect_mu:
            self.is_master = won
            if won:
                self.epoch = epoch
            self._cluster_epoch = max(self._cluster_epoch, epoch)
        self._master_watch: Optional[int] = None  # guarded-by: scheduler.elect
        self._epoch_watch: Optional[int] = store.add_watch(
            KEY_EPOCH_PREFIX, self._on_epoch_event)
        if not won:
            self._master_watch = store.add_watch(
                KEY_MASTER, self._on_master_event)
        elif self.events is not None:
            self.events.emit("master_elected", service_id=self.service_id,
                             how="boot", epoch=epoch)
        # Store-guard integration (service/store_guard.py): fence every
        # master-authored write against a higher observed epoch, and
        # resync + maybe self-demote the moment an outage heals. Raw
        # stores (standalone schedulers in unit tests) skip both.
        if isinstance(store, StoreGuard):
            store.fence_check = self._fenced
            store.on_heal(self._on_store_heal)

        self.instance_mgr = InstanceMgr(
            opts, store, is_master=self.is_master, control=control,
            model_memory_gb=model_memory_gb,
            serverless_models=serverless_models, events=self.events)
        self.kvcache_mgr = GlobalKVCacheMgr(
            store, block_size=opts.block_size, seed=opts.murmur_hash3_seed,
            is_master=self.is_master)
        self.instance_mgr.on_removed = self._on_instance_removed
        self.lb_policy = create_policy(opts, self.instance_mgr,
                                       self.kvcache_mgr)

        # Fetch-vs-recompute cost model knobs (docs/KV_CACHE.md). Read
        # once at construction — the planner runs per request. Direct
        # os.environ reads with literal names so the flag-registry
        # xlint rule sees every one.
        self.kv_fetch_enabled = os.environ.get(
            "XLLM_KV_FETCH", "1").strip() not in ("0", "false", "no")
        # Fallbacks for the measured terms when no signal arrived yet:
        # per-pair bandwidth (GB/s; 1.0 ≈ a measured direct migration
        # rate) and prefill throughput (tok/s).
        self.kv_fetch_gbps_default = _env_float(
            os.environ.get("XLLM_KV_FETCH_GBPS"), 1.0)
        self.kv_fetch_toks_default = _env_float(
            os.environ.get("XLLM_KV_FETCH_TOKS"), 4000.0)
        # Fixed per-fetch overhead (handshake + scatter) and the minimum
        # fetched-block count worth that overhead.
        self.kv_fetch_overhead_ms = _env_float(
            os.environ.get("XLLM_KV_FETCH_OVERHEAD_MS"), 5.0)
        self.kv_fetch_min_blocks = int(_env_float(
            os.environ.get("XLLM_KV_FETCH_MIN_BLOCKS"), 1))

        self._addresses: Optional[Dict[str, str]] = None
        # Tracked-request registry: every mutation site (admission,
        # fan-in delivery, finish, recovery retarget) holds _req_lock.
        self._requests: Dict[str, _TrackedRequest] = {}  # guarded-by: scheduler.req
        self._req_lock = make_lock("scheduler.req", 10)
        self._pools = OrderedFanInPools(opts.num_output_pools)

        self._stop = threading.Event()
        # Supervised + restarted: the master keepalive loop IS the
        # replica's claim to the master lease — a crashed loop means a
        # spurious failover. events resolves lazily (the EventLog is
        # attached by Master post-construction).
        self._hb_thread = spawn(
            "scheduler.master_loop", self._master_loop,
            thread_name="scheduler-master-loop",
            restart=threads.RESTART_POLICY,
            events=lambda: self.events, stop=self._stop)
        self._hb_thread.start()

    # ------------------------------------------------------------------
    # Election / master loop
    # ------------------------------------------------------------------
    def _mint_epoch(self) -> int:
        """Mint the next monotonic master epoch: compare_create on
        ``XLLM:SERVICE:EPOCH:<n>`` (no lease — the ledger outlives every
        master) one past the highest existing entry. Loses the race →
        reads again and tries the next slot."""
        for _ in range(64):
            n = self._read_cluster_epoch() + 1
            if self.store.compare_create(KEY_EPOCH_PREFIX + str(n),
                                         self.service_id):
                return n
        raise RuntimeError("could not mint a master epoch in 64 tries "
                           "(epoch ledger churning?)")

    def _read_cluster_epoch(self) -> int:
        """Highest epoch in the store's ledger (0 when empty)."""
        best = 0
        for key in self.store.get_prefix(KEY_EPOCH_PREFIX):
            try:
                best = max(best, int(key[len(KEY_EPOCH_PREFIX):]))
            except ValueError:
                continue
        return best

    def current_epoch(self) -> int:
        """The epoch stamped on beat-acks and ``/rpc/config`` — workers
        reject acks that regress (runtime/worker.py)."""
        with self._elect_mu:
            return self.epoch if self.is_master else self._cluster_epoch

    def _fenced(self) -> bool:
        """Store-guard write fence: True = this replica believes it is
        master but a higher epoch exists → every write must be rejected
        (EpochFencedError) until it demotes."""
        with self._elect_mu:
            return self.is_master and self._cluster_epoch > self.epoch

    def _become_master(self, how: str) -> None:
        """Post-``compare_create``-win bookkeeping: mint the fencing
        epoch, then flip the role triple under the elect lock (store
        ops first, lock second — the lock never spans a store call)."""
        epoch = self._mint_epoch()
        with self._elect_mu:
            self.is_master = True
            self.epoch = epoch
            self._cluster_epoch = max(self._cluster_epoch, epoch)
            self.instance_mgr.is_master = True
            self.kvcache_mgr.is_master = True
        self._publish_addresses()
        if self.events is not None:
            self.events.emit("master_elected", service_id=self.service_id,
                             how=how, epoch=epoch)

    def _demote(self, how: str, cluster_epoch: Optional[int] = None) -> bool:
        """Stop being master (lost re-election, or fenced by a higher
        epoch). Returns False if we already weren't."""
        with self._elect_mu:
            if cluster_epoch is not None:
                self._cluster_epoch = max(self._cluster_epoch,
                                          cluster_epoch)
            if not self.is_master:
                return False
            my_epoch = self.epoch
            observed = self._cluster_epoch
            self.is_master = False
            self.instance_mgr.is_master = False
            self.kvcache_mgr.is_master = False
        if self.events is not None:
            self.events.emit("master_demoted", service_id=self.service_id,
                             how=how, epoch=my_epoch,
                             cluster_epoch=observed)
        logger.warning("%s demoted (%s): epoch %d vs cluster %d",
                       self.service_id, how, my_epoch, observed)
        try:
            self._ensure_master_watch()
        except Exception as e:  # noqa: BLE001 — store flapping; the next
            # heal/takeover path re-adds the watch
            logger.warning("re-adding master watch failed: %s", e)
        return True

    def _ensure_master_watch(self) -> None:
        """Re-add the KEY_MASTER vacancy watch if absent. The
        ``add_watch`` store call runs OUTSIDE scheduler.elect (store
        locks rank below it); the double-check under the lock cancels
        the loser when two demote paths race (epoch-watch thread vs
        master loop)."""
        with self._elect_mu:
            if self._master_watch is not None:
                return
        wid: Optional[int] = self.store.add_watch(
            KEY_MASTER, self._on_master_event)
        with self._elect_mu:
            if self._master_watch is None:
                self._master_watch = wid
                wid = None
        if wid is not None:
            try:
                self.store.cancel_watch(wid)
            except Exception:  # noqa: BLE001 — duplicate watch is benign
                pass

    def _on_epoch_event(self, event) -> None:
        """Epoch-ledger watch (all replicas): track the cluster's
        highest epoch; a master seeing a HIGHER one has been deposed
        (another replica won an election it couldn't see) and
        self-demotes instead of dual-serving."""
        ev_type, key, _value = event
        if ev_type != "PUT":
            return
        try:
            n = int(key[len(KEY_EPOCH_PREFIX):])
        except ValueError:
            return
        with self._elect_mu:
            self._cluster_epoch = max(self._cluster_epoch, n)
            deposed = self.is_master and self._cluster_epoch > self.epoch
        if deposed:
            self._demote(how="higher-epoch")

    def _on_store_heal(self) -> None:
        """Store-guard heal callback, run synchronously on the thread
        whose call healed the outage and BEFORE that call returns: a
        deposed master demotes before it can author a single stale
        write, and the instance books resync against what actually
        happened in the store while we were blind."""
        if self._stop.is_set():
            return
        try:
            cluster = self._read_cluster_epoch()
        except Exception as e:  # noqa: BLE001 — store flapping mid-heal;
            # the next successful call re-runs this path
            logger.warning("post-heal epoch read failed: %s", e)
            return
        with self._elect_mu:
            self._cluster_epoch = max(self._cluster_epoch, cluster)
            deposed = self.is_master and self._cluster_epoch > self.epoch
        if deposed:
            self._demote(how="healed-behind")
        try:
            self.instance_mgr.resync_from_store()
        except Exception as e:  # noqa: BLE001 — resync is re-runnable;
            # heartbeats keep the books converging meanwhile
            logger.warning("post-heal instance resync failed: %s", e)

    @property
    def degraded(self) -> bool:
        """True while the coordination store is DOWN and this replica is
        serving from the frozen last-known-good instance table."""
        return bool(getattr(self.store, "is_down", False))

    def store_health(self) -> int:
        """The ``xllm_store_health`` gauge value (2/1/0; raw stores
        report healthy)."""
        h = getattr(self.store, "health", None)
        return 2 if h is None else int(h)

    def _on_master_event(self, event) -> None:
        ev_type, _key, _value = event
        if ev_type != "DELETE" or self._stop.is_set():
            return
        # Master lease expired → try to take over (scheduler.cpp:158-175).
        try:
            won = self.store.compare_create(KEY_MASTER, self.service_id,
                                            self._lease_id)
            if won:
                self._become_master(how="takeover")
                logger.info("%s took over as master", self.service_id)
        except Exception as e:  # noqa: BLE001 — store outage mid-takeover;
            # the next master-key DELETE (or heal) retries the election
            logger.warning("master takeover attempt failed: %s", e)

    def announce(self, rpc_addr: str, http_addr: str) -> None:
        """Record this replica's reachable addresses; the current master
        publishes them under ``KEY_MASTER_ADDR`` (its lease) so workers
        retarget heartbeats/pushes after a takeover."""
        self._addresses = {"service_id": self.service_id,
                           "rpc": rpc_addr, "http": http_addr}
        if self.is_master:
            self._publish_addresses()

    def _publish_addresses(self) -> None:
        if getattr(self, "_addresses", None):
            try:
                # Epoch-stamped master-authored write: workers ignore an
                # advert regressing below the epoch they've acked.
                self.store.put_json(
                    KEY_MASTER_ADDR,
                    dict(self._addresses, epoch=self.current_epoch()),
                    self._lease_id)
            except Exception as e:  # noqa: BLE001 — store hiccup; retried
                logger.warning("publish master addr failed: %s", e)

    def _on_lease_lost(self) -> None:
        """Keepalive said the lease is gone (partition outlived the TTL):
        whatever we were, that identity is dead. Grant a fresh lease, try
        to win the (possibly vacant) election; otherwise demote — a stale
        master must NOT keep writing LOADMETRICS/CACHE alongside the
        takeover master (split-brain)."""
        if self.is_master and self.store.get(KEY_MASTER) == self.service_id:
            # Keepalive can return False on a transport blip (e.g. the
            # etcd gateway 502ing one call) while the lease is actually
            # alive. If we still own the master key, the lease has NOT
            # expired (expiry deletes the key) — don't self-demote over
            # one bad RPC; a genuine expiry shows up next tick as a
            # deleted/foreign key.
            return
        was_master = self.is_master
        if self.events is not None:
            self.events.emit("master_lease_lost",
                             service_id=self.service_id,
                             was_master=was_master)
        self._lease_id = self.store.lease_grant(
            max(3 * self.opts.heartbeat_interval_s, 3.0))
        if self.store.compare_create(KEY_MASTER, self.service_id,
                                     self._lease_id):
            # Winning mints a FRESH epoch even when we were master
            # before the expiry — any replica that took over in between
            # sits at a lower epoch now and fences itself out.
            self._become_master(how="re-elected")
            if was_master:
                logger.warning("%s lease expired but election was vacant; "
                               "re-elected with a fresh lease",
                               self.service_id)
        else:
            if not self._demote(how="lost-re-election"):
                # Already a replica (watch may have died with a store
                # reconnect) — just make sure we hear the next vacancy
                # (_demote re-adds it itself on a real demotion).
                self._ensure_master_watch()
            if was_master:
                logger.warning(
                    "%s demoted: lease expired and %s took over",
                    self.service_id, self.store.get(KEY_MASTER))

    def _degraded_tick(self) -> None:
        """One master-loop tick while the store is DOWN: keep serving
        from the frozen last-known-good table, with liveness judged by
        the direct worker→master heartbeats that still flow during a
        store-only outage. Only an instance that stopped BEATING for a
        full lease TTL is dropped — lease expiry is frozen and is not
        evidence of death (docs/ROBUSTNESS.md outage contract)."""
        if not self.is_master:
            return
        ttl = max(3 * self.opts.heartbeat_interval_s, 3.0)
        for name in self.instance_mgr.stale_instances(ttl):
            logger.warning("degraded mode: %s silent for > %.1fs of "
                           "direct beats, removing", name, ttl)
            self.instance_mgr.remove_instance(name)

    def _master_loop(self) -> None:
        """Keepalive + periodic state upload (scheduler.cpp:138-146)."""
        interval = self.opts.master_upload_interval_s
        while not self._stop.wait(interval):
            # The keepalive runs in its own try: an EXCEPTION means the
            # store is unreachable (outage — hold the role, freeze the
            # table, serve degraded), while a clean False means the
            # store is healthy and says the lease is dead (expiry —
            # re-run the election). Collapsing the two is how a store
            # hiccup used to turn into a spurious failover.
            try:
                with profiler.section("store.call"):
                    lease_alive = self.store.lease_keepalive(
                        self._lease_id)
            except Exception as e:  # noqa: BLE001 — outage; the guard
                # tracks health and fires the heal callback later
                logger.debug("keepalive unreachable (store outage?): %s", e)
                self._degraded_tick()
                continue
            try:
                if not lease_alive:
                    self._on_lease_lost()
                if self.instance_mgr.post_heal_resync_due():
                    # Settle window over: reconcile the DELETEs the
                    # post-heal deferral skipped (instance_mgr).
                    self.instance_mgr.resync_from_store(settle=False)
                if self.is_master:
                    self.instance_mgr.upload_load_metrics()
                    self.kvcache_mgr.upload_kvcache()
                    # Self-heal the address advertisement (lost store
                    # write, or the key expired with a previous lease).
                    if self._addresses is not None \
                            and self.store.get(KEY_MASTER_ADDR) is None:
                        self._publish_addresses()
            except EpochFencedError:
                # The guard refused a write because a higher epoch
                # exists: we are deposed — demote NOW, don't retry.
                self._demote(how="fenced-write")
            except Exception as e:  # noqa: BLE001 — store hiccup, retry next tick
                logger.warning("master loop error: %s", e)

    # ------------------------------------------------------------------
    # schedule (scheduler.cpp:70-131)
    # ------------------------------------------------------------------
    def preprocess(self, request: Request) -> None:
        """Chat template + tokenize (fills prompt/token_ids/mm_inputs)."""
        with profiler.section("tokenize"):
            if request.messages and not request.prompt:
                prompt, mm = self.chat_template.apply(request.messages)
                request.prompt = prompt
                if mm:
                    request.mm_inputs = mm
            if not request.token_ids and request.prompt:
                request.token_ids = self.tokenizer.encode(request.prompt)

    def schedule(self, request: Request) -> Tuple[Status, Routing]:
        with profiler.section("schedule"):
            return self._schedule_impl(request)

    def _schedule_impl(self, request: Request) -> Tuple[Status, Routing]:
        if not request.service_request_id:
            request.service_request_id = f"req-{short_uuid()}"
        try:
            self.preprocess(request)
        except Exception as e:  # noqa: BLE001 — bad template/input is a 400
            return Status(StatusCode.INVALID_ARGUMENT, str(e)), Routing()
        if not request.token_ids:
            return Status(StatusCode.INVALID_ARGUMENT,
                          "empty prompt"), Routing()
        # Poison-pill quarantine (docs/ROBUSTNESS.md, device-plane
        # fault contract): an identical prompt already crossed
        # XLLM_POISON_STRIKES engine-fault blames — refuse here, AFTER
        # preprocess (the digest is over the post-template token ids,
        # the same ids note_engine_fault strikes on), instead of
        # letting a retry restart the rampage worker by worker.
        if self.quarantined_digest(request.token_ids):
            return Status(StatusCode.INTERNAL,
                          "request quarantined: an identical prompt "
                          "repeatedly faulted the engine "
                          "(engine_fault, XLLM_POISON_TTL_S)"), Routing()

        if request.model:
            self.instance_mgr.update_model_heat(request.model)

        # Per-decision audit: the policy fills in the candidates it
        # considered, each candidate's score terms, and the winner;
        # _record_decision attaches it to the request's span and bumps
        # xllm_schedule_decisions_total{policy,reason}.
        audit: Dict[str, Any] = {}
        # Serverless multi-model path: the target must have the model awake
        # (scheduler.cpp:100-119 → instance_mgr.cpp:1087-1185).
        if request.model and self.instance_mgr.serverless_models:
            name = self.instance_mgr.get_awake_instance(request.model)
            how = "awake"
            if name is None:
                name = self.instance_mgr.allocate_instance_for_model(
                    request.model)
                how = "allocated"
            audit.update(policy="serverless", model=request.model,
                         reason=how if name else "no_instance",
                         prefill={"winner": name},
                         decode={"winner": name})
            if name is None:
                self._record_decision(request, audit)
                return Status(StatusCode.UNAVAILABLE,
                              f"no instance for model {request.model}"
                              ), Routing()
            routing = Routing(prefill_name=name, decode_name=name)
        else:
            prefill, decode = self.lb_policy.select_instances_pair(
                request.token_ids, audit=audit)
            if prefill is None:
                audit.setdefault("reason", "no_instance")
                self._record_decision(request, audit)
                return Status(StatusCode.UNAVAILABLE,
                              "no prefill instance available"), Routing()
            routing = Routing(prefill_name=prefill,
                              decode_name=decode or prefill)
        # Cross-worker cached-block fetch plan: when the placed prefill
        # target is not the (best) holder of this prompt's cached
        # prefix, decide fetch / partial-fetch / recompute on the
        # measured cost terms; the decision and both terms land in the
        # routing audit (attrs.schedule_decision) so wins are
        # attributed, not asserted.
        if not request.mm_inputs:
            routing.kv_fetch = self._plan_kv_fetch(
                request.token_ids, routing.prefill_name, audit,
                model=request.model)
        else:
            # EPD: cost-aware encode pick (queue depth + measured encode
            # ms + embed-cache hit credit from heartbeats — docs/EPD.md).
            # BEFORE _record_decision so the pick's terms land in the
            # schedule_decision audit like every other routing choice.
            # Same seed as the workers' embed caches — a seed mismatch
            # only mis-estimates cache hits, never correctness (the
            # worker re-digests with its own seed).
            digests = [image_digest(m, self.opts.murmur_hash3_seed)
                       for m in request.mm_inputs]
            enc, fallbacks = self.instance_mgr.select_encode_instance(
                digests, audit=audit)
            if enc:
                routing.encode_name = enc
                routing.encode_fallbacks = fallbacks
        self._record_decision(request, audit)

        request.routing = routing
        self.instance_mgr.update_request_metrics(
            routing.prefill_name, RequestPhase.SCHEDULE,
            len(request.token_ids))
        return Status(), routing

    # Tier-dependent effective-rate discount on the fetch term: HBM and
    # DRAM blocks stream at the measured wire rate (the holder gathers /
    # reads host RAM); SSD blocks pay the holder's disk read first.
    _FETCH_TIER_RATE = {"hbm": 1.0, "dram": 1.0, "ssd": 0.25}

    def _count_fetch_verdict(self, verdict: str) -> None:
        if self.obs is not None:
            self.obs.counter(
                "xllm_kv_fetch_decisions_total",
                "fetch-vs-recompute planner outcomes for prompts with a "
                "nonzero cluster prefix match (docs/KV_CACHE.md)",
                labelnames=("verdict",)).inc(verdict=verdict)

    def _plan_kv_fetch(self, token_ids: List[int], prefill_name: str,
                       audit: Dict[str, Any], model: str = ""
                       ) -> Optional[Dict[str, Any]]:
        """Fetch-vs-recompute cost model (NetKV-style bandwidth-aware
        choice; PAPERS.md 2606.03910): matched tokens ÷ measured prefill
        tok/s (recompute) vs matched bytes ÷ measured per-pair bandwidth
        (fetch), per block so a tier change mid-prefix can cut the fetch
        short (partial). Returns the Routing.kv_fetch plan, or None for
        recompute / local-hit / nothing-cached. Observe-only beyond the
        plan: the audit gains ``kv_fetch`` with the verdict and both
        cost terms. Reuses the cache-aware policy's index walk when the
        audit carries one (``_match_tiers``) — one prefix match per
        schedule(), not two."""
        if not self.kv_fetch_enabled or not prefill_name \
                or not token_ids:
            return None
        if not self.instance_mgr.digest_ok(prefill_name):
            # The TARGET's hashing is quarantined: any plan it executes
            # computes mismatched digests the holder can never serve —
            # a guaranteed 404 added to TTFT on every warm prompt.
            return None
        pre = audit.pop("_match_tiers", None)
        if pre is not None:
            matched, holders = pre
        else:
            matched, _scores, holders = \
                self.kvcache_mgr.match_prefix_tiers(token_ids)
        if not matched:
            return None         # cold prompt: no decision to attribute
        # The digest index is MODEL-BLIND (digests hash token ids only)
        # while KV bytes are model-specific: a holder is eligible only
        # when its PRIMARY model — the one whose engine feeds its cache
        # heartbeats — is the model this request runs (the target's
        # primary when the request names none). Same-shape fine-tunes
        # would otherwise swap KV silently.
        target_inst = self.instance_mgr.get(prefill_name)
        want_model = model or (
            target_inst.meta.models[0]
            if target_inst and target_inst.meta.models else "")
        if not want_model:
            return None
        # Liveness: a dead-but-lease-alive holder stalls the requester
        # for the whole fetch timeout (the mid-stream-recovery reroute
        # case) — on the master, whose heartbeat clock is live, skip
        # holders that stopped beating. Replicas learn load via the
        # master's uploads, not heartbeats, so their clock would lie.
        now = time.monotonic()
        stale_s = 3.0 * max(self.opts.heartbeat_interval_s, 0.1)
        local_blocks = len(holders.get(prefill_name, ()))
        best_name: Optional[str] = None
        best_tiers: List[str] = []
        for name, tiers in holders.items():
            if name == prefill_name or len(tiers) <= len(best_tiers):
                continue
            inst = self.instance_mgr.get(name)
            if inst is None or not inst.digest_compatible:
                continue
            if not (inst.meta.models
                    and inst.meta.models[0] == want_model):
                continue
            if self.is_master and now - inst.last_heartbeat > stale_s:
                continue
            best_name, best_tiers = name, list(tiers)
        bs = max(self.opts.block_size, 1)
        plan: Optional[Dict[str, Any]] = None
        terms: Dict[str, Any] = {
            "holder": best_name, "holder_blocks": len(best_tiers),
            "local_blocks": local_blocks, "matched_blocks": matched,
            "block_size": bs,
        }
        if best_name is None or len(best_tiers) <= local_blocks:
            verdict = "local" if local_blocks else "recompute"
            if verdict == "recompute":
                terms["reason"] = "no_remote_holder"
        else:
            holder_inst = self.instance_mgr.get(best_name)
            target_inst = self.instance_mgr.get(prefill_name)
            holder_addr = self.instance_mgr.address_of(best_name) or ""
            block_bytes = (holder_inst.meta.kv_block_bytes
                           if holder_inst else 0)
            # max() guards both terms: XLLM_KV_FETCH_GBPS=0 (or a
            # zeroed fallback) must degrade to an absurd fetch price —
            # i.e. verdict recompute — never a ZeroDivisionError inside
            # schedule().
            gbps = max((holder_inst.latency.kv_gbps
                        if holder_inst else 0.0)
                       or self.kv_fetch_gbps_default, 1e-9)
            tok_s = (target_inst.latency.prefill_tok_s
                     if target_inst else 0.0) or self.kv_fetch_toks_default
            recompute_ms_per_block = bs / max(tok_s, 1e-6) * 1e3
            terms.update(bandwidth_gbps=round(gbps, 3),
                         prefill_tok_s=round(tok_s, 1),
                         block_bytes=block_bytes)
            if not block_bytes or not holder_addr:
                verdict = "recompute"
                terms["reason"] = ("no_block_bytes" if not block_bytes
                                   else "holder_unreachable")
            else:
                # Walk the holder's surplus blocks; stop at the first
                # block whose (tier-discounted) fetch cost loses to
                # recomputing it.
                fetch_ms = 0.0
                n_fetch = 0
                for tier in best_tiers[local_blocks:]:
                    rate = self._FETCH_TIER_RATE.get(tier, 1.0)
                    blk_ms = block_bytes / (gbps * 1e9 * rate) * 1e3
                    if blk_ms >= recompute_ms_per_block:
                        break
                    fetch_ms += blk_ms
                    n_fetch += 1
                recompute_ms = n_fetch * recompute_ms_per_block
                terms.update(fetch_ms=round(
                    fetch_ms + self.kv_fetch_overhead_ms, 3),
                    recompute_ms=round(recompute_ms, 3))
                surplus = len(best_tiers) - local_blocks
                if n_fetch < self.kv_fetch_min_blocks or \
                        fetch_ms + self.kv_fetch_overhead_ms \
                        >= recompute_ms:
                    verdict = "recompute"
                    terms["reason"] = "fetch_loses"
                else:
                    verdict = "fetch" if n_fetch == surplus else "partial"
                    plan = {"holder": best_name,
                            "holder_addr": holder_addr,
                            "blocks": local_blocks + n_fetch,
                            "block_size": bs}
        terms["verdict"] = verdict
        audit["kv_fetch"] = terms
        self._count_fetch_verdict(verdict)
        return plan

    def _record_decision(self, request: Request,
                         audit: Dict[str, Any]) -> None:
        """Attach the routing audit to the request's span and aggregate
        the outcome. Observe-only: never influences the decision. A
        re-dispatch runs schedule() again and overwrites the span's
        ``schedule_decision`` with the decision that actually stuck (the
        ``redispatch`` stage event keeps the history)."""
        if not audit:
            return
        # Planner working state (popped there on the normal path; a
        # multimodal request skips the planner) — never span material.
        audit.pop("_match_tiers", None)
        if self.spans is not None:
            self.spans.annotate(request.service_request_id,
                                schedule_decision=audit)
        if self.obs is not None:
            self.obs.counter(
                "xllm_schedule_decisions_total",
                "routing decisions by policy and outcome",
                labelnames=("policy", "reason")).inc(
                policy=audit.get("policy", "unknown"),
                reason=audit.get("reason", "unknown"))

    # ------------------------------------------------------------------
    # Registry + token fan-in (scheduler.cpp:197-302, 329-372)
    # ------------------------------------------------------------------
    def record_new_request(self, request: Request,
                           output_callback: OutputCallback) -> None:
        tracked = _TrackedRequest(request, output_callback)
        with self._req_lock:
            self._requests[request.service_request_id] = tracked
        # Pin to a fan-in pool up front so ordering starts at token one.
        self._pools.pool_for(request.service_request_id)

    def handle_generation(self, out: RequestOutput,
                          source: str = "") -> None:
        """Per-token hot path: dispatch to the request's pinned pool.

        ``source`` is the pushing worker's name when the output arrived
        over the RPC fan-in — for recoverable requests it is the
        exactly-once guard: after a mid-stream resume retargets the
        request, a straggler push from the dead (or deposed) instance
        must not splice duplicate tokens into the stream."""
        srid = out.service_request_id or out.request_id
        with self._req_lock:
            tracked = self._requests.get(srid)
        if tracked is None:
            logger.debug("generation for unknown request %s", srid)
            return
        if tracked.recovery is not None and source and (
                source in tracked.recovery.get("failed", ())
                or source not in (tracked.prefill_name,
                                  tracked.decode_name)):
            # The failed-set check closes the pre-retarget window: a
            # resume marks the dead instance failed BEFORE snapshotting
            # the ledger, so a straggler push landing between snapshot
            # and retarget cannot be both delivered and regenerated.
            logger.warning("dropping %d stale output(s) for %s from "
                           "deposed instance %s",
                           len(out.outputs), srid, source)
            if self.obs is not None:
                self.obs.counter(
                    "xllm_stale_outputs_dropped_total",
                    "straggler generation pushes from deposed "
                    "instances dropped by the recovery source guard "
                    "(unit: pushes, not requests)").inc()
            return
        if out.status is not None \
                and out.status.code == StatusCode.INTERNAL \
                and (out.status.message or "").startswith("engine_fault"):
            # Device-plane fault verdict (worker fault boundary,
            # docs/ROBUSTNESS.md): strike the poison ledger. Below the
            # strike threshold an RPC-recoverable request is resumed on
            # a survivor instead of surfacing the fault; at the
            # threshold (or when not recoverable) the typed terminal
            # output falls through to the client.
            instance = source or tracked.decode_name \
                or tracked.prefill_name
            poisoned = self.note_engine_fault(
                srid, tracked.request.token_ids, instance,
                out.status.message)
            ctx = tracked.recovery
            if not poisoned and ctx is not None \
                    and self.recovery is not None \
                    and ctx.get("owner") == "rpc" \
                    and self.recovery.begin_rpc_resume(
                        tracked, instance):
                return
            self.count_failed("engine_fault")
        num_tokens = sum(len(s.token_ids) for s in out.outputs)
        if tracked.recovery is not None:
            with self._req_lock:
                for s in out.outputs:
                    if s.index == 0:
                        self._ledger_append_locked(
                            tracked, s.token_ids, bool(s.text))
                if out.usage is not None and \
                        tracked.recovery.get("recovered"):
                    # The resumed worker saw prompt + delivered tokens
                    # as its prompt and only the continuation as
                    # completion — restore the client-truthful counts.
                    out.usage.prompt_tokens = len(
                        tracked.request.token_ids)
                    out.usage.completion_tokens = (
                        len(tracked.delivered) + len(tracked.pending))
        tracked.num_generated += num_tokens
        decode_name = tracked.decode_name
        if decode_name:
            if not tracked.prefill_done:
                tracked.prefill_done = True
                self.instance_mgr.update_request_metrics(
                    tracked.prefill_name, RequestPhase.PREFILL_FINISH,
                    len(tracked.request.token_ids))
            self.instance_mgr.update_request_metrics(
                decode_name, RequestPhase.GENERATE, num_tokens)
        self._pools.submit(srid, lambda: self._deliver(tracked, out))

    def _deliver(self, tracked: _TrackedRequest,
                 out: RequestOutput) -> None:
        keep = True
        try:
            keep = tracked.output_callback(out)
        except Exception:  # noqa: BLE001 — client callback must not kill the pool
            keep = False
        if out.finished or out.cancelled or not keep:
            self.finish_request(
                tracked.request.service_request_id,
                cancelled=out.cancelled or not keep)

    def retarget_request(self, service_request_id: str,
                         routing: Routing) -> None:
        """Point a tracked request at its re-dispatched instances so
        finish/generation metrics drain the instance that actually does
        the work, not the one that refused it."""
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            if tracked is not None:
                tracked.prefill_name = routing.prefill_name
                tracked.decode_name = routing.decode_name

    def finish_request(self, service_request_id: str,
                       cancelled: bool = False) -> None:
        """Teardown (scheduler.cpp:304-327)."""
        with self._req_lock:
            tracked = self._requests.pop(service_request_id, None)
        if tracked is None:
            return
        self._pools.release(service_request_id)
        # Relay mode never sees per-token generations, so the SCHEDULE-phase
        # prefill increments must be drained here or the ledger grows
        # forever and starves the busiest instances under SLO routing.
        if not tracked.prefill_done and tracked.prefill_name:
            tracked.prefill_done = True
            self.instance_mgr.update_request_metrics(
                tracked.prefill_name, RequestPhase.PREFILL_FINISH,
                len(tracked.request.token_ids))
        phase = RequestPhase.CANCEL if cancelled \
            else RequestPhase.FINISH_DECODE
        name = tracked.decode_name or tracked.prefill_name
        if name:
            self.instance_mgr.update_request_metrics(
                name, phase, len(tracked.request.token_ids)
                + tracked.num_generated)

    def fail_requests_on_instance(self, instance: str) -> int:
        """Handle every tracked request routed to a dead instance.
        Recoverable requests (armed by service/recovery.py) are resumed
        mid-stream instead of cancelled: RPC-mode requests are handed to
        the recovery manager (re-prefill prompt + delivered ledger on a
        survivor), relay-owned requests are left alone (their relay
        generator sees the broken worker socket and runs its own resume
        loop). Everything else is cancelled promptly so clients get an
        error instead of hanging (the reference lacks both re-dispatch
        and recovery entirely, SURVEY.md §5.3)."""
        with self._req_lock:
            victims = [t for t in self._requests.values()
                       if instance in (t.prefill_name, t.decode_name)]
        for tracked in victims:
            ctx = tracked.recovery
            reason = "instance_died"
            if ctx is not None and self.recovery is not None:
                owner = ctx.get("owner")
                if owner == "relay":
                    continue
                if owner == "rpc":
                    if self.recovery.begin_rpc_resume(tracked, instance):
                        continue
                    # Resume budget exhausted: the client sees the
                    # error — that's the recoveries counter's "failed"
                    # contract, not a plain instance death.
                    self.recovery.note_failure(
                        tracked.request, instance, "budget_exhausted",
                        mode="rpc")
                    reason = "recovery_exhausted"
            self.count_failed(reason)
            self.cancel_request(
                tracked.request.service_request_id,
                f"instance {instance} died")
        return len(victims)

    def cancel_request(self, service_request_id: str,
                       message: str) -> None:
        """Deliver a terminal UNAVAILABLE output for one tracked request
        (the client's definite error; teardown follows through the
        normal _deliver → finish_request path)."""
        out = RequestOutput(
            request_id=service_request_id,
            service_request_id=service_request_id,
            status=Status(StatusCode.UNAVAILABLE, message),
            finished=True, cancelled=True)
        self.handle_generation(out)

    def count_failed(self, reason: str) -> None:
        """``xllm_requests_failed_total{reason}`` — failure modes stay
        countable before and after recovery (standalone schedulers run
        without a registry)."""
        if self.obs is not None:
            self.obs.counter(
                "xllm_requests_failed_total",
                "requests that hit a failure mode, by reason (a "
                "recovered request counts only under the recovery "
                "series, not here)",
                labelnames=("reason",)).inc(reason=reason)

    # ------------------------------------------------------------------
    # Poison-pill quarantine (docs/ROBUSTNESS.md device-plane faults)
    # ------------------------------------------------------------------
    def note_engine_fault(self, service_request_id: str,
                          token_ids: List[int], instance: str,
                          verdict: str) -> bool:
        """Record one engine-fault blame verdict against a request.

        Single strike point for every response topology (RPC push,
        relay stream, redispatch loop). Returns True when the request
        crossed ``XLLM_POISON_STRIKES`` and is now poisoned — callers
        must then fail it to the client instead of re-scheduling.
        Events/metrics are emitted outside the ledger lock."""
        digest = prompt_digest(token_ids, self.opts.murmur_hash3_seed)
        strikes, poisoned = self.poison.strike(
            service_request_id, digest)
        if self.events is not None:
            self.events.emit(
                "engine_fault", service_request_id=service_request_id,
                instance=instance, verdict=verdict, strikes=strikes)
        if poisoned:
            if self.obs is not None:
                self.obs.counter(
                    "xllm_requests_poisoned_total",
                    "requests failed to the client as poison pills "
                    "after repeated engine-fault blame verdicts "
                    "(strikes >= XLLM_POISON_STRIKES)").inc()
            if self.events is not None:
                self.events.emit(
                    "request_quarantined",
                    service_request_id=service_request_id,
                    digest=digest, strikes=strikes,
                    ttl_s=self.poison.ttl_s)
        return poisoned

    def quarantined_digest(self, token_ids: List[int]) -> bool:
        """True when the prompt's content digest is under quarantine —
        the admission gate refuses such requests outright for
        ``XLLM_POISON_TTL_S`` after a poisoning."""
        return self.poison.quarantined(
            prompt_digest(token_ids, self.opts.murmur_hash3_seed))

    # ------------------------------------------------------------------
    # Mid-stream recovery support (service/recovery.py drives these)
    # ------------------------------------------------------------------
    def arm_recovery(self, service_request_id: str,
                     ctx: Dict[str, Any]) -> None:
        """Attach a recovery context (owner/fwd/path/budget) to a
        tracked request — from then on handle_generation keeps its
        delivered-token ledger and fail_requests_on_instance recovers
        instead of cancelling."""
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            if tracked is not None:
                tracked.recovery = ctx

    @staticmethod
    def _ledger_append_locked(tracked: _TrackedRequest,
                              token_ids: List[int],
                              has_text: bool) -> None:
        """One delta into the delivered ledger. A delta WITH text
        flushes every held-back id first (the detokenizer's emitted
        text always covers the tokens it was holding); a delta without
        text parks its ids as pending — not yet client-visible, so not
        yet resumable-over."""
        if has_text:
            if tracked.pending:
                tracked.delivered.extend(tracked.pending)
                tracked.pending = []
            tracked.delivered.extend(token_ids)
        else:
            tracked.pending.extend(token_ids)

    def note_delivered(self, service_request_id: str,
                       token_ids: List[int],
                       has_text: bool = True) -> int:
        """Ledger append for the relay topology (the relay parses token
        ids out of the worker's ledger-extension frames). Returns the
        total delivered (text-flushed) count."""
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            if tracked is None:
                return 0
            self._ledger_append_locked(tracked, token_ids, has_text)
            return len(tracked.delivered)

    def delivered_snapshot(self, service_request_id: str) -> List[int]:
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            return list(tracked.delivered) if tracked is not None else []

    def resume_ledger(self, service_request_id: str) -> List[int]:
        """The forced-context snapshot for a resume: the delivered
        (text-flushed) ids. Pending held-back ids are ABANDONED — their
        text never reached the client, the survivor regenerates them —
        so they must not double-count when the continuation re-appends
        the same ids."""
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            if tracked is None:
                return []
            tracked.pending = []
            return list(tracked.delivered)

    def delivered_total(self, service_request_id: str) -> int:
        """Client-visible completion length so far: flushed + held ids
        (the usage-rewrite source for recovered streams)."""
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            if tracked is None:
                return 0
            return len(tracked.delivered) + len(tracked.pending)

    def recovery_ctx(self, service_request_id: str
                     ) -> Optional[Dict[str, Any]]:
        with self._req_lock:
            tracked = self._requests.get(service_request_id)
            return tracked.recovery if tracked is not None else None

    def num_tracked_requests(self, model: Optional[str] = None) -> int:
        """Tracked in-flight requests — optionally for one model (the
        bounded-admission per-model cap, http_service.py)."""
        with self._req_lock:
            if model is None:
                return len(self._requests)
            return sum(1 for t in self._requests.values()
                       if t.request.model == model)

    def tracked_requests_info(self) -> List[Dict[str, Any]]:
        """Flight-recorder view of the live request registry (the debug
        bundle's in-flight evidence): who is running where, for how
        long, and how far along."""
        now = time.monotonic()
        with self._req_lock:
            return [{"service_request_id": srid,
                     "age_s": round(now - t.created, 3),
                     "prefill": t.prefill_name,
                     "decode": t.decode_name,
                     "prefill_done": t.prefill_done,
                     "num_generated": t.num_generated,
                     "delivered_tokens": len(t.delivered),
                     "recovery": ({"owner": t.recovery.get("owner"),
                                   "resumes": t.recovery.get("resumes",
                                                             0),
                                   "recovered": t.recovery.get(
                                       "recovered", False)}
                                  if t.recovery is not None else None)}
                    for srid, t in self._requests.items()]

    def _on_instance_removed(self, name: str) -> None:
        self.kvcache_mgr.remove_instance(name)
        self.fail_requests_on_instance(name)

    # ------------------------------------------------------------------
    # Heartbeats (scheduler.cpp:148-156)
    # ------------------------------------------------------------------
    def handle_instance_heartbeat(self, hb: Heartbeat) -> bool:
        registered = self.instance_mgr.on_heartbeat(hb)
        if registered and hb.latency.encode_ms_samples \
                and self.obs is not None:
            # EPD encode SLO feed (docs/EPD.md): per-call tower
            # durations ride the beat; the service observes them into
            # the same histogram /metrics exports and the "encode"
            # objective judges (http_service._slo_snapshot).
            h = self.obs.histogram("xllm_service_encode_ms")
            for ms in hb.latency.encode_ms_samples[:64]:
                try:
                    h.observe(float(ms))
                except (TypeError, ValueError):
                    continue
        if registered and (hb.cache_stored or hb.cache_removed
                           or hb.cache_offloaded
                           or hb.cache_offloaded_ssd):
            if not self.instance_mgr.digest_ok(hb.name):
                # Quarantined block hashing (cache_digest_mismatch):
                # digests from this worker can never match service-side
                # digests — ingesting them would poison match scores.
                return registered
            self.kvcache_mgr.record_updated_kvcaches(
                hb.name,
                stored=[bytes.fromhex(h) for h in hb.cache_stored],
                removed=[bytes.fromhex(h) for h in hb.cache_removed],
                offloaded=[bytes.fromhex(h)
                           for h in hb.cache_offloaded],
                offloaded_ssd=[bytes.fromhex(h)
                               for h in hb.cache_offloaded_ssd])
        return registered

    # ------------------------------------------------------------------
    def pick_serving_instance(self) -> Optional[str]:
        """Direct instance pick for /v1/models and /metrics proxying —
        without a fake schedule() round-trip (fixes SURVEY.md §7.4 quirk)."""
        prefill, _ = self.instance_mgr.get_next_instance_pair()
        return prefill

    def stop(self) -> None:
        self._stop.set()
        self._hb_thread.join(timeout=5)
        self.instance_mgr.close()
        self.kvcache_mgr.close()
        for watch_id in (self._master_watch, self._epoch_watch):
            if watch_id is not None:
                try:
                    self.store.cancel_watch(watch_id)
                except Exception:  # noqa: BLE001 — store may already be gone
                    pass
        try:
            self.store.lease_revoke(self._lease_id)
        except Exception:  # noqa: BLE001 — store may already be gone
            pass
        self._pools.stop()
