"""Instance-plane value types: the registration record, the heartbeat
with its load and latency metrics, and the master's per-instance request
ledger.

A copy of the JAX package's ``service/instance_types.py``
(``InstanceMetaInfo``, ``LoadMetrics``, ``LatencyMetrics``,
``Heartbeat``, ``RequestMetrics``, ``RequestPhase``), so a master reads
this worker's registration and heartbeats as it reads the JAX worker's. They cross the coordination
store and the heartbeat RPC as JSON.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.config import InstanceType


@dataclasses.dataclass
class InstanceMetaInfo:
    """Registration record a worker writes under ``XLLM:<TYPE>:<name>``.

    ``cluster_ids``/``addrs``/``k_cache_ids``/``v_cache_ids``/``dp_size``
    keep the reference's KV-transfer brokerage contract (types.h:174-178):
    for the TPU worker, ``addrs`` are the worker KV-transfer endpoints and
    the cache ids name its preallocated per-layer KV page pools.
    """

    name: str = ""                      # "host:port" of the worker HTTP server
    rpc_address: str = ""               # where the service reaches the worker
    instance_type: InstanceType = InstanceType.DEFAULT
    models: List[str] = dataclasses.field(default_factory=list)
    # KV-transfer brokerage handles.
    cluster_ids: List[int] = dataclasses.field(default_factory=list)
    addrs: List[str] = dataclasses.field(default_factory=list)
    k_cache_ids: List[int] = dataclasses.field(default_factory=list)
    v_cache_ids: List[int] = dataclasses.field(default_factory=list)
    dp_size: int = 1
    # Profiling samples for the SLO TimePredictor (types.h:180-182):
    # ttft: [(num_tokens, ttft_ms)], tpot: [(batch, seq_len, tpot_ms)].
    ttft_profiling_data: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)
    tpot_profiling_data: List[Tuple[float, float, float]] = \
        dataclasses.field(default_factory=list)
    # Serverless memory accounting (GB) for the multi-model allocator.
    memory_budget_gb: float = 60.0
    # Block-hash contract advertisement (docs/KV_CACHE.md): the engine's
    # KV page size (tokens per content-addressed block) and murmur hash
    # seed. The service's GlobalKVCacheMgr keys on (block_size, seed) —
    # if a worker's pair diverges, its reported digests can NEVER match
    # service-side digests and cache-aware routing scores it on garbage;
    # InstanceMgr fails loud (event + log) on mismatch. 0 page_size =
    # not advertised (pre-contract worker).
    page_size: int = 0
    hash_seed: int = 0
    # Bytes of one content-addressed KV block (k+v, all layers) — the
    # fetch-vs-recompute cost model's bytes term.
    kv_block_bytes: int = 0
    # EPD encode-plane advertisement (docs/EPD.md): True when this
    # worker serves the vision tower as its own stage (dedicated ENCODE
    # workers, and encode-capable MIX workers). ``encode_image_size`` is
    # the fixed serve-time image grid side the tower was compiled for —
    # the requester needs it only for diagnostics (the mrope grid is
    # derived from the returned embeds), 0 = not advertised.
    encode_capable: bool = False
    encode_image_size: int = 0

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["instance_type"] = self.instance_type.value
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "InstanceMetaInfo":
        try:
            itype = InstanceType(d.get("instance_type", "DEFAULT"))
        except ValueError:
            itype = InstanceType.DEFAULT
        return cls(
            name=d.get("name", ""),
            rpc_address=d.get("rpc_address", d.get("name", "")),
            instance_type=itype,
            models=list(d.get("models", [])),
            cluster_ids=list(d.get("cluster_ids", [])),
            addrs=list(d.get("addrs", [])),
            k_cache_ids=list(d.get("k_cache_ids", [])),
            v_cache_ids=list(d.get("v_cache_ids", [])),
            dp_size=d.get("dp_size", 1),
            ttft_profiling_data=[tuple(x) for x in
                                 d.get("ttft_profiling_data", [])],
            tpot_profiling_data=[tuple(x) for x in
                                 d.get("tpot_profiling_data", [])],
            memory_budget_gb=d.get("memory_budget_gb", 60.0),
            page_size=int(d.get("page_size", 0) or 0),
            hash_seed=int(d.get("hash_seed", 0) or 0),
            kv_block_bytes=int(d.get("kv_block_bytes", 0) or 0),
            encode_capable=bool(d.get("encode_capable", False)),
            encode_image_size=int(d.get("encode_image_size", 0) or 0),
        )


@dataclasses.dataclass
class LoadMetrics:
    """Queue/cache pressure shipped in every heartbeat (types.h:81-115)."""

    waiting_requests: int = 0
    running_requests: int = 0
    kv_cache_usage: float = 0.0          # [0, 1]
    num_preemptions: int = 0
    # MoE capacity-dropped (token, expert) assignments since engine boot
    # (0 on dense models) — routing/ops visibility into quality pressure.
    moe_dropped_tokens: int = 0
    # EPD encode-plane pressure (docs/EPD.md): jobs waiting in the
    # worker's batched encode queue at heartbeat time — the cost-aware
    # encode pick's queue-depth term.
    encode_queue_depth: int = 0
    # Engine-loop liveness (docs/ROBUSTNESS.md, device-plane fault
    # contract): 1 while the worker's engine loop serves, 0 once the
    # fault breaker let it die — the watchdog opens an ``engine_dead``
    # anomaly on 0 instead of waiting for lease expiry.
    engine_alive: int = 1

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "LoadMetrics":
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class LatencyMetrics:
    """Recent max TTFT / inter-token latency (types.h:118-127), plus the
    worker's recent engine-step p99 (additive vs. the reference): the
    p99 of ``xllm_worker_step_ms`` over the samples since the previous
    heartbeat, computed worker-side from the same registry buckets the
    worker's /metrics exports. The service watchdog compares it against
    a per-instance rolling baseline to open ``step_ms_regression``
    anomalies. 0.0 = no steps ran in the interval (no signal)."""

    recent_max_ttft_ms: float = 0.0
    recent_max_tbt_ms: float = 0.0
    step_ms_p99: float = 0.0
    # Measured prefill throughput (tokens/s, cumulative over this
    # worker's prefill steps) — the fetch-vs-recompute cost model's
    # recompute-rate term. 0.0 = no prefill ran yet (no signal).
    prefill_tok_s: float = 0.0
    # Measured KV-transfer bandwidth (GB/s) from this worker's actual
    # migrations/probes — the cost model's fetch-rate term. 0.0 = never
    # measured (the service falls back to XLLM_KV_FETCH_GBPS).
    kv_gbps: float = 0.0
    # Prefill backlog at heartbeat time: prompt tokens queued on the
    # worker but not yet computed. The SLO-aware policy converts this
    # to milliseconds (via prefill_tok_s) inside its predicted-TTFT
    # term so prefill queueing can't hide behind a single global queue
    # (P/D-Serve backlog awareness).
    waiting_prefill_tokens: int = 0
    # EPD encode stage (docs/EPD.md): mean per-image encode ms over the
    # tower calls since the previous beat (0.0 = no encodes ran — the
    # cost-aware pick falls back to its prior), plus the raw per-call
    # durations (ms, bounded) the service observes into its
    # ``xllm_service_encode_ms`` histogram for the encode SLO objective.
    encode_ms: float = 0.0
    encode_ms_samples: List[float] = dataclasses.field(
        default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "LatencyMetrics":
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class Heartbeat:
    """Wire form of one worker heartbeat (xllm_rpc_service.proto
    HeartbeatRequest)."""

    name: str = ""
    instance_type: InstanceType = InstanceType.DEFAULT
    load: LoadMetrics = dataclasses.field(default_factory=LoadMetrics)
    latency: LatencyMetrics = dataclasses.field(default_factory=LatencyMetrics)
    # Prefix-cache delta: hex digests stored/removed since last beat.
    # ``cache_offloaded`` = spilled HBM→host-DRAM (still servable from
    # this worker, one tier down); ``cache_offloaded_ssd`` = demoted
    # DRAM→disk — the deltas that make the cluster index's DRAM/SSD
    # tier slots real (docs/KV_CACHE.md).
    cache_stored: List[str] = dataclasses.field(default_factory=list)
    cache_removed: List[str] = dataclasses.field(default_factory=list)
    cache_offloaded: List[str] = dataclasses.field(default_factory=list)
    cache_offloaded_ssd: List[str] = dataclasses.field(
        default_factory=list)
    # EPD embedding-cache delta (docs/EPD.md): hex image digests whose
    # encoded embeddings this worker gained/evicted since the last
    # beat. The instance manager folds them into its per-instance
    # digest books so the cost-aware encode pick can credit cache hits.
    embed_stored: List[str] = dataclasses.field(default_factory=list)
    embed_removed: List[str] = dataclasses.field(default_factory=list)
    # Per-model sleep/wake state for the serverless layer.
    model_states: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Finished request-span timelines since the last beat
    # ([{"request_id", "attrs", "events": [...]}], obs/spans.py): the
    # service merges them into its span ring under the same correlation
    # id, so /admin/trace/<id> shows worker-side stages too.
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # Step flight-recorder tail since the last delivered beat
    # (obs/steptrace.py STEP_FIELDS records): the master's StepBooks
    # dedupe on seq, so a re-shipped tail after a failed beat is safe.
    steps: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "instance_type": self.instance_type.value,
            "load": self.load.to_json(),
            "latency": self.latency.to_json(),
            "cache_stored": self.cache_stored,
            "cache_removed": self.cache_removed,
            "cache_offloaded": self.cache_offloaded,
            "cache_offloaded_ssd": self.cache_offloaded_ssd,
            "embed_stored": self.embed_stored,
            "embed_removed": self.embed_removed,
            "model_states": self.model_states,
            "spans": self.spans,
            "steps": self.steps,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Heartbeat":
        try:
            itype = InstanceType(d.get("instance_type", "DEFAULT"))
        except ValueError:
            itype = InstanceType.DEFAULT
        return cls(
            name=d.get("name", ""),
            instance_type=itype,
            load=LoadMetrics.from_json(d.get("load")),
            latency=LatencyMetrics.from_json(d.get("latency")),
            cache_stored=list(d.get("cache_stored", [])),
            cache_removed=list(d.get("cache_removed", [])),
            cache_offloaded=list(d.get("cache_offloaded", [])),
            cache_offloaded_ssd=list(d.get("cache_offloaded_ssd", [])),
            embed_stored=list(d.get("embed_stored", [])),
            embed_removed=list(d.get("embed_removed", [])),
            model_states=dict(d.get("model_states", {})),
            spans=list(d.get("spans", [])),
            steps=list(d.get("steps", [])),
            timestamp=d.get("timestamp", time.time()),
        )


@dataclasses.dataclass
class RequestMetrics:
    """Service-side in-flight ledger per instance (types.h:138-155,
    maintained like instance_mgr.cpp:745-817): what the SLO policy uses to
    estimate prefill backlog and decode load."""

    num_prefill_requests: int = 0
    num_prefill_tokens: int = 0
    num_decode_requests: int = 0
    num_decode_tokens: int = 0
    estimated_prefill_time_ms: float = 0.0
    estimated_ttft_ms: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class RequestPhase:
    """Request-metrics transition points (reference update_request_metrics
    call sites: SCHEDULE scheduler.cpp:127, PREFILL_FINISH :183-202,
    GENERATE :345, FINISH_DECODE/CANCEL :304-327)."""

    SCHEDULE = "schedule"
    # Exact reversal of SCHEDULE — used when a scheduled request is
    # re-dispatched to another instance before any work happened (the
    # failed instance must not keep phantom prefill backlog).
    UNSCHEDULE = "unschedule"
    PREFILL_FINISH = "prefill_finish"
    GENERATE = "generate"
    FINISH_DECODE = "finish_decode"
    CANCEL = "cancel"


@dataclasses.dataclass
class Heartbeat:
    """Wire form of one worker heartbeat (xllm_rpc_service.proto
    HeartbeatRequest)."""

    name: str = ""
    instance_type: InstanceType = InstanceType.DEFAULT
    load: LoadMetrics = dataclasses.field(default_factory=LoadMetrics)
    latency: LatencyMetrics = dataclasses.field(default_factory=LatencyMetrics)
    # Prefix-cache delta: hex digests stored/removed since last beat.
    # ``cache_offloaded`` = spilled HBM→host-DRAM (still servable from
    # this worker, one tier down); ``cache_offloaded_ssd`` = demoted
    # DRAM→disk — the deltas that make the cluster index's DRAM/SSD
    # tier slots real (docs/KV_CACHE.md).
    cache_stored: List[str] = dataclasses.field(default_factory=list)
    cache_removed: List[str] = dataclasses.field(default_factory=list)
    cache_offloaded: List[str] = dataclasses.field(default_factory=list)
    cache_offloaded_ssd: List[str] = dataclasses.field(
        default_factory=list)
    # EPD embedding-cache delta (docs/EPD.md): hex image digests whose
    # encoded embeddings this worker gained/evicted since the last
    # beat. The instance manager folds them into its per-instance
    # digest books so the cost-aware encode pick can credit cache hits.
    embed_stored: List[str] = dataclasses.field(default_factory=list)
    embed_removed: List[str] = dataclasses.field(default_factory=list)
    # Per-model sleep/wake state for the serverless layer.
    model_states: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Finished request-span timelines since the last beat
    # ([{"request_id", "attrs", "events": [...]}], obs/spans.py): the
    # service merges them into its span ring under the same correlation
    # id, so /admin/trace/<id> shows worker-side stages too.
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # Step flight-recorder tail since the last delivered beat
    # (obs/steptrace.py STEP_FIELDS records): the master's StepBooks
    # dedupe on seq, so a re-shipped tail after a failed beat is safe.
    steps: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "instance_type": self.instance_type.value,
            "load": self.load.to_json(),
            "latency": self.latency.to_json(),
            "cache_stored": self.cache_stored,
            "cache_removed": self.cache_removed,
            "cache_offloaded": self.cache_offloaded,
            "cache_offloaded_ssd": self.cache_offloaded_ssd,
            "embed_stored": self.embed_stored,
            "embed_removed": self.embed_removed,
            "model_states": self.model_states,
            "spans": self.spans,
            "steps": self.steps,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Heartbeat":
        try:
            itype = InstanceType(d.get("instance_type", "DEFAULT"))
        except ValueError:
            itype = InstanceType.DEFAULT
        return cls(
            name=d.get("name", ""),
            instance_type=itype,
            load=LoadMetrics.from_json(d.get("load")),
            latency=LatencyMetrics.from_json(d.get("latency")),
            cache_stored=list(d.get("cache_stored", [])),
            cache_removed=list(d.get("cache_removed", [])),
            cache_offloaded=list(d.get("cache_offloaded", [])),
            cache_offloaded_ssd=list(d.get("cache_offloaded_ssd", [])),
            embed_stored=list(d.get("embed_stored", [])),
            embed_removed=list(d.get("embed_removed", [])),
            model_states=dict(d.get("model_states", {})),
            spans=list(d.get("spans", [])),
            steps=list(d.get("steps", [])),
            timestamp=d.get("timestamp", time.time()),
        )
