"""Worker process: an OpenAI HTTP front over one engine on one device,
a member of the service's cluster.

The counterpart of the JAX package's ``runtime/worker.py``:

- ``GET /hello``, ``GET /v1/models``, ``GET /metrics`` (Prometheus text:
  load gauges, per-step series and the graphs captured per program,
  warmup included and after it, under the JAX worker's names);
- ``POST /v1/completions`` and ``POST /v1/chat/completions``, with
  ``stream`` true (SSE, ending in ``data: [DONE]``) or false. A request
  the master forwards carries its token ids and the service-parsed
  ``sampling``; a request sent straight here is tokenized here (chat
  messages joined by newlines, as the JAX worker does). The response
  and SSE chunk JSON come from the same assemblers;
- ``POST /cancel`` ``{"service_request_id"}``: ends a request in flight.

The cluster plane, as the JAX worker runs it: ``start()`` registers an
``InstanceMetaInfo`` under ``XLLM:<TYPE>:<name>`` in the coordination
store on a TTL lease (after the engine's warmup, which ``__init__``
runs), follows the master's advertised address (``XLLM:SERVICE:ADDR``),
and a heartbeat loop keeps the lease alive (re-registering when the
store says it is gone) and sends the master ``Heartbeat``s with the
engine's load, its recent step p99, its prefill rate and the prefix
cache's block digests stored, removed and offloaded since the last
acked beat (``cache_stored`` / ``cache_removed`` / ``cache_offloaded``
/ ``cache_offloaded_ssd``), which the master's cache-aware routing
scores. A beat that is not acknowledged keeps its digests for the
next. When the
service's ``/rpc/config`` asks for ``enable_decode_response_to_service``
(the RPC topology), a request's ``RequestOutput``s are pushed to the
master's ``/rpc/generations`` and its HTTP reply is only the ack;
otherwise the master relays this worker's SSE stream, whose chunks then
carry their token ids (``ledger_tokens`` on the forwarded body), so that
the master can resume a stream that breaks on another worker. Given neither
``store_addr`` nor ``service_addr``, the worker opens no store, registers
nowhere and sends no heartbeat: it serves requests sent straight to it.

One engine-loop thread owns the device and runs ``Engine.step()``; HTTP
handler threads queue requests to it under the engine lock and read
their outputs from a per-request queue.

The front door, as the JAX worker's (``service/httpd.py``): a ``Router``
of the JAX worker's paths behind ``HttpServer``, the native epoll server
(``csrc/xllm_httpd.cpp``, built with g++ at first use; a bounded pool of
handler threads) or, without its library or with
``XLLM_NATIVE_HTTPD=0``, the Python threaded server. Past
``WorkerOptions.max_concurrency`` (default 128, read live; 0 = no cap)
concurrent entry requests, the next is answered 503 with ``Retry-After:
1`` and ``overloaded_error`` before its body is read, which the master
re-dispatches to another worker; the control and continuation routes
(``ADMISSION_EXEMPT``) are never shed. ``/metrics`` names the server
(``xllm_worker_http_server{kind}``) and counts the shed requests
(``xllm_worker_http_rejected_total``). A request whose worker died
(``worker.die_after_n_tokens``) ends its connection with no complete
answer.

Every OpenAI sampling option is served as the JAX worker serves it:
``n`` choices (and ``best_of`` candidates, the ``n`` with the highest
mean token logprob kept by the non-streamed response) run as engine
requests ``<id>#k``, a seeded request's choice k with seed + k;
``echo`` prepends the prompt, and with ``logprobs`` its scores, computed
once by choice 0's prefill (the other choices' deltas are held until
they land); ``logprobs`` / ``top_logprobs`` (cut to the request's count,
at most ``EngineConfig.num_top_logprobs``), ``logit_bias`` (an id past
the vocabulary is a 400), the presence and frequency penalties and the
per-request ``seed`` are applied by the engine inside its steps.

A request body may mark the request ``offline`` (batch tier: queued
behind online requests, preempted first).

The cross-worker block fetch, as the JAX worker serves it. A request the
master routes here with a ``routing.kv_fetch`` plan (another worker holds
more of its prefix's blocks, and fetching them is priced below
recomputing them) first asks the holder for the planned leading blocks
that this worker's pools and host tier lack (``POST /kv/blocks``, bounded
by ``XLLM_KV_FETCH_TIMEOUT_S``, default 15 s) and adopts them
(``Engine.adopt_blocks``); the admission then hits them as a local
prefix. Any failure, ``worker.fail_kv_fetch`` included, is counted and
the request prefills from its own hit. As a holder, ``POST /kv/blocks
{"model", "hashes", "wire"}`` answers with the run's K/V
(``Engine.export_blocks``) as the meta line and bytes, or as a staged
CUDA IPC ticket that the requester pulls and acknowledges with ``POST
/kv/blocks_done {"uuid", "outcome"}``; tickets no requester acknowledged
within 60 s are released as leaked, at heartbeat cadence and at each
``/kv/blocks``. The model resolves strictly (404 for one not served
here); a run no longer held is a 404. The wire between the packages: a
JAX requester's ``"wire": true`` offers its PJRT wire, which cannot pull
a CUDA IPC ticket, so this holder stages only for an ask marked
``"wire": "cuda_ipc"`` (``FETCH_WIRE``), which only this package's
requesters send, and only to a holder in another process. A ticket the
requester cannot pull (a JAX holder's, or one of its own process) is
acknowledged ``nopull`` and the same fetch asks again for the bytes;
that holder is not offered the wire again (as ``_wire_refused`` does for
a PD decode peer). ``/metrics`` counts
``xllm_worker_kv_fetch_{attempts,failures,bytes}_total`` under the JAX
names, with the seconds of adopted fetches and of their adoption, those
over the wire, and the holder's requests served and export seconds
(``xllm_worker_kv_blocks_{served,export_seconds}_total``). The beat
carries ``kv_gbps``, the PD migrations' measured rate, which the master
prices fetches from this holder with.

``--enable-profiling`` (``WorkerOptions.enable_profiling``) measures the
JAX worker's TTFT/TPOT profile once on the warmed engine
(``service/time_predictor.profile_engine``) and puts the samples in every
registration (``ttft_profiling_data`` / ``tpot_profiling_data``), which
the master's SLO-aware policy fits its latency predictor from.

The engine step runs inside the JAX worker's fault boundary: an
exception from ``Engine.step()`` is classified (a timeout or a dropped
connection is transient and retried in place; anything else is
deterministic), the culprit is found by bisecting the faulting
section's requests in isolated probe steps (``XLLM_FAULT_BISECT_BUDGET``
probes), the blamed requests end with the typed ``engine_fault`` error
(an error frame or a 500; a pushed request gets a finished output with
an ``INTERNAL`` status) and the survivors are requeued with their tokens
and resume. The outputs of the sections that completed before the fault,
and of clean probes, reach their streams. More than
``XLLM_ENGINE_FAULT_LIMIT`` faults within ``XLLM_ENGINE_FAULT_WINDOW_S``
open the breaker: the engine loop dies and every request, then and
after, is refused with a 500. ``xllm_engine_faults_total{model,outcome}``
counts the outcomes.

Failpoints (``obs/failpoints.py``): ``XLLM_FAILPOINTS`` at construction,
``POST /admin/failpoint`` (``{"spec"}`` or ``{"name", "mode", "n",
"value"}``) and ``GET /admin/failpoints``. This worker fires
``worker.fault_step`` and ``worker.fault_step_req`` (a request whose
prompt holds the armed string, or every request, is marked at
admission; a step that holds a marked request faults) inside the step,
``worker.slow_response_ms``, ``worker.hang_rpc`` and
``worker.refuse_generate`` at the generate routes,
``worker.fail_kv_transfer`` in the PD handoff, ``worker.fail_kv_fetch``
in the block fetch, ``worker.drop_heartbeats`` and
``worker.crash_heartbeat`` (raised outside the tick's ``try``: the
supervised loop restarts) in the heartbeat loop, ``store.fail_rpc``,
``store.hang`` and ``store.partition`` in the store guard, and
``worker.die_after_n_tokens`` (after N tokens of outputs: a simulated
death) where the outputs are dispatched.

The lifecycle plane, as the JAX worker runs it. A worker holds one
``ModelRuntime`` per model (``runtimes``; the primary is
``WorkerOptions.model``). ``POST /fork_master {"models"}`` stages more
models asleep, ``POST /sleep {"model"}`` and ``POST /wakeup {"model"}``
flip one (the master's serverless allocator and ``/model/triggers``
drive them). A sleep drains the decode pipeline, copies the parameters
bit for bit into pinned host memory and drops the engine: its pools,
every captured graph with its private pool, and the prefix cache; the
freed memory goes back to the card. A wake copies them back (a cold
wake, with nothing parked, reads the model directory's weights, or
random-inits from seed 0 without them: a model staged by
``/fork_master``) and re-captures the worker's warmup ladder under the
engine lock. ``/fork_master`` stages any name of the JAX worker's
catalog (``_MODEL_REGISTRY``); a family this package lacks refuses at
its wake. The
engine loop steps every awake runtime; a request to a sleeping model is
a 400; a request in flight at its model's sleep ends with a 503 (the JAX
worker leaves it to its timeout). Registration lists the awake models
and ``memory_budget_gb``; every beat carries each model's state.
``drain_and_stop(timeout_s)`` beats every model ``draining`` until the
master acknowledges, then refuses new work with a 503 (a ``/wakeup`` with
a 409), lets the requests in flight finish and stops. The heartbeat loop
is a supervised thread (``utils/threads.py``): a crash is counted
(``xllm_thread_crashes_total{root}``), lands as ``thread_crashed`` in the
worker's event ring (``events``) and the loop restarts with backoff. The
store sits behind a ``StoreGuard`` (``service/store_guard.py``); its
heal makes the next tick re-register on a fresh lease and re-read the
advertised master.

PD disaggregation, as the JAX worker serves it: a request the master
routes here as its prefill worker with a ``routing.decode_name`` (one
choice, no ``best_of``, no ``echo``, ``max_tokens`` > 1) prefills with
``max_tokens=1`` and ``hold_after_finish``, and its KV moves to the
decode worker by the first transport that takes it: the co-hosted direct
path (a decode worker in this process, ``pd_direct_kv``: device tensors
end to end), the CUDA IPC device wire (``runtime/kv_wire.py``,
``pd_device_wire``: a ticket in the ``/kv/import`` meta line), the
chunked host shuttle (``/kv/chunk`` per span of layers, then a manifest)
or the monolithic host shuttle (meta line + K bytes + V bytes). The
decode worker answers ``POST /kv/import`` by adopting the sequence
(``Engine.import_sequence``) and streams its outputs back as
RequestOutput SSE frames, which this worker assembles for the client, or
pushes them to the service in the RPC topology. Any refusal decodes
locally (``worker.fail_kv_transfer`` forces it). A duplicate import of a
live request is answered idempotently. A migration carries a multimodal
sequence's embeddings, splice positions, rope streams and rope delta
(``_mm_meta``, the JAX worker's meta keys), so that the decode side keeps
it out of its prefix cache and can prefill it again after a preemption.
``POST
/flip_role {"instance_type"}`` re-registers the worker under its new
role. ``/metrics`` counts ``xllm_worker_kv_migration_{bytes,seconds,
direct,device_wire,chunked}_total``, and the device wire's staging
bytes, its stages refused for lack of a segment and its leaked segments
(``xllm_worker_kv_wire_{reserved_bytes,busy_total,leaked_total}``).

The step flight recorder (``obs/steptrace.py``): one record a step, with
the roofline verdict of the engine's analytic count against the
device's peaks (an H100 row, or the CPU placeholder), on ``GET
/admin/steptrace`` (``?n=`` / ``?seconds=``), and its newest 64 records
since the last acknowledged beat on each heartbeat; ``/metrics`` carries
``xllm_worker_step_mfu``, ``xllm_worker_step_debt_ms``,
``xllm_worker_program_flops`` / ``_bytes`` and ``xllm_worker_peak_flops``.

A model directory (``--model-dir``, ``WorkerOptions.model_dir``): its
``config.json`` names the model (any name, through
``ModelConfig.from_hf_config``), its tokenizer files the tokenizer, and
its ``*.safetensors`` shards the weights, read onto the device by
``runtime/checkpoint.py`` at boot and at a cold wake (random from seed 0
without them; ``ModelRuntime.timings`` says which, with the load's
seconds and bytes). ``GET /admin/weights?model=`` gives an awake model's
per-leaf sha256 digests.

The EPD multimodal path, as the JAX worker serves it. A generate body's
``mm_inputs`` (the master's image descriptors beside a prompt holding one
``<|image_pad|>`` per image) resolve to embeddings from the routed
ENCODE worker (``routing.encode_name``, then its ``encode_fallbacks``)
under one ``XLLM_ENCODE_TIMEOUT_S`` deadline, else from this worker's own
tower; every hop off the routed instance counts in
``xllm_encode_fallback_total{reason}`` and emits ``encode_fallback``.
Each placeholder becomes ``tokens_per_image`` image tokens whose
embeddings the engine splices, and an mrope model gets the prompt's 3-D
rope streams and delta (``runtime/multimodal.py``). ``POST /encode
{"images", "raw"}`` runs the tower through the batched encode queue
(``worker.fail_encode`` answers a 500, ``worker.hang_encode`` stalls the
handler first) and its content-addressed embedding cache
(``XLLM_EMBED_CACHE_CAP``, ``xllm_encode_cache_{hits,misses}_total``);
it answers the raw meta line and float32 bytes, or base64 JSON. The
tower is ``--model-dir``'s Qwen2-VL or Qwen2.5-VL (``visual.*``, resized
to ``XLLM_VISION_IMAGE_SIZE``, default 224), else the synthetic ViT from
seed 0. ``--role encode`` (``WorkerOptions.encode_only``) serves the
tower alone: the model sleeps, the worker registers as ENCODE with
``encode_capable`` and its image grid. Beats carry the encode queue's
depth, the recent encode ms and the embedding cache's digest delta.
``POST /v1/embeddings`` answers the mean-pooled, L2-normalized final
hidden states (``forward_embedding``), at most ``EMBED_MAX_TOKENS``
tokens an input. Between two processes of this package the embeddings
ride the CUDA IPC wire (``kv_wire.stage_one``): an ask marked ``"wire":
"cuda_ipc"`` gets a staged ticket, the requester pulls it and answers
``POST /encode_done {"uuid", "outcome"}``, and tickets no requester
acknowledged within 60 s are released as leaked, at heartbeat cadence
(``xllm_worker_encode_staged`` counts those held). A ticket the
requester cannot pull is acknowledged ``nopull`` and the same target
asked again for the bytes; a JAX requester gets bytes.

The observability and coordination plane, as the JAX worker runs it.
Each request's worker-plane span (``obs/spans.py``: ``received`` with
the master's ``x-xllm-request-id`` correlation header, ``encoded`` with
the encoding instance, ``scheduled``, ``first_token`` with the prefix
cache's hit tokens, ``faulted``, ``finished``; a PD decode side's
adoption is ``received`` and ``scheduled``) is drained once finished
onto the next beat and requeued unless that beat is delivered; the
master merges it at ``GET /admin/trace/<id>`` (``XLLM_SPAN_RING``, 2048,
sizes the ring; ``xllm_span_evictions_total``). The hot-path profiler
(``obs/profiler.py``: ``span.write``, ``event.emit``, ``sse.assemble``;
``XLLM_HOTPATH_PROFILE=0`` turns its timers off) answers
``/admin/steptrace``'s ``sections`` and puts its series on ``/metrics``
(``xllm_service_hotpath_*``, ``xllm_lock_*``,
``xllm_thread_cpu_seconds_total``, ``xllm_process_*``, ``xllm_gc_*``)
beside the keep-alive pool's. Every lock is named and ranked
(``utils/locks.py``; ``XLLM_LOCK_CHECK=1`` raises on an inversion,
``XLLM_LOCK_PROFILE_SAMPLE=N`` samples contention). The store is
``--store-addr``: a ``StoreServer`` at ``host:port``, or an etcd v3
JSON gateway at ``etcd://host:port`` (``service/etcd_store.py``; the
native ``csrc/xllm_etcd.cpp`` serves one), always behind the store
guard.

Run: ``python -m xllm_service_tpu_torch.runtime.worker --model llama3-1b``
or ``--model-dir <HF directory>`` (add ``--store-addr host:port`` or
``--store-addr etcd://host:port``, and ``--service-addr``, to join a
cluster).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import logging
import os
import queue
import secrets
import signal
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.config import (EngineConfig, InstanceType,
                                           ModelConfig)
from xllm_service_tpu_torch.models import qwen2vl_vision, vision
from xllm_service_tpu_torch.models.transformer import (Params,
                                                       forward_embedding)
from xllm_service_tpu_torch.nlp.tokenizer import (IncrementalDecoder,
                                                  Tokenizer,
                                                  TokenizerFactory)
from xllm_service_tpu_torch.obs import profiler, steptrace
from xllm_service_tpu_torch.obs.events import EventLog
from xllm_service_tpu_torch.obs.failpoints import Failpoints
from xllm_service_tpu_torch.obs.metrics import (Registry,
                                                quantile_from_buckets)
from xllm_service_tpu_torch.obs.spans import REQUEST_ID_HEADER, SpanStore
from xllm_service_tpu_torch.ops import kernels
from xllm_service_tpu_torch.runtime.engine import (Engine, EngineRequest,
                                                   StepOutput,
                                                   resolve_device)
from xllm_service_tpu_torch.parallel.mesh import (MeshSpec, default_backend,
                                                  make_mesh)
from xllm_service_tpu_torch.runtime import (checkpoint, kv_wire, multimodal,
                                            ranks)
from xllm_service_tpu_torch.runtime.kv_cache import (KvCacheEvent,
                                                     decode_kv_blob,
                                                     encode_kv_block)
from xllm_service_tpu_torch.runtime.kv_transfer import start_host_copies
from xllm_service_tpu_torch.service.coordination import (
    KEY_MASTER_ADDR, CoordinationStore, instance_prefix)
from xllm_service_tpu_torch.service.coordination_net import connect_store
from xllm_service_tpu_torch.service.httpd import (_ADMISSION_EXEMPT,
                                                  HttpServer, Request,
                                                  Response, Router,
                                                  flush_conn_pool_metrics,
                                                  http_json, http_stream,
                                                  http_stream_status,
                                                  iter_sse_events)
from xllm_service_tpu_torch.service.instance_types import (
    Heartbeat, InstanceMetaInfo, LatencyMetrics, LoadMetrics)
from xllm_service_tpu_torch.service.store_guard import (StoreGuard,
                                                       StoreOutageError)
from xllm_service_tpu_torch.service.time_predictor import profile_engine
from xllm_service_tpu_torch.service.response_handler import (
    SSE_DONE, ChatStreamAssembler, CompletionStreamAssembler,
    ResponseCollector, sse_frame)
from xllm_service_tpu_torch.utils import threads
from xllm_service_tpu_torch.utils.locks import make_lock
from xllm_service_tpu_torch.utils.retry import RetryPolicy
from xllm_service_tpu_torch.utils.types import (
    FinishReason, LogProb, RequestOutput, SamplingParams, SequenceOutput,
    Status, StatusCode, Usage, parse_openai_sampling, validate_sampling)
from xllm_service_tpu_torch.utils.wire import check_version, stamp

logger = logging.getLogger(__name__)

def _mm_meta(req: EngineRequest) -> Optional[Dict[str, Any]]:
    """A migration meta line's multimodal state (None for text): the
    embeddings, splice positions and mrope prompt streams (JAX worker
    :180-193)."""
    if req.mm_embeds is None:
        return None
    return {"embeds": multimodal.embeds_to_wire(req.mm_embeds),
            "positions": list(req.mm_positions or []),
            "rope_pos": (np.asarray(req.mm_rope_pos).tolist()
                         if req.mm_rope_pos is not None else None)}


_MODEL_REGISTRY = {
    # The JAX worker's catalog, name for name (its presets are copied in
    # ``config.ModelConfig``). A family whose layer body this package
    # lacks resolves all the same: its engine build raises
    # ``check_supported``'s NotImplementedError, at the wake, not at the
    # fork. vocab 512 >= the byte tokenizer's id range (256 bytes +
    # specials): an embedding lookup past the vocabulary raises in
    # PyTorch, so the tiny MoE differs from JAX's in its vocabulary.
    "tiny": lambda: ModelConfig.tiny(vocab_size=512),
    "llama3-1b": ModelConfig.llama3_1b,
    "llama3-8b": ModelConfig.llama3_8b,
    "qwen2-7b": ModelConfig.qwen2_7b,
    "qwen2.5-7b": ModelConfig.qwen25_7b,
    "qwen3-8b": ModelConfig.qwen3_8b,
    "qwen3-30b-a3b": ModelConfig.qwen3_30b_a3b,
    "phi3-mini": ModelConfig.phi3_mini,
    "mistral-7b": ModelConfig.mistral_7b,
    "mistral-7b-v01": ModelConfig.mistral_7b_v01,
    "gemma2-9b": ModelConfig.gemma2_9b,
    "gemma3-12b": ModelConfig.gemma3_12b,
    "deepseek-v2-lite": ModelConfig.deepseek_v2_lite,
    "deepseek-v3": ModelConfig.deepseek_v3,
    "gpt-oss-20b": ModelConfig.gpt_oss_20b,
    "mixtral-8x7b": ModelConfig.mixtral_8x7b,
    "tiny-moe": lambda: ModelConfig.tiny(vocab_size=512, num_experts=4),
}


# Workers of this process, by name: a PD handoff to one of them takes the
# direct path (device tensors end to end, no bytes on the wire).
_LOCAL_WORKERS: "weakref.WeakValueDictionary[str, Worker]" = \
    weakref.WeakValueDictionary()


def resolve_model_config(name: str, model_dir: str = "") -> ModelConfig:
    """The model a worker serves: the directory's ``config.json`` when it
    has one (any model, by the name given), else the catalog's preset
    (JAX worker :225-236)."""
    if model_dir:
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, "r", encoding="utf-8") as f:
                return ModelConfig.from_hf_config(json.load(f), name=name)
    factory = _MODEL_REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(_MODEL_REGISTRY)}")
    return factory()


@dataclasses.dataclass
class WorkerOptions:
    host: str = "127.0.0.1"
    port: int = 0
    model: str = "tiny"
    # A HuggingFace model directory: config.json (the model), the
    # tokenizer files and the *.safetensors weights (random from seed 0
    # without them). '' = the catalog's model and the byte tokenizer.
    model_dir: str = ""
    device: str = "cuda"
    # Capture the engine's graphs before serving (``warmup``); None = on
    # for a CUDA device.
    warmup: Optional[bool] = None
    # Bound on the wait for one engine output of a request.
    request_timeout_s: float = 600.0
    # The cluster plane (JAX worker runtime/worker.py:128-161).
    instance_type: InstanceType = InstanceType.DEFAULT
    service_addr: str = ""      # service RPC host:port for heartbeats
    store_addr: str = ""        # coordination store; '' = in-process
    heartbeat_interval_s: float = 3.0
    lease_ttl_s: Optional[float] = None   # None = 3 x the interval
    # Must equal the service's --murmur-hash3-seed (advertised as the
    # registration's hash_seed).
    murmur_seed: int = 0
    # PD handoff to a decode worker in this process: device tensors end
    # to end (off forces the HTTP transports, e.g. to test them).
    pd_direct_kv: bool = True
    # PD handoff and block fetch between processes over CUDA IPC
    # (runtime/kv_wire.py); without a GPU there is no wire and the
    # bytes go over HTTP.
    pd_device_wire: bool = True
    # Measure TTFT/TPOT samples on the warmed engine for the
    # registration (``service/time_predictor.profile_engine``).
    enable_profiling: bool = False
    # The device memory the master's serverless allocator may fill with
    # awake models here (registration's ``memory_budget_gb``).
    memory_budget_gb: float = 60.0
    # EPD dedicated encode mode (``--role encode``): the vision tower is
    # the worker's only program; the model starts asleep and the worker
    # registers as ENCODE.
    encode_only: bool = False
    # The front door's cap on concurrent entry requests (JAX worker
    # :139-142; 0 = none), read live: past it a /v1/* request gets a 503
    # with Retry-After, which the master re-dispatches elsewhere.
    max_concurrency: int = 128
    # The expert degree of the mesh (tp, dp and sp are the engine
    # config's): a mesh of several ranks is one process per rank
    # (``runtime/ranks.py``).
    ep: int = 1
    # A world the caller started, one process per rank (JAX worker
    # --dist-*): process 0 is this worker, every other process id runs
    # the follower loop. '' = this worker starts its other ranks itself.
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = -1
    # The collectives' backend: '' = nccl on CUDA, gloo on the CPU. Two
    # ranks on one card need gloo (NCCL refuses them).
    dist_backend: str = ""


class HttpError(Exception):
    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error") -> None:
        super().__init__(message)
        self.status = status
        self.err_type = err_type


class _Reply:
    """A route's answer: a JSON body with its status, an SSE stream
    (``frames``, closed by the handler however the client leaves) or
    octet-stream bytes (``data``)."""

    __slots__ = ("status", "body", "frames", "data")

    def __init__(self, status: int = 200,
                 body: Optional[Dict[str, Any]] = None,
                 frames: Optional[Iterator[bytes]] = None,
                 data: Optional[bytes] = None) -> None:
        self.status, self.body, self.frames = status, body, frames
        self.data = data

    @classmethod
    def error(cls, status: int, message: str,
              err_type: str = "invalid_request_error") -> "_Reply":
        return cls(status, {"error": {"message": message, "type": err_type,
                                      "code": status}})

    @classmethod
    def accepted(cls, srid: str) -> "_Reply":
        return cls(200, {"status": "accepted", "service_request_id": srid})

    @classmethod
    def sse(cls, frames: Iterator[bytes]) -> "_Reply":
        return cls(200, frames=frames)


class _StopWatcher:
    """OpenAI ``stop`` string matching with holdback: ``feed`` returns
    only text that cannot be the start of a stop string and flags
    ``stopped`` when one appears (the stop text is never emitted)."""

    __slots__ = ("stops", "pending", "stopped")

    def __init__(self, stops: Optional[List[str]]) -> None:
        self.stops = [s for s in (stops or []) if s]
        self.pending = ""
        self.stopped = False

    def feed(self, text: str) -> str:
        if not self.stops or self.stopped:
            return text
        self.pending += text
        idx = -1
        for s in self.stops:
            i = self.pending.find(s)
            if i >= 0 and (idx < 0 or i < idx):
                idx = i
        if idx >= 0:
            self.stopped = True
            out, self.pending = self.pending[:idx], ""
            return out
        hold = 0
        for s in self.stops:
            m = min(len(s) - 1, len(self.pending))
            for h in range(m, 0, -1):
                if s.startswith(self.pending[len(self.pending) - h:]):
                    hold = max(hold, h)
                    break
        if hold:
            out = self.pending[:-hold]
            self.pending = self.pending[-hold:]
        else:
            out, self.pending = self.pending, ""
        return out

    def flush(self) -> str:
        out, self.pending = self.pending, ""
        return out


class _EngineDied:
    """Queued to every live request when the engine loop dies (or, with
    ``status`` 503, when its model is put to sleep)."""

    def __init__(self, message: str, status: int = 500,
                 err_type: str = "engine_fault") -> None:
        self.message = message
        self.status = status
        self.err_type = err_type


# Queued to every live request by a simulated death
# (``worker.die_after_n_tokens``): its consumer raises ``_WorkerDied``, so
# that the client's socket breaks mid-stream as a killed process's would.
_ABORT = object()


class _WorkerDied(Exception):
    """Raised to a request's consumer by ``_ABORT``: the handler closes
    the connection without another byte."""


class _Closing:
    """An SSE frame iterator whose ``close`` runs ``on_close`` exactly
    once, even when the body was never started (a generator's ``finally``
    does not run then)."""

    def __init__(self, frames: Iterator[bytes], *on_close) -> None:
        self.frames = frames
        self.on_close = on_close
        self.closed = False

    def __iter__(self) -> "_Closing":
        return self

    def __next__(self) -> bytes:
        return next(self.frames)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            close = getattr(self.frames, "close", None)
            if close is not None:
                close()
        finally:
            for fn in self.on_close:
                fn()


class StepFaultInjected(Exception):
    """Raised by the ``worker.fault_step*`` failpoints inside the engine
    step's fault boundary: a deterministic step fault for tests."""


class _EngineFault:
    """Queued to a request the step fault boundary blamed: its consumer
    answers with the typed ``engine_fault`` error (a 500 or an error
    frame carrying the verdict), which the master counts as a poison
    strike."""

    __slots__ = ("verdict",)

    def __init__(self, verdict: str) -> None:
        self.verdict = verdict


def _classify_step_fault(exc: BaseException) -> str:
    """``transient`` (retried in place, nobody blamed) for a timeout or
    a dropped connection, and for an XLA runtime error whose status is
    one of the retryable ones (matched by the type's name, as the JAX
    worker matches it); ``deterministic`` (blamed by bisection) for
    anything else."""
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return "transient"
    if type(exc).__name__ == "XlaRuntimeError" and any(
            tag in str(exc) for tag in
            ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED")):
        return "transient"
    return "deterministic"


def _merge_step_outputs(outs: List[StepOutput]) -> StepOutput:
    """Held-back deltas of one choice (in arrival order) as one
    StepOutput; the last one supplies the finish state."""
    last = outs[-1]
    merged = StepOutput(
        request_id=last.request_id,
        new_token_ids=[t for o in outs for t in o.new_token_ids],
        logprobs=[lp for o in outs for lp in o.logprobs],
        finish_reason=last.finish_reason,
        num_prompt_tokens=last.num_prompt_tokens,
        num_generated=last.num_generated)
    if any(o.top_logprobs for o in outs):
        merged.top_logprobs = [row for o in outs
                               for row in (o.top_logprobs or [])]
    return merged


class _Choice:
    """Streaming state of one choice (an ``n`` / ``best_of``
    candidate)."""

    __slots__ = ("decoder", "stopper", "completion_tokens", "finished",
                 "cum_logprob", "echo_done", "pending")

    def __init__(self, decoder: IncrementalDecoder,
                 stops: Optional[List[str]]) -> None:
        self.decoder = decoder
        self.stopper = _StopWatcher(stops)
        self.completion_tokens = 0
        self.finished = False
        self.cum_logprob = 0.0
        self.echo_done = False
        # Echo with logprobs over several choices: deltas held until
        # choice 0's prompt scores arrive.
        self.pending: List[StepOutput] = []


class _LiveRequest:
    """Host-side streaming state of one in-flight request, all its
    choices (engine request ids ``<id>`` for n = 1, ``<id>#k``
    otherwise). ``stream_to_service``: its outputs are pushed to the
    service's RPC fan-in by the engine loop instead of queued for an
    HTTP reply."""

    def __init__(self, req: EngineRequest, tokenizer: Tokenizer, model: str,
                 is_chat: bool, stream: bool, include_usage: bool,
                 sampling: SamplingParams,
                 stream_to_service: bool = False, n: int = 1) -> None:
        self.req = req
        self.stream_to_service = stream_to_service
        self.q: "queue.Queue[Any]" = queue.Queue()
        self.tokenizer = tokenizer
        self.model = model
        self.is_chat = is_chat
        self.stream = stream
        self.include_usage = include_usage
        self.sampling = sampling
        n = max(1, n)
        self.engine_rids = ([req.request_id] if n == 1 else
                            [f"{req.request_id}#{k}" for k in range(n)])
        self.choices = [_Choice(IncrementalDecoder(tokenizer),
                                sampling.stop) for _ in range(n)]
        # best_of: the choices above are the candidates; target_n of
        # them survive the non-streamed response's selection.
        self.target_n = n
        # Echo with logprobs: the prompt tokens' scores, computed once
        # (choice 0) and shared by every choice's echo.
        self.prompt_lps: Optional[List[Optional[float]]] = None
        # The relay's token ledger (``ledger_tokens`` on a body the
        # master forwards): SSE chunks carry their token ids.
        self.emit_token_ids = False
        self._echo_cache: Optional[Tuple[str, List[LogProb]]] = None
        # The monotonic time of the first output, 0.0 before it (the
        # span's first_token).
        self.first_out_time = 0.0

    @property
    def request_id(self) -> str:
        return self.req.request_id

    @property
    def finished(self) -> bool:
        return all(c.finished for c in self.choices)

    def choice_index(self, engine_rid: str) -> int:
        if len(self.choices) == 1:
            return 0
        try:
            return int(engine_rid.rsplit("#", 1)[1])
        except (IndexError, ValueError):
            return 0

    def echo_prefix(self) -> Tuple[str, List[LogProb]]:
        """(prompt text, prompt LogProbs) of the echo, decoded once for
        every choice."""
        if self._echo_cache is None:
            text = self.tokenizer.decode(list(self.req.token_ids))
            lps = []
            if self.sampling.logprobs and self.prompt_lps:
                for tid, plp in zip(self.req.token_ids, self.prompt_lps):
                    lps.append(LogProb(
                        token=self.tokenizer.decode([tid]), token_id=tid,
                        logprob=plp, top_logprobs=[]))
            self._echo_cache = (text, lps)
        return self._echo_cache


MODEL_AWAKE = "awake"
MODEL_ASLEEP = "asleep"
MODEL_DRAINING = "draining"
_STEP_PHASES = ("prefill", "decode", "mixed")
# The prefix-reuse series on /metrics (JAX worker :1565-1600), by
# ``Engine.prefix_cache_stats()`` key.
# The PD handoff's counters on /metrics (JAX worker :2428-2440), by
# ``Worker.kv_migration_<key>``.
_MIGRATION_SERIES = (
    ("bytes", "KV bytes this worker migrated to decode workers"),
    ("seconds", "seconds of KV migration to decode workers"),
    ("direct", "migrations to a decode worker in this process"),
    ("device_wire", "migrations over the CUDA IPC device wire"),
    ("chunked", "migrations over the chunked host shuttle"),
)
# The block fetch's counters on /metrics, by ``Worker.<key>``: the JAX
# worker's three (:2439-2448), then this package's split of the time.
_FETCH_SERIES = (
    ("kv_fetch_attempts", "cross-worker cached-block fetches attempted "
                          "(requester side)"),
    ("kv_fetch_failures", "fetch attempts that fell back to recompute "
                          "(holder refusal, transport, failpoint)"),
    ("kv_fetch_bytes", "KV bytes adopted from remote holders"),
    ("kv_fetch_seconds", "seconds of fetches that adopted blocks, from "
                         "the ask to the adoption's end"),
    ("kv_fetch_adopt_seconds", "of those, seconds adopting the blocks "
                               "under the engine lock"),
    ("kv_fetch_device_wire", "fetches adopted over the CUDA IPC wire"),
    ("kv_blocks_served", "/kv/blocks requests answered with blocks "
                         "(holder side)"),
    ("kv_blocks_export_seconds", "seconds of the holder's block exports "
                                 "(and wire staging)"),
)
# The encode plane's counters on /metrics (JAX worker :2398-2414):
# (series, help, ``Worker`` attribute).
_ENCODE_SERIES = (
    ("xllm_worker_encode_seconds_total", "seconds in the vision tower",
     "encode_seconds"),
    ("xllm_worker_encode_calls_total", "vision tower calls",
     "encode_calls"),
    ("xllm_worker_encode_images_total", "images through the vision tower",
     "encode_images_total"),
    ("xllm_worker_encode_steps_total", "batched encode steps executed",
     "encode_steps"),
    ("xllm_encode_cache_hits_total", "images served from the "
     "content-addressed embedding cache", "encode_cache_hits"),
    ("xllm_encode_cache_misses_total", "images that required a tower run",
     "encode_cache_misses"),
    ("xllm_worker_mm_spliced_tokens_total", "image tokens whose embeddings "
     "the engines spliced over the prompt", "mm_spliced_tokens"),
)
# The wire mark a requester of this package puts on /kv/blocks: only an
# ask carrying it gets a CUDA IPC ticket (a JAX requester's ``"wire":
# true`` offers its PJRT wire, which cannot pull one).
FETCH_WIRE = "cuda_ipc"
_PREFIX_SERIES = (
    ("hit_tokens_total", "prompt tokens served from the prefix cache "
                         "(local hits and tier restores)"),
    ("lookups_total", "admits that consulted the prefix cache"),
    ("spilled_pages", "cached pages copied to the host tier instead of "
                      "dropped (XLLM_KV_SPILL_MB)"),
    ("restored_pages", "spilled pages restored to the pool on a later "
                       "prefix hit"),
    ("fetched_blocks_total", "KV blocks adopted from a remote holder "
                             "(cross-worker cached-block fetch)"),
)


def _params_map(fn, tree):
    """``fn`` over every tensor of a parameter tree (nested dicts)."""
    if isinstance(tree, dict):
        return {k: _params_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _params_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_params_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class ModelRuntime:
    """One model's engine and its sleep/wakeup state on this worker (JAX
    worker :239-330). ``timings`` keeps the last boot's, sleep's and
    wake's seconds and bytes (``sleep_s``, ``d2h_s``, ``h2d_s``,
    ``load_s`` and ``load_bytes`` for a read of the checkpoint,
    ``engine_s``, ``param_bytes``; the worker adds ``warmup_s``) and
    where the weights came from (``source``: ``checkpoint``, ``random``
    from seed 0, ``parked`` for a warm wake, ``given`` by the caller)."""

    def __init__(self, model: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device, murmur_seed: int = 0,
                 params: Optional[Params] = None,
                 start_asleep: bool = False, model_dir: str = "",
                 mesh=None) -> None:
        self.model = model
        self.mesh = mesh
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.device = resolve_device(device)
        self.murmur_seed = murmur_seed
        self.model_dir = model_dir
        self.state = MODEL_ASLEEP if start_asleep else MODEL_AWAKE
        self._host_params: Optional[Params] = None
        self.timings: Dict[str, Any] = {}
        self.engine: Optional[Engine] = None
        if not start_asleep:
            if params is None:
                params = self._load_params()
            else:
                self.timings["source"] = "given"
            t0 = time.perf_counter()
            self.engine = self._build(params)
            self.timings["engine_s"] = time.perf_counter() - t0

    def _load_params(self) -> Optional[Params]:
        """The directory's weights when its ``*.safetensors`` hold the
        text stack, read onto the device (JAX worker :262-272); None
        otherwise (the engine random-inits from seed 0), also for a
        directory whose shards hold only a vision tower. Records the
        source, the seconds and the bytes read."""
        self.timings.update(load_s=0.0, load_bytes=0)
        if not checkpoint.has_text_weights(self.model_dir):
            self.timings["source"] = "random"
            logger.info("%s: random weights from seed 0", self.model)
            return None
        t0 = time.perf_counter()
        stats: Dict[str, float] = {}
        params = checkpoint.load_checkpoint(self.model_dir, self.model_cfg,
                                            self.device, stats=stats)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings.update(source="checkpoint",
                            load_s=time.perf_counter() - t0,
                            load_bytes=int(stats["bytes_read"]))
        logger.info("%s: weights from %s, %d bytes in %.2f s", self.model,
                    self.model_dir, self.timings["load_bytes"],
                    self.timings["load_s"])
        return params

    def _build(self, params: Optional[Params]) -> Engine:
        """A new engine on ``params`` (None: random from seed 0, as the
        JAX engine's without a checkpoint)."""
        return Engine(self.model_cfg, self.engine_cfg, params=params,
                      device=self.device, murmur_seed=self.murmur_seed,
                      mesh=self.mesh)

    def sleep(self) -> None:
        """Park the parameters in host memory, bit for bit (pinned on a
        GPU), and drop the engine: its KV pools, its decode, prefill and
        ragged graphs with their private pool and static buffers, and the
        prefix cache's pages. The reference cycles that would keep them
        alive are collected and the freed blocks go back to the card."""
        if self.state == MODEL_ASLEEP:
            return
        if self.mesh is not None:
            raise NotImplementedError(
                "sleep/wake is not sharded: not available under a mesh")
        t0 = time.perf_counter()
        eng = self.engine
        if eng is not None:
            # A speculative burst in flight must not outlive its pools.
            eng.drain_pipeline()
            t1 = time.perf_counter()
            if self.device.type == "cuda":
                def park(t: torch.Tensor) -> torch.Tensor:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    return h
                self._host_params = _params_map(park, eng.params)
                torch.cuda.synchronize(self.device)
            else:
                self._host_params = _params_map(torch.clone, eng.params)
            self.timings["d2h_s"] = time.perf_counter() - t1
            self.timings["param_bytes"] = _params_bytes(self._host_params)
            self.engine = eng = None
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        self.state = MODEL_ASLEEP
        self.timings["sleep_s"] = time.perf_counter() - t0

    def wakeup(self) -> None:
        """A new engine on the parked parameters (a warm wake), or for a
        model with nothing parked (staged asleep) on the model directory's
        weights, or random ones from seed 0 without them (a cold wake).
        The caller runs the warmup."""
        if self.state == MODEL_AWAKE:
            return
        params = self._host_params
        t0 = time.perf_counter()
        if params is None:
            params = self._load_params()        # cold wake: from disk
        else:
            self.timings.update(source="parked", load_s=0.0, load_bytes=0)
            if self.device.type == "cuda":
                params = _params_map(
                    lambda h: h.to(self.device, non_blocking=True), params)
                torch.cuda.synchronize(self.device)
        # The parked copy's way back (a load's seconds are load_s).
        self.timings["h2d_s"] = (time.perf_counter() - t0
                                 - self.timings["load_s"])
        t1 = time.perf_counter()
        self.engine = self._build(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["engine_s"] = time.perf_counter() - t1
        # Only now: a build that raised (out of memory) keeps the parked
        # weights for the next wake.
        self._host_params = None
        self.state = MODEL_AWAKE

    @property
    def memory_gb(self) -> float:
        """Rough device footprint for the serverless allocator (the JAX
        worker's estimate)."""
        cfg = self.model_cfg
        if cfg.is_moe:
            f = cfg.moe_intermediate_size or cfg.intermediate_size
            mlp = cfg.num_experts * 3 * cfg.hidden_size * f \
                + cfg.hidden_size * cfg.num_experts
        else:
            mlp = 3 * cfg.hidden_size * cfg.intermediate_size
        n_params = (cfg.vocab_size * cfg.hidden_size * 2
                    + cfg.num_layers * (
                        4 * cfg.hidden_size * cfg.num_heads * cfg.head_dim
                        + mlp))
        return 2.0 * n_params / 1e9


class Worker:
    # Per-input token cap of /v1/embeddings: a longer input is a 400,
    # never truncated (JAX worker :487-490).
    EMBED_MAX_TOKENS = 256

    def __init__(self, opts: WorkerOptions,
                 engine_cfg: Optional[EngineConfig] = None,
                 model_cfg: Optional[ModelConfig] = None,
                 params: Optional[Params] = None,
                 vision_tower: Optional[Tuple[Any, Dict[str, Any]]] = None
                 ) -> None:
        """``vision_tower``: a (config, parameters) pair to encode images
        with instead of the model directory's tower or the synthetic ViT
        from seed 0 (``models/vision.VisionConfig``, or either
        ``models/qwen2vl_vision`` config)."""
        self.opts = opts
        if opts.encode_only:
            opts.instance_type = InstanceType.ENCODE
        # The directory's tokenizer (tokenizer.json, *.tiktoken or
        # tokenizer.model), else the byte tokenizer (JAX worker :500).
        self.tokenizer = TokenizerFactory.create_tokenizer(opts.model_dir)
        self.engine_cfg = engine_cfg or EngineConfig()
        self.device = resolve_device(opts.device)
        # Held across an engine step and a vision tower run: a tower's
        # kernels never interleave with a graph capture.
        self._engine_lock = make_lock("worker.engine", 20)
        model_cfg = model_cfg or resolve_model_config(opts.model,
                                                      opts.model_dir)
        # The mesh, rank 0's side (the followers started, or joined).
        self.mesh, self._rank_procs = self._join_mesh(model_cfg, params)
        self._mesh_down = False
        # One runtime per model; the primary first. Its engine first:
        # without the device it raises before any socket is bound.
        self.runtimes: Dict[str, ModelRuntime] = {
            opts.model: ModelRuntime(
                opts.model, model_cfg, self.engine_cfg, self.device,
                murmur_seed=opts.murmur_seed, params=params,
                model_dir=opts.model_dir, start_asleep=opts.encode_only,
                mesh=self.mesh)}
        self._init_encode_plane(vision_tower)
        if self._should_warmup() and self.engine is not None:
            secs = self.warmup()
            logger.info("warmup: %.1f s, %s", secs,
                        self.engine.compile_report())
        if self._should_warmup() and (
                self.model_cfg.is_mrope
                or self.opts.instance_type == InstanceType.ENCODE):
            # The tower's first run, before registration (JAX worker
            # :908-919): the first image request does not pay it.
            t0 = time.perf_counter()
            self.encode_images(["random:0"])
            logger.info("vision warmup: %.1f s", time.perf_counter() - t0)
        # The registration's TTFT/TPOT samples, measured once here, on the
        # warmed engine (its steps replay warmup's graphs) before the
        # engine loop starts; every registration carries them. The JAX
        # worker measures them at each registration.
        self._ttft_prof: List[Tuple[float, float]] = []
        self._tpot_prof: List[Tuple[float, float, float]] = []
        if opts.enable_profiling and self.engine is not None:
            self._ttft_prof, self._tpot_prof = profile_engine(self.engine)
        self._live: Dict[str, _LiveRequest] = {}        # engine rid
        self._live_srid: Dict[str, _LiveRequest] = {}   # request id
        self._live_lock = make_lock("worker.live", 10)
        # Held by the engine loop across one runtime's step, the dispatch
        # of its outputs and its records; /sleep and /wakeup take it
        # before the engine lock, so that no reference of a step to an
        # engine outlives the engine's sleep.
        self._loop_mu = make_lock("worker.loop", 9)
        # Sleeps and wakes waiting for _loop_mu: the engine loop yields
        # to them between steps instead of re-taking it at once.
        self._flip_mu = make_lock("worker.flip", 90)
        self._flips_waiting = 0
        self._work = threading.Event()
        self._stop = threading.Event()
        self._stopped = False
        self.engine_error: Optional[str] = None
        # The worker's event ring: supervised thread crashes and the
        # store guard's outages land here (JAX worker :545).
        self.events = EventLog(capacity=256)
        # The worker plane's request spans (JAX worker :538): finished
        # ones ride the heartbeat to the master's span ring.
        self.spans = SpanStore(capacity=int(os.environ.get(
            "XLLM_SPAN_RING", "2048")))
        # The front door (JAX worker :815-829): the native epoll server
        # or the Python one, with admission at max_concurrency, read live.
        self._srv = HttpServer(
            opts.host, opts.port, build_router(self),
            max_concurrency=lambda: self.opts.max_concurrency,
            admission_exempt=ADMISSION_EXEMPT)
        self.name = self._srv.address
        self._threads: List[threading.Thread] = []
        # The cluster plane: none for a worker given neither a store nor
        # a service, which serves requests sent straight to it.
        self.store: Optional[CoordinationStore] = (
            connect_store(opts.store_addr)
            if opts.store_addr or opts.service_addr else None)
        self.lease_ttl_s = (opts.lease_ttl_s if opts.lease_ttl_s
                            else 3 * opts.heartbeat_interval_s)
        # The registry /metrics renders, under the JAX worker's series
        # names; the families are made once, the engine loop fills them.
        self.obs = Registry()
        self._m_steps = self.obs.counter(
            "xllm_worker_steps_total",
            "engine iterations by phase "
            "(mixed = interleaved decode+prefill)",
            labelnames=("model", "phase"))
        self._m_step_tokens = self.obs.counter(
            "xllm_worker_step_tokens_total",
            "batch token occupancy: prompt tokens computed (prefill) / "
            "tokens sampled (decode); mixed iterations split per phase",
            labelnames=("model", "phase"))
        self._m_step_ms = self.obs.histogram(
            "xllm_worker_step_ms", "wall time of one engine step",
            labelnames=("model", "phase"))
        self._m_alive = self.obs.gauge(
            "xllm_worker_engine_alive",
            "1 while the engine loop serves this model, 0 once it died",
            labelnames=("model",))
        self._m_prefix = {
            key: self.obs.counter(f"xllm_worker_prefix_cache_{key}", help,
                                  labelnames=("model",))
            for key, help in _PREFIX_SERIES}
        self._m_recompiles = self.obs.counter(
            "xllm_worker_recompiles_total",
            "post-warmup graph captures per program (0 is the contract)",
            labelnames=("model", "program"))
        self._m_compiles = self.obs.counter(
            "xllm_worker_jit_compiles_total",
            "graphs captured per program, warmup included (steady growth "
            "= an unbucketed shape)", labelnames=("model", "program"))
        self._m_eager = self.obs.counter(
            "xllm_worker_eager_steps_total",
            "steps per program run outside a graph (0 on a warmed CUDA "
            "engine)", labelnames=("model", "program"))
        self._m_launches = self.obs.gauge(
            "xllm_worker_kernel_launches",
            "hand-written kernel launches counted in this process (each "
            "graph replay counts the kernels it holds)",
            labelnames=("kernel",))
        self._lease_id: Optional[int] = None
        self._reg_mu = make_lock("worker.reg", 8)
        self._addr_watch: Optional[int] = None
        # Current service target (configured, then store-advertised) and
        # its topology; compare-and-swapped under _addr_mu by the watch
        # thread and the heartbeat thread.
        self._addr_mu = make_lock("worker.addr", 89)
        self._service_addr = opts.service_addr
        self._service_config_stale = bool(opts.service_addr)
        self._decode_to_service = False
        # Serializes heartbeat build + send; the step-p99 baseline and
        # the acked master epoch are touched only under it.
        self._hb_lock = make_lock("worker.hb", 5)
        self._hb_step_cum: Dict[str, List[Tuple[float, float]]] = {}
        # The cache digests of a beat that was not delivered, folded
        # into the next one (touched only under _hb_lock: a beat never
        # waits for the engine lock).
        self._hb_cache_pending: Optional[KvCacheEvent] = None
        self._master_epoch = 0
        self._prefill_tok_cum = 0
        self._prefill_s_cum = 0.0
        # Beat sends back off against a down master with full jitter
        # while the loop keeps ticking (the lease keepalive must go on);
        # registration retries a store hiccup at boot.
        # The cap is XLLM_HB_BACKOFF_CAP_S (JAX worker :645-650).
        self._hb_backoff = RetryPolicy(
            max_attempts=1, base_delay_s=opts.heartbeat_interval_s,
            max_delay_s=float(os.environ.get(
                "XLLM_HB_BACKOFF_CAP_S", "30") or 30),
            multiplier=2.0, jitter=0.5)
        self._reg_retry = RetryPolicy(max_attempts=5, base_delay_s=0.2,
                                      max_delay_s=5.0)
        # Fault injection, armed by XLLM_FAILPOINTS and POST
        # /admin/failpoint; trips count in this registry.
        self.failpoints = Failpoints(obs=self.obs)
        # The store guard (JAX worker :627-636): this worker's view of
        # the store's health, wired to its own failpoints. Its heal only
        # flags the heartbeat loop, which re-registers
        # (``_on_store_heal``).
        if self.store is not None:
            self.store = StoreGuard(self.store, failpoints=self.failpoints,
                                    events=self.events)
            self.store.on_heal(self._on_store_heal)
        self._heal_pending = threading.Event()
        # The simulated death of worker.die_after_n_tokens: work refused,
        # beats dropped, streams broken; the process lives on.
        self._dead = False
        # Graceful drain (JAX worker :690-706): while draining, beats say
        # every model is draining; new work is refused once the master
        # has heard it (``_refuse_new``). ``_inflight_parse`` counts the
        # work-accepting handlers not yet answered or registered in
        # ``_live_srid``, ``_relay_streams`` the PD streams this worker
        # relays after its own live request ended (both under
        # _live_lock).
        self._draining = False
        self._refuse_new = False
        self._inflight_parse = 0
        self._relay_streams = 0
        self._m_faults = self.obs.counter(
            "xllm_engine_faults_total",
            "engine step faults seen by the fault boundary, by "
            "containment outcome", labelnames=("model", "outcome"))
        # The step fault boundary: probe steps a bisection may spend, and
        # the breaker (more than _fault_limit contained faults within
        # _fault_window_s let the engine loop die). Read once here.
        self._fault_bisect_budget = int(os.environ.get(
            "XLLM_FAULT_BISECT_BUDGET", "4") or 4)
        self._fault_limit = int(os.environ.get(
            "XLLM_ENGINE_FAULT_LIMIT", "5") or 5)
        self._fault_window_s = float(os.environ.get(
            "XLLM_ENGINE_FAULT_WINDOW_S", "60") or 60)
        self._fault_times: "deque[float]" = deque()   # engine-loop only
        # Engine request ids marked by worker.fault_step_req (guarded by
        # the engine lock).
        self._fault_marked: set = set()
        # True while the engine loop serves; False once the breaker let
        # it die (xllm_worker_engine_alive, the beat's engine_alive).
        self._engine_loop_alive = True
        # The step flight recorder, its per-step delta snapshots (engine
        # loop only), the last verdict (mirrored at scrape time) and the
        # highest record seq an acknowledged beat carried (under
        # _hb_lock).
        self.steptrace = steptrace.StepTrace()
        self._st_phase_snap: Dict[str, Dict[str, float]] = {}
        self._st_spec_snap: Dict[str, Dict[str, int]] = {}
        self._st_prefix_snap: Dict[str, int] = {}
        self._st_free_pages: Dict[str, int] = {}
        self._st_last: Dict[str, Dict[str, float]] = {}
        self._hb_steps_seq = 0
        self._device_kind = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        # The role this worker registers under (``/flip_role`` changes it).
        self.instance_type = opts.instance_type
        # The PD handoff's counters (both sides; /metrics), the decode
        # side's staged /kv/chunk parts by request, the decode peers that
        # answered wire-unsupported, and the RPC topology's first tokens
        # of adopted sequences, pushed ahead of the next step's outputs
        # (appended under the engine lock).
        self.kv_migration_bytes = 0
        self.kv_migration_seconds = 0.0
        self.kv_migration_direct = 0
        self.kv_migration_device_wire = 0
        self.kv_migration_chunked = 0
        self._kv_chunk_mu = make_lock("worker.kvchunk", 27)
        self._kv_chunk_staging: Dict[str, Dict[str, Any]] = {}
        self._wire_refused: set = set()
        self._service_push_buffer: List[RequestOutput] = []
        try:
            self._kv_shuttle_chunk_mb = float(os.environ.get(
                "XLLM_KV_SHUTTLE_CHUNK_MB", "32"))
        except ValueError:
            self._kv_shuttle_chunk_mb = 32.0
        # The cross-worker block fetch. Holder: the wire tickets staged
        # for a requester's pull, uuid -> (staged at, wire), released by
        # /kv/blocks_done or the TTL sweep; the requests served and the
        # export's seconds. Requester: attempts, failures (each fell back
        # to recompute), bytes adopted, the seconds of adopted fetches
        # and of their adoption, those over the wire, and the holders
        # that answered a wire ticket this process cannot pull. All
        # under _kv_fetch_mu.
        self._kv_fetch_mu = make_lock("worker.kvfetch", 25)
        self._kv_fetch_staged: Dict[int, Tuple[float, Any]] = {}
        self.kv_blocks_served = 0
        self.kv_blocks_export_seconds = 0.0
        self.kv_fetch_attempts = 0
        self.kv_fetch_failures = 0
        self.kv_fetch_bytes = 0
        self.kv_fetch_seconds = 0.0
        self.kv_fetch_adopt_seconds = 0.0
        self.kv_fetch_device_wire = 0
        self._fetch_wire_refused: set = set()
        # A fetch must never hold TTFT for long: recompute is always
        # near (JAX worker :611-614).
        try:
            self._kv_fetch_timeout_s = float(os.environ.get(
                "XLLM_KV_FETCH_TIMEOUT_S", "15") or 15)
        except ValueError:
            self._kv_fetch_timeout_s = 15.0

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    @property
    def engine(self) -> Optional[Engine]:
        """The primary model's engine (None while it sleeps)."""
        return self.primary_runtime().engine

    @property
    def model_cfg(self) -> ModelConfig:
        return self.primary_runtime().model_cfg

    def primary_runtime(self) -> ModelRuntime:
        return self.runtimes[self.opts.model]

    def _runtime_for(self, model: Optional[str]) -> ModelRuntime:
        """The runtime a request names, the primary for any other name
        (JAX worker :1948)."""
        return self.runtimes.get(model or "") or self.primary_runtime()

    def _should_warmup(self) -> bool:
        if self.opts.warmup is not None:
            return self.opts.warmup
        return self.device.type == "cuda"

    def start(self) -> "Worker":
        """Serve, then join the cluster (JAX worker :921-975): register
        under a lease with retry and backoff (a store outage waits
        without spending the budget), adopt and watch the master's
        advertised address, learn the service's topology, and start the
        heartbeat loop. The engine warmed up in ``__init__``, before
        registration. A worker without a store only serves. The engine
        loop is supervised without a restart: a crash that escapes its
        fault boundary leaves device state unknown (JAX :832-866)."""
        t = threads.spawn("worker.engine_loop", self._engine_loop,
                          thread_name="worker-engine-loop",
                          events=self.events, stop=self._stop)
        t.start()
        self._threads.append(t)
        self._srv.start()
        # The encode loop restarts after a crash: a dead loop would hang
        # every queued /encode until its deadline (JAX worker :855-864).
        t = threads.spawn("worker.encode_loop", self._encode_loop,
                          thread_name="worker-encode",
                          restart=threads.RESTART_POLICY,
                          events=self.events, stop=self._stop)
        t.start()
        self._threads.append(t)
        _LOCAL_WORKERS[self.name] = self
        if self.store is None:
            return self
        attempt = outage_waits = 0
        while not self._stop.is_set():
            try:
                self._register()
                break
            except StoreOutageError as e:
                outage_waits += 1
                if outage_waits == 1 or outage_waits % 10 == 0:
                    logger.warning("store outage at boot (%s); "
                                   "registration queued until heal", e)
                self._reg_retry.sleep(min(outage_waits - 1, 4),
                                      stop_event=self._stop)
            except Exception as e:  # noqa: BLE001 — transient store error
                attempt += 1
                if attempt >= self._reg_retry.max_attempts:
                    raise
                logger.warning("registration attempt %d failed (%s); "
                               "backing off", attempt, e)
                self._reg_retry.sleep(attempt - 1, stop_event=self._stop)
        # A heal during the boot retries is met by the registration.
        self._heal_pending.clear()
        # Only a worker configured with a service follows the advertised
        # master: a standalone worker sharing the store must not start
        # taking routed traffic.
        if self.opts.service_addr:
            self._adopt_advertised_addr()
            self._addr_watch = self.store.add_watch(KEY_MASTER_ADDR,
                                                    self._on_master_addr)
            self._refresh_service_config()
        # The heartbeat loop restarts after a crash: a dead loop looks
        # like a dead worker to the master (its lease expires).
        t = threads.spawn("worker.hb_loop", self._heartbeat_loop,
                          restart=threads.RESTART_POLICY,
                          events=self.events, stop=self._stop)
        t.start()
        self._threads.append(t)
        return self

    def drain_and_stop(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown (JAX worker :1031-1072): beat every model
        ``draining`` until the master acknowledges (it stops routing
        here), then refuse new work, let the requests in flight finish,
        and stop. True when everything drained within ``timeout_s``."""
        self._draining = True
        if self.service_addr:
            for _ in range(3):
                try:
                    if self._send_heartbeat():
                        break
                except Exception:  # noqa: BLE001 — retried; the drain
                    pass            # goes on either way
                time.sleep(0.2)
            else:
                # The master did not hear it: give its next poll a beat.
                time.sleep(min(1.0, self.opts.heartbeat_interval_s))
        self._refuse_new = True
        deadline = time.monotonic() + timeout_s
        drained = False
        try:
            while time.monotonic() < deadline:
                busy = any(rt.engine is not None and rt.engine.has_work()
                           for rt in list(self.runtimes.values()))
                with self._live_lock:
                    busy = busy or bool(self._live_srid) \
                        or self._inflight_parse > 0 \
                        or self._relay_streams > 0
                if not busy:
                    drained = True
                    break
                time.sleep(0.05)
        finally:
            self.stop()
        return drained

    def stop(self) -> None:
        """Cancel the watch, end live streams, revoke the lease and stop
        the HTTP server (JAX worker :1074-1112, which revokes last): the
        master drops this instance on the lease's DELETE, before the
        server's shutdown poll. A second call does nothing."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        self._work.set()
        self._refuse_new = True
        _LOCAL_WORKERS.pop(self.name, None)
        if self._addr_watch is not None:
            try:
                self.store.cancel_watch(self._addr_watch)
            except Exception:  # noqa: BLE001 — best-effort: the store
                pass            # may be gone
            self._addr_watch = None
        self._end_lives("worker stopped")
        with self._reg_mu:
            lease_id, self._lease_id = self._lease_id, None
        if lease_id is not None:
            try:
                self.store.lease_revoke(lease_id)
            except Exception:  # noqa: BLE001 — best-effort: the lease's
                pass            # TTL expires it anyway
        self._srv.stop()
        for t in self._threads:
            t.join(timeout=30.0)
        if self.store is not None:
            self.store.close()
        self._leave_mesh()

    def _join_mesh(self, model_cfg: ModelConfig, params: Optional[Params]):
        """Rank 0's mesh for the engine config's tp, dp and sp and the
        options' ep, or (None, []) for one rank: a world started by the
        caller (``dist_coordinator``), or ranks 1 .. n-1 started here on
        the devices ``ranks.plan_devices`` gives them."""
        ecfg, opts = self.engine_cfg, self.opts
        spec = MeshSpec(dp=ecfg.dp, ep=opts.ep, sp=ecfg.sp, tp=ecfg.tp)
        if spec.num_devices == 1:
            return None, []
        if opts.encode_only:
            raise NotImplementedError(
                "the encode role is not sharded: not available under a "
                "mesh")
        if opts.dist_coordinator:
            if opts.dist_num_processes not in (0, spec.num_devices):
                raise ValueError(
                    f"--dist-num-processes {opts.dist_num_processes} is "
                    f"not the mesh's {spec.num_devices} ranks")
            if opts.dist_process_id not in (-1, 0):
                raise ValueError("a worker is process 0; other process "
                                 "ids run the follower loop")
            return make_mesh(spec, 0, self.device, opts.dist_backend or None,
                             f"tcp://{opts.dist_coordinator}"), []
        return ranks.start_mesh(spec, model_cfg, ecfg, self.device,
                                opts.dist_backend, params=params,
                                model_dir=opts.model_dir,
                                murmur_seed=opts.murmur_seed)

    def _leave_mesh(self) -> None:
        """Release the followers and leave the world (after the engine
        loop stopped: no step broadcast is in flight). A world the
        engine loop tore down (``_mesh_fault``) is gone already."""
        if self.mesh is None or self._mesh_down:
            return
        mesh, self.mesh = self.mesh, None
        try:
            ranks.stop_followers(mesh)
        finally:
            ranks.stop_processes(self._rank_procs)
            mesh.close()

    def _mesh_fault(self, message: str,
                    exc: Optional[BaseException] = None) -> None:
        """A step failed on some rank of the mesh, or a follower exited:
        the ranks are out of step, so nothing is contained. Every
        request fails (with the follower that exited named, if one
        did), the engine loop ends and the world is torn down
        (``ranks.abort``)."""
        if exc is not None:
            lost = ranks.lost_follower(self._rank_procs, wait_s=0.5)
            message = f"{message}: {exc!r}" + (f" (mesh {lost})"
                                               if lost else "")
        logger.error("%s; the mesh is torn down", message, exc_info=exc)
        with self._engine_lock:
            self._mesh_down = True
            ranks.abort(self.mesh, self._rank_procs)
        self._engine_loop_alive = False
        for rt in self.runtimes.values():
            self._m_alive.set(0, model=rt.model)
            self._m_faults.inc(model=rt.model, outcome="uncontained")
        self._fail_all(message)

    def serve_forever(self) -> None:
        """Block until ``stop`` (from another thread or a signal)."""
        self._stop.wait()

    # ------------------------------------------------------------------
    # Registration and the master's address
    # ------------------------------------------------------------------
    def _register(self) -> None:
        """Write the registration (JAX worker :1114-1169, with the
        profiling samples of ``enable_profiling``) under a fresh TTL
        lease: the awake models and the memory budget. A re-registration
        revokes the old lease first, or every one leaks a live lease in
        the store."""
        layers = list(range(self.model_cfg.num_layers))
        eng = self.engine
        meta = InstanceMetaInfo(
            name=self.name, rpc_address=self.name,
            instance_type=self.instance_type,
            models=[m for m, rt in self.runtimes.items()
                    if rt.state == MODEL_AWAKE],
            dp_size=self.engine_cfg.dp,
            memory_budget_gb=self.opts.memory_budget_gb,
            k_cache_ids=layers, v_cache_ids=list(layers),
            addrs=[self.name],
            # The block-hash contract the service checks against its
            # (block_size, murmur seed), and one block's bytes.
            page_size=self.engine_cfg.page_size,
            hash_seed=self.opts.murmur_seed,
            kv_block_bytes=eng.kv_block_bytes() if eng is not None else 0,
            ttft_profiling_data=list(self._ttft_prof),
            tpot_profiling_data=list(self._tpot_prof),
            # The encode plane's advertisement (JAX worker :1149-1155):
            # an ENCODE worker serves the tower; the grid is its image
            # side once the tower is built (never built for this).
            encode_capable=(self.instance_type == InstanceType.ENCODE
                            or self.opts.encode_only),
            encode_image_size=self._encode_image_size())
        with self._reg_mu:
            if self._lease_id is not None:
                try:
                    self.store.lease_revoke(self._lease_id)
                except Exception:  # noqa: BLE001 — best-effort: the old
                    pass            # lease's TTL expires it anyway
                self._lease_id = None
            self._lease_id = self.store.lease_grant(self.lease_ttl_s)
            self.store.put_json(
                instance_prefix(self.instance_type.value) + self.name,
                stamp(meta.to_json()), self._lease_id)

    def _on_store_heal(self) -> None:
        """The store guard's heal callback (JAX worker :1171-1182): only
        flags the heartbeat loop, which re-registers on a fresh lease and
        re-reads the advertised master. It runs on the thread whose store
        call healed the guard, possibly inside ``_register`` itself, so
        registering here would re-enter ``_reg_mu``."""
        if self._stop.is_set() or self._dead:
            return
        self._heal_pending.set()

    @property
    def service_addr(self) -> str:
        """Current service RPC target (configured, then store-advertised)."""
        return self._service_addr

    def _retarget(self, info) -> bool:
        """Adopt an advertised master address if it differs from the
        current target, and mark the service config stale: the
        heartbeat loop re-fetches it, never the watch thread."""
        rpc = (info or {}).get("rpc")
        if not rpc:
            return False
        with self._addr_mu:
            if rpc == self._service_addr:
                return False
            old, self._service_addr = self._service_addr, rpc
            self._service_config_stale = True
        logger.info("service master moved %s -> %s", old, rpc)
        return True

    def _adopt_advertised_addr(self) -> bool:
        """Re-read ``KEY_MASTER_ADDR`` and retarget if it moved (at boot,
        and after two failed beats: a PUT that landed before the watch
        was live)."""
        try:
            info = self.store.get_json(KEY_MASTER_ADDR)
        except Exception:  # noqa: BLE001 — store hiccup; retried next beat
            return False
        return self._retarget(info)

    def _on_master_addr(self, event) -> None:
        ev_type, _key, value = event
        if ev_type != "PUT" or not value:
            return   # DELETE = master lease expired; keep the last known
        try:
            info = json.loads(value)
        except ValueError:
            return
        self._retarget(info)

    def _fetch_service_config(self) -> bool:
        """Learn the response topology from ``/rpc/config`` (JAX worker
        :4149). True only when the answer still belongs to the current
        target."""
        addr = self.service_addr
        if not addr:
            return False
        try:
            status, cfg = http_json("GET", addr, "/rpc/config", timeout=5.0)
        except Exception as e:  # noqa: BLE001 — retried via the stale flag
            logger.debug("service config fetch from %s failed: %s", addr, e)
            return False
        if status == 200 and isinstance(cfg, dict) \
                and addr == self.service_addr:
            self._decode_to_service = bool(
                cfg.get("enable_decode_response_to_service"))
            return True
        return False

    def _refresh_service_config(self) -> None:
        """Fetch the current target's config; the stale flag clears only
        if no retarget landed while the fetch was in flight."""
        addr = self.service_addr
        ok = self._fetch_service_config()
        with self._addr_mu:
            if self._service_addr == addr:
                self._service_config_stale = bool(addr) and not ok

    # ------------------------------------------------------------------
    # Heartbeats
    # ------------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        """Each tick (JAX worker :4173-4275): the injected crash (raised
        outside the tick's ``try``, so that the supervised thread
        restarts the loop), the staged-ticket sweep, the dropped beat of
        ``worker.drop_heartbeats``, the re-registration a store heal
        asked for, the lease keepalive (a store outage is not a beat
        failure; a dead lease while the store answers re-registers), the
        service config when stale, then a beat unless the backoff holds
        it (a retarget clears it); after two failed beats, the advertised
        address is read again."""
        hb_failures = 0
        next_hb = 0.0
        target = self.service_addr
        while not self._stop.wait(self.opts.heartbeat_interval_s):
            if self.failpoints.fire("worker.crash_heartbeat") is not None:
                raise RuntimeError("injected heartbeat-loop crash "
                                   "(failpoint worker.crash_heartbeat)")
            if self.service_addr != target:
                # A new master gets its first beat now, not after the
                # backoff earned against the old one.
                target = self.service_addr
                hb_failures, next_hb = 0, 0.0
            try:
                self._sweep_kv_fetch_staged()
                self._sweep_encode_staged()
                if self.failpoints.fire("worker.drop_heartbeats") \
                        is not None:
                    # A simulated partition: no keepalive and no beat, so
                    # the lease expires as if the process were gone.
                    continue
                if self._heal_pending.is_set():
                    # Before the keepalive, so that it runs against the
                    # fresh lease.
                    self._heal_pending.clear()
                    try:
                        self._register()
                        logger.info("store healed: lease and registration "
                                    "re-established for %s", self.name)
                    except Exception as e:  # noqa: BLE001 — the store
                        # flaps; the next tick retries
                        self._heal_pending.set()
                        logger.warning("post-heal re-registration "
                                       "failed: %s", e)
                    else:
                        if self.opts.service_addr:
                            self._adopt_advertised_addr()
                lease_id = self._lease_id
                if lease_id is not None:
                    try:
                        alive = self.store.lease_keepalive(lease_id)
                    except StoreOutageError as e:
                        logger.debug("store keepalive unreachable: %s", e)
                        alive = True     # frozen: not a beat failure
                    if not alive and lease_id == self._lease_id:
                        try:
                            self._register()
                            logger.warning("lease %d expired under a live "
                                           "worker; re-registered with a "
                                           "fresh lease", lease_id)
                        except Exception as e:  # noqa: BLE001 — the next
                            # tick (or the guard's heal) retries
                            logger.warning("re-registration failed: %s", e)
                if self._service_config_stale:
                    self._refresh_service_config()
                if self.service_addr and time.monotonic() >= next_hb:
                    if self._send_heartbeat():
                        hb_failures, next_hb = 0, 0.0
                    else:
                        hb_failures += 1
                        next_hb = time.monotonic() + \
                            self._hb_backoff.delay(hb_failures - 1)
            except Exception as e:  # noqa: BLE001 — a failed beat
                hb_failures += 1
                next_hb = time.monotonic() + \
                    self._hb_backoff.delay(hb_failures - 1)
                logger.warning("heartbeat failed: %s", e)
            if hb_failures >= 2 and self.opts.service_addr \
                    and self._adopt_advertised_addr():
                hb_failures, next_hb = 0, 0.0

    def _send_heartbeat(self) -> bool:
        """One beat; True when the service acknowledged it (HTTP 200
        from a master whose epoch is not behind one already acked). The
        cache digests are the primary model's, as the JAX worker's: none
        while it sleeps (its undelivered ones wait for its wake). The
        finished spans it carries go back to the ring unless it is
        delivered (JAX worker :4386-4464)."""
        with self._hb_lock:
            eng = self.engine
            cache_ev = None
            if eng is not None:
                cache_ev = eng.drain_kvcache_event()
                if self._hb_cache_pending is not None:
                    self._hb_cache_pending.merge(cache_ev)
                    cache_ev, self._hb_cache_pending = \
                        self._hb_cache_pending, None
            delivered = False
            span_batch: List[Dict[str, Any]] = []
            # The encode plane's delta (digests gained and evicted, recent
            # step ms), requeued unless the beat is delivered.
            with self._embed_mu:
                enc = (self._embed_stored_pending,
                       self._embed_removed_pending, self._encode_recent_ms)
                self._embed_stored_pending = []
                self._embed_removed_pending = []
                self._encode_recent_ms = []
            try:
                hb, (step_baseline, steps_seq) = \
                    self._build_heartbeat(cache_ev, enc)
                span_batch = hb.spans
                status, ack = http_json(
                    "POST", self.service_addr, "/rpc/heartbeat",
                    stamp(hb.to_json()), timeout=10.0)
                if status != 200:
                    return False
                ack_epoch = int((ack or {}).get("epoch", 0) or 0)
                if ack_epoch < self._master_epoch:
                    # A deposed master still answers on this address: its
                    # ack is no delivery (JAX worker :4424-4446).
                    logger.warning(
                        "rejected beat-ack from deposed master at %s "
                        "(epoch %d < acked %d)", self.service_addr,
                        ack_epoch, self._master_epoch)
                    return False
                self._master_epoch = ack_epoch
                self._hb_step_cum = step_baseline
                self._hb_steps_seq = steps_seq
                delivered = True
                return True
            finally:
                if not delivered:
                    self.spans.requeue(span_batch)
                if not delivered and cache_ev is not None \
                        and not cache_ev.empty:
                    self._hb_cache_pending = cache_ev
                if not delivered and any(enc):
                    with self._embed_mu:
                        self._embed_stored_pending[:0] = enc[0]
                        self._embed_removed_pending[:0] = enc[1]
                        self._encode_recent_ms[:0] = enc[2]

    def _build_heartbeat(self, cache_ev: Optional[KvCacheEvent] = None,
                         enc: Tuple[List[str], List[str], List[float]] = (
                             [], [], [])
                         ) -> Tuple[Heartbeat, Tuple[Dict[str, Any], int]]:
        """The beat's payload (JAX worker :4336-4471): the primary
        model's load and step p99, every model's state (``draining`` for
        all while draining), the cache digests of ``cache_ev`` as hex and
        the step records since the last acknowledged beat (at most 64),
        the finished spans (drained after the step tail; back to the
        ring if the beat cannot be built), the encode plane's queue
        depth, mean step ms and the embedding cache's digest delta
        ``enc`` (stored, removed, step ms), and what to commit once it is
        acked: the step histogram's baseline and the last record's
        seq."""
        rt = self.primary_runtime()
        eng = rt.engine
        p99, baseline = self._recent_step_p99(rt.model)
        steps_tail: List[Dict[str, Any]] = []
        steps_seq = self._hb_steps_seq
        if self.steptrace.enabled:
            steps_tail = self.steptrace.tail(n=64,
                                             since_seq=self._hb_steps_seq)
            if steps_tail:
                steps_seq = int(steps_tail[-1].get("seq", steps_seq))
        # Nothing between the drain and the return may lose the batch.
        span_batch = self.spans.drain_finished()
        try:
            # The fetch planner's terms: the measured prefill rate and KV
            # transfer rate (the PD migrations'; 0.0 = no signal, the master
            # falls back to XLLM_KV_FETCH_{TOKS,GBPS}).
            latency = LatencyMetrics(
                step_ms_p99=p99,
                prefill_tok_s=(self._prefill_tok_cum / self._prefill_s_cum
                               if self._prefill_s_cum > 0 else 0.0),
                kv_gbps=(self.kv_migration_bytes / self.kv_migration_seconds
                         / 1e9 if self.kv_migration_seconds > 0 else 0.0),
                waiting_prefill_tokens=(int(eng.waiting_prefill_tokens())
                                        if eng is not None else 0))
            stored, removed, enc_ms = enc
            if enc_ms:
                latency.encode_ms = sum(enc_ms) / len(enc_ms)
                latency.encode_ms_samples = list(enc_ms)
            load = self._engine_load(rt)
            load.encode_queue_depth = self._encode_q.qsize()
            ev = cache_ev or KvCacheEvent()
            hb = Heartbeat(name=self.name,
                           instance_type=self.instance_type,
                           load=load, latency=latency,
                           cache_stored=[h.hex() for h in ev.stored],
                           cache_removed=[h.hex() for h in ev.removed],
                           cache_offloaded=[h.hex() for h in ev.offloaded],
                           cache_offloaded_ssd=[h.hex()
                                                for h in ev.offloaded_ssd],
                           model_states={
                               m: MODEL_DRAINING if self._draining else r.state
                               for m, r in list(self.runtimes.items())},
                           embed_stored=list(stored),
                           embed_removed=list(removed),
                           steps=steps_tail, spans=span_batch)
        except BaseException:
            self.spans.requeue(span_batch)
            raise
        return hb, (baseline, steps_seq)

    def _recent_step_p99(self, model: str
                         ) -> Tuple[float, Dict[str, Any]]:
        """p99 of ``model``'s ``xllm_worker_step_ms`` over the steps since
        the last acked beat, prefill, decode and mixed merged (JAX worker
        :4307): the delta of cumulative bucket counts is itself a
        histogram. Returns (p99, the baseline to commit on an ack), so a
        refused beat folds its interval into the next. 0.0 = no step
        ran."""
        h = self._m_step_ms
        pending = dict(self._hb_step_cum)
        merged = None
        for phase in _STEP_PHASES:
            cur = h.cumulative(model=model, phase=phase)
            if cur is None:
                continue
            prev = self._hb_step_cum.get(phase)
            pending[phase] = cur
            delta = cur if prev is None else \
                [(le, c - p) for (le, c), (_le, p) in zip(cur, prev)]
            merged = delta if merged is None else \
                [(le, a + b) for (le, a), (_le, b) in zip(merged, delta)]
        if not merged or merged[-1][1] <= 0:
            return 0.0, pending
        return quantile_from_buckets(merged, 0.99) or 0.0, pending

    def _engine_load(self, rt: ModelRuntime) -> LoadMetrics:
        """A runtime's load as the heartbeat carries it (empty while it
        sleeps), mirrored into the registry as ``xllm_worker_<key>{model}``
        and ``xllm_worker_engine_alive{model}`` (JAX worker :4285-4305).
        Reads the engine without its lock."""
        eng = rt.engine
        if eng is None:
            return LoadMetrics()
        lm = eng.load_metrics()
        for k, v in lm.items():
            self.obs.gauge(f"xllm_worker_{k}",
                           labelnames=("model",)).set(v, model=rt.model)
        alive = int(self._engine_loop_alive)
        self._m_alive.set(alive, model=rt.model)
        return LoadMetrics(
            waiting_requests=lm["waiting_requests"],
            running_requests=lm["running_requests"],
            kv_cache_usage=lm["kv_cache_usage"],
            num_preemptions=lm["num_preemptions"],
            moe_dropped_tokens=lm["moe_dropped_tokens"],
            engine_alive=alive)

    def _record_step(self, rt: ModelRuntime, eng: Engine, step_ms: float,
                     phase: Optional[str] = None) -> None:
        """After each ``Engine.step()`` and its outputs' dispatch, on the
        engine-loop thread: ``rt``'s step series by ``last_step_kind``
        (JAX worker :1386-1440), or by ``phase`` (``"fault"`` for a
        faulted step), and the flight recorder's record. The load
        mirrors refresh at each scrape and beat."""
        m = rt.model
        kind = phase or eng.last_step_kind
        if kind == "idle":
            return
        if self.steptrace.enabled:
            self._record_steptrace(rt, eng, kind, step_ms)
        pf, dc = eng.last_step_prefill_tokens, eng.last_step_decode_tokens
        self._m_steps.inc(1, model=m, phase=kind)
        if pf:
            self._m_step_tokens.inc(pf, model=m, phase="prefill")
        if dc:
            self._m_step_tokens.inc(dc, model=m, phase="decode")
        self._m_step_ms.observe(step_ms, model=m, phase=kind)
        if pf:
            self._prefill_tok_cum += pf
            self._prefill_s_cum += eng.last_step_prefill_s

    def _record_steptrace(self, rt: ModelRuntime, eng: Engine, kind: str,
                          step_ms: float) -> None:
        """One flight-recorder record for the step that just ran (JAX
        worker :1476-1534): the phase, speculation, prefix-hit and
        free-page deltas against the model's previous snapshots, and the
        roofline verdict of the engine's table against the device's
        peaks."""
        m = rt.model
        cur = dict(eng.phase_times)
        snap = self._st_phase_snap.get(m, {})
        phases = {}
        for k, v in cur.items():
            d = (v - snap.get(k, 0.0)) * 1e3
            if d > 0.0005:
                phases[k] = round(d, 3)
        self._st_phase_snap[m] = cur
        om = eng.overlap_metrics()
        spec_snap = self._st_spec_snap.get(m, {})
        spec = {k: int(om[k] - spec_snap.get(k, 0))
                for k in ("spec_dispatches", "spec_hits", "spec_rollbacks")}
        self._st_spec_snap[m] = {k: int(om[k]) for k in spec}
        hit_cum = int(eng.prefix_cache_stats()["hit_tokens_total"])
        hit_delta = hit_cum - self._st_prefix_snap.get(m, 0)
        self._st_prefix_snap[m] = hit_cum
        free = int(eng.allocator.num_free)
        prev = self._st_free_pages.get(m)
        self._st_free_pages[m] = free
        peak_flops, peak_bytes_s = steptrace.peaks_for(self._device_kind)
        verdict = steptrace.attribute_step(
            eng.roofline, kind=kind, step_ms=step_ms,
            prefill_tokens=eng.last_step_prefill_tokens,
            decode_tokens=eng.last_step_decode_tokens,
            batch_size=eng.ecfg.max_batch_size,
            decode_steps=eng.decode_steps,
            ragged=eng.last_step_ragged,
            peak_flops=peak_flops, peak_bytes_s=peak_bytes_s)
        self._st_last[m] = {"mfu": verdict["mfu"],
                            "debt_ms": verdict["debt_ms"]}
        self.steptrace.record(
            model=m, kind=kind, step_ms=round(step_ms, 3),
            prefill_tokens=eng.last_step_prefill_tokens,
            decode_tokens=eng.last_step_decode_tokens,
            prefill_windows=eng.last_step_prefill_windows,
            decode_deferred=eng.last_step_decode_deferred,
            ragged=eng.last_step_ragged,
            attn_dispatches=eng.last_step_attn_dispatches,
            members=eng.step_members,
            phases=phases, spec=spec,
            kv_usage=round(float(eng.load_metrics()["kv_cache_usage"]), 4),
            pages_delta=free - (free if prev is None else prev),
            cache_hit_tokens=hit_delta,
            flops=verdict["flops"], bytes=verdict["bytes"],
            mfu=verdict["mfu"], bound=verdict["bound"],
            debt_ms=verdict["debt_ms"])

    def _awake(self) -> List[Tuple[ModelRuntime, Engine]]:
        """(runtime, engine) of every awake model."""
        out = []
        for rt in list(self.runtimes.values()):
            eng = rt.engine
            if eng is not None:
                out.append((rt, eng))
        return out

    def steptrace_body(self, n: int = 0,
                       window_s: float = 0.0) -> Dict[str, Any]:
        """``GET /admin/steptrace`` (JAX worker :1908-1940): the ring's
        tail (``n`` newest, or within ``window_s`` of the newest), the
        peaks, the hot-path profiler's timed sections
        (``profiler.recent_events``, the same window) and every awake
        model's roofline rows."""
        peak_flops, peak_bytes_s = steptrace.peaks_for(self._device_kind)
        roofline = []
        for rt, eng in self._awake():
            for row in steptrace.roofline_table(eng.roofline, peak_flops,
                                                peak_bytes_s):
                row["model"] = rt.model
                roofline.append(row)
        return {
            "name": self.name,
            "enabled": self.steptrace.enabled,
            "device_kind": self._device_kind,
            "peak_flops": peak_flops,
            "peak_bytes_s": peak_bytes_s,
            "steps": self.steptrace.tail(n=n, window_s=window_s),
            "sections": profiler.recent_events(window_s=window_s),
            "roofline": roofline,
        }

    def metrics_text(self) -> str:
        """``GET /metrics``: per awake model the load mirrors, the
        prefix-cache series, the graph census (captures per program, and
        those after warmup: the JAX worker's compile and recompile
        counters; eager steps) and the roofline mirrors; then the
        supervised threads' crash books, the hot-path profiler's books
        (sections, sampled lock waits, CPU per thread root, RSS, CPU%,
        GC pauses), the keep-alive pool, the span ring's evictions, the
        store guard's health, the process's kernel launch counts and the
        PD handoff's and block fetch's counters, the front door's kind and
        its shed requests, and the registry in Prometheus text."""
        for rt, eng in self._awake():
            m = rt.model
            self._engine_load(rt)
            stats = eng.prefix_cache_stats()
            for key, _ in _PREFIX_SERIES:
                self._m_prefix[key].set_total(stats[key], model=m)
            captures = eng.capture_report()
            for program, total in eng.compile_report().items():
                self._m_compiles.set_total(total, model=m, program=program)
                self._m_recompiles.set_total(
                    captures[program]["captures_after_warmup"],
                    model=m, program=program)
                self._m_eager.set_total(
                    sum(captures[program]["eager_steps"].values()),
                    model=m, program=program)
            last = self._st_last.get(m, {})
            steptrace.flush_metrics(self.obs, m, eng.roofline,
                                    last.get("mfu", 0.0),
                                    last.get("debt_ms", 0.0),
                                    self._device_kind)
        threads.flush_metrics(self.obs)
        profiler.flush_metrics(self.obs)
        flush_conn_pool_metrics(self.obs, plane="worker")
        self.obs.gauge("xllm_worker_http_server",
                       "1 for the front door that serves this worker "
                       "(native epoll or the Python threaded server)",
                       labelnames=("kind",)).set(1, kind=self._srv.kind)
        adm = self._srv.admission
        self.obs.counter("xllm_worker_http_rejected_total",
                         "entry requests shed with a 503 at "
                         "max_concurrency").set_total(
            adm.rejected_total if adm is not None else 0)
        self.obs.counter(
            "xllm_span_evictions_total",
            "request spans dropped by ring overflow "
            "(size the ring with XLLM_SPAN_RING)").set_total(
            self.spans.eviction_count())
        self.obs.gauge("xllm_store_health",
                       "coordination-store health as seen by this plane "
                       "(2 healthy / 1 flaky / 0 down)").set(
            int(getattr(self.store, "health", 2)))
        for name, n in kernels.launch_counts().items():
            self._m_launches.set(n, kernel=name)
        for key, help in _MIGRATION_SERIES:
            self.obs.counter(f"xllm_worker_kv_migration_{key}_total",
                             help).set_total(
                getattr(self, f"kv_migration_{key}"))
        for key, help in _FETCH_SERIES:
            self.obs.counter(f"xllm_worker_{key}_total", help).set_total(
                getattr(self, key))
        for name, help, key in _ENCODE_SERIES:
            self.obs.counter(name, help).set_total(getattr(self, key))
        self.obs.gauge("xllm_worker_encode_staged",
                       "embedding tickets staged on the CUDA IPC wire "
                       "awaiting a requester's pull").set(
            self.encode_staged_count())
        self.obs.gauge("xllm_worker_encode_queue_depth",
                       "encode jobs waiting for the batched encode "
                       "loop").set(self._encode_q.qsize())
        with self._embed_mu:
            cached = len(self._embed_cache)
        self.obs.gauge("xllm_worker_embed_cache_entries",
                       "embeddings resident in the content-addressed "
                       "embedding cache").set(cached)
        wire = kv_wire.wire_stats()
        self.obs.gauge("xllm_worker_kv_wire_reserved_bytes",
                       "device bytes this process holds in CUDA IPC "
                       "staging segments (kv_wire.MAX_STAGING_BYTES caps them)"
                       ).set(wire["reserved_bytes"])
        staging = kv_wire.peek_device_wire()
        self.obs.gauge("xllm_worker_kv_wire_staged",
                       "tickets staged on the CUDA IPC wire awaiting a "
                       "peer's pull").set(
            staging.staged_count() if staging is not None else 0)
        self.obs.counter("xllm_worker_kv_wire_busy_total",
                         "device-wire stages that found no segment and "
                         "took the host shuttle").set_total(wire["busy"])
        self.obs.counter("xllm_worker_kv_wire_leaked_total",
                         "staging segments left reserved by a pull that "
                         "may still read them").set_total(wire["leaked"])
        return self.obs.render()

    def warmup(self, rt: Optional[ModelRuntime] = None) -> float:
        """The warmup ladder of ``rt``'s engine (the primary's by
        default; ``XLLM_WARMUP_EXTENDED=0`` keeps only its first shapes,
        as the JAX worker reads it), and with the full ladder the wider
        tables of later windows (``Engine.late_window_shapes``). Returns
        the seconds spent."""
        eng = (rt or self.primary_runtime()).engine
        extended = os.environ.get("XLLM_WARMUP_EXTENDED", "1") != "0"
        secs = eng.warmup(extended=extended)
        if extended:
            secs += eng.warmup(prefill_shapes=eng.late_window_shapes())
        return secs

    # ------------------------------------------------------------------
    # Engine loop
    # ------------------------------------------------------------------
    def _engine_loop(self) -> None:
        """Step every awake runtime in turn (JAX worker :1190-1223), each
        inside the step fault boundary; wait for work when none has any.
        Ends, visibly, when the breaker opens."""
        while not self._stop.is_set():
            if self.mesh is not None and not self._mesh_idle():
                return
            busy = False
            for rt in list(self.runtimes.values()):
                stepped = self._step_runtime(rt)
                if stepped is False:
                    return
                busy = busy or bool(stepped)
            if not busy:
                self._work.wait(timeout=0.05)
                self._work.clear()

    def _mesh_idle(self) -> bool:
        """Between steps under a mesh: False (the world torn down) when a
        follower this worker started has exited or the keep-alive
        failed; else the keep-alive sent when due, True."""
        lost = ranks.lost_follower(self._rank_procs)
        if not lost:
            if not ranks.keepalive_due(self.mesh):
                return True
            try:
                with self._engine_lock:
                    ranks.keepalive(self.mesh)
                return True
            except Exception as exc:  # noqa: BLE001 — a lost peer
                self._mesh_fault("mesh keep-alive failed", exc)
                return False
        self._mesh_fault(f"mesh {lost}")
        return False

    def _step_runtime(self, rt: ModelRuntime) -> Optional[bool]:
        """One step of ``rt``'s engine, its outputs and records: None when
        it sleeps or has no work, True when it stepped (or a fault was
        contained), False when the breaker opened (every request, then
        and after, gets a 500). Under ``_loop_mu``: a sleep waits for
        the step's references to its engine to go."""
        if self._flips_waiting:
            return None
        with self._loop_mu:
            fault: Optional[BaseException] = None
            with self._engine_lock:
                eng = rt.engine
                if eng is None or not eng.has_work():
                    return None
                if eng.fault_hook is None:
                    # A woken runtime's engine is new.
                    eng.fault_hook = self._step_fault_hook
                # First tokens of sequences adopted since the last step
                # go out ahead of this step's outputs.
                adopted, self._service_push_buffer = \
                    self._service_push_buffer, []
                t0 = time.perf_counter()
                try:
                    outs = eng.step()
                except Exception as exc:  # noqa: BLE001 — the step
                    fault = exc           # fault boundary, below
                step_ms = (time.perf_counter() - t0) * 1e3
            self._push_outputs_to_service(adopted)
            if fault is not None and self.mesh is not None:
                self._record_step(rt, eng, step_ms, phase="fault")
                self._mesh_fault(f"engine step failed under a "
                                 f"{self.mesh.world}-rank mesh", fault)
                return False
            if fault is not None:
                # Contain, attribute, resume; or, with the breaker open,
                # die visibly.
                if not self._contain_engine_fault(rt, fault, step_ms):
                    logger.error("engine step failed", exc_info=fault)
                    self._engine_loop_alive = False
                    self._m_alive.set(0, model=rt.model)
                    self._fail_all(f"engine step failed: {fault!r}")
                    return False
                return True
            # The outputs first, then the step's records.
            self._dispatch_outputs(outs)
            self._record_step(rt, eng, step_ms)
            return True

    def _step_fault_hook(self, member_rids: Tuple[str, ...]) -> None:
        """``Engine.fault_hook``: called under the engine lock with each
        step section's members; the two step failpoints raise here."""
        if self.failpoints.fire("worker.fault_step") is not None:
            raise StepFaultInjected("worker.fault_step")
        if self._fault_marked \
                and self._fault_marked.intersection(member_rids) \
                and self.failpoints.fire(
                    "worker.fault_step_req") is not None:
            raise StepFaultInjected("worker.fault_step_req")

    def _contain_engine_fault(self, rt: ModelRuntime, exc: BaseException,
                              step_ms: float) -> bool:
        """The fault boundary's recovery (JAX worker :1245-1317): the
        faulted step's records under ``phase="fault"``, the breaker,
        then the blame (nobody for a transient fault; by bisection for a
        deterministic one), ``fault_reset``, the salvaged and probe
        outputs to their streams and the blamed requests' typed errors.
        True when contained; False when the breaker is open."""
        eng = rt.engine
        self._record_step(rt, eng, step_ms, phase="fault")
        now = time.monotonic()
        self._fault_times.append(now)
        while self._fault_times and \
                now - self._fault_times[0] > self._fault_window_s:
            self._fault_times.popleft()
        if len(self._fault_times) > self._fault_limit:
            self._m_faults.inc(model=rt.model, outcome="uncontained")
            logger.error("engine fault breaker open (%d faults in %.0fs "
                         "window): %s", len(self._fault_times),
                         self._fault_window_s, exc)
            return False
        kind = _classify_step_fault(exc)
        probe_outs: List[Tuple[List[StepOutput], float]] = []
        with self._engine_lock:
            live_ids = set(eng.live_request_ids())
            suspects = [r for r in eng.step_members if r in live_ids] \
                or sorted(live_ids)
            # The completed sections' outputs: their tokens are already
            # on the sequences.
            salvaged = list(eng.last_step_partial_outs)
            if kind == "transient":
                blamed: List[str] = []
                eng.fault_reset(())
            else:
                blamed, probe_outs = self._bisect_step_fault(eng, suspects)
                eng.fault_reset(blamed)
            self._fault_marked.difference_update(blamed)
        outcome = ("transient_retry" if kind == "transient" else
                   "culprit" if len(blamed) == 1 else
                   "whole_batch" if blamed else
                   # A deterministic fault no probe reproduced: nobody
                   # blamed, retried in place.
                   "transient_retry")
        verdict = (f"{outcome} [{type(exc).__name__}: {exc}] "
                   f"on {self.name}")
        logger.warning("engine step fault contained (%s): blamed %s",
                       outcome, blamed or "nobody")
        blamed_set = set(blamed)
        salvaged = [o for o in salvaged if o.request_id not in blamed_set]
        if salvaged:
            self._dispatch_outputs(salvaged)
        for outs, _ms in probe_outs:
            kept = [o for o in outs if o.request_id not in blamed_set]
            if kept:
                self._dispatch_outputs(kept)
        self._m_faults.inc(model=rt.model, outcome=outcome)
        if blamed:
            self._fail_lives_engine_fault(blamed, verdict)
        self._work.set()
        return True

    def _bisect_step_fault(self, eng, suspects: List[str]
                           ) -> Tuple[List[str],
                                      List[Tuple[List[StepOutput], float]]]:
        """Blame by bisection (JAX worker :1319-1353): step the first half
        of the suspects alone, within ``_fault_bisect_budget`` probes. A
        faulting half narrows the suspects to it; a clean half is
        exonerated (its probe's outputs are returned for dispatch). When
        the budget runs out, the suspects left are blamed. Runs under
        the engine lock."""
        probe_outs: List[Tuple[List[StepOutput], float]] = []
        budget = self._fault_bisect_budget
        if len(suspects) <= 1 or budget <= 0:
            return list(suspects), probe_outs
        eng.fault_reset(())      # a known-good point before probing
        while len(suspects) > 1 and budget > 0:
            half = suspects[:max(1, len(suspects) // 2)]
            budget -= 1
            t0 = time.monotonic()
            outs: List[StepOutput] = []
            faulted = False
            try:
                eng.isolate(half)
                outs = eng.step()
            except Exception:  # noqa: BLE001 — the probe reproduced the
                faulted = True  # fault: the suspects narrow to this half
            finally:
                eng.release_isolation()
            if faulted:
                eng.fault_reset(())
                suspects = list(half)
            else:
                probe_outs.append((outs, 1000.0 * (time.monotonic() - t0)))
                suspects = [r for r in suspects if r not in half]
        return list(suspects), probe_outs

    def _fail_lives_engine_fault(self, rids: List[str],
                                 verdict: str) -> None:
        """End the blamed requests with the typed ``engine_fault``
        failure (JAX worker :1355-1384): a relayed request's consumer
        gets ``_EngineFault``, a pushed one a finished output with an
        INTERNAL ``engine_fault: <verdict>`` status. Their other choices
        are cancelled."""
        to_service: List[RequestOutput] = []
        for rid in rids:
            with self._live_lock:
                live = self._live.get(rid)
            if live is None:
                continue
            self.spans.record(live.request_id, "faulted", plane="worker")
            if live.stream_to_service:
                to_service.append(RequestOutput(
                    request_id=live.request_id,
                    service_request_id=live.request_id,
                    status=Status(StatusCode.INTERNAL,
                                  f"engine_fault: {verdict}"),
                    finished=True))
            else:
                live.q.put(_EngineFault(verdict))
            self._finalize(live)
        self._push_outputs_to_service(to_service)

    def _dispatch_outputs(self, outs: List[StepOutput]) -> None:
        """A step's outputs to their consumers: a relayed request's
        queue, or one push of the wire outputs to the service. The span's
        ``first_token`` (with the prompt tokens the prefix cache served)
        and, at an engine-level finish, ``finished`` (JAX worker
        :1662-1677)."""
        now = time.monotonic()
        to_service: List[RequestOutput] = []
        for out in outs:
            if not self._dead and self.failpoints.fire(
                    "worker.die_after_n_tokens",
                    n=len(out.new_token_ids)) is not None:
                self._die()
            if self._dead:
                # Outputs past the trip point are lost, as a killed
                # process's socket buffers are.
                return
            with self._live_lock:
                live = self._live.get(out.request_id)
            if live is None:
                continue
            if live.first_out_time == 0.0:
                live.first_out_time = now
                self.spans.record(live.request_id, "first_token",
                                  plane="worker", t_mono=now)
                self.spans.annotate(live.request_id,
                                    cache_hit_tokens=out.num_cached_tokens)
            if out.finished:
                self.spans.record(live.request_id, "finished",
                                  plane="worker", t_mono=now)
            if not live.stream_to_service:
                live.q.put(out)
                if out.finished:
                    self._drop_live(out.request_id)
                continue
            to_service.extend(self._process_step_output(live, out))
            if out.finished or live.choices[
                    live.choice_index(out.request_id)].finished:
                self._drop_live(out.request_id)
            if live.finished:
                # A flush may have finished choices whose engine ids
                # were dropped already.
                with self._live_lock:
                    self._live_srid.pop(live.request_id, None)
        self._push_outputs_to_service(to_service)

    def _push_outputs_to_service(self, outs: List[RequestOutput]) -> None:
        """The RPC topology: one push of a step's outputs to the
        service's fan-in, stamped and with the sender's name (JAX worker
        :3573-3589). Nothing after a simulated death."""
        if not outs or self._dead:
            return
        try:
            status, _ = http_json(
                "POST", self.service_addr, "/rpc/generations",
                stamp({"outputs": [o.to_json() for o in outs],
                       "from": self.name}), timeout=30.0)
            if status != 200:
                logger.warning("generations push refused: %d (%d outputs "
                               "lost)", status, len(outs))
        except Exception as e:  # noqa: BLE001 — the service's request
            # timeout ends a request whose outputs were lost
            logger.warning("generations push failed: %s", e)

    def _drop_live(self, engine_rid: str) -> None:
        with self._live_lock:
            live = self._live.pop(engine_rid, None)
            if live is not None and live.finished:
                self._live_srid.pop(live.request_id, None)

    def _end_lives(self, message: str, model: Optional[str] = None,
                   status: int = 500,
                   err_type: str = "engine_fault") -> None:
        """End every live request (of ``model`` only, when given): a
        relayed one gets an error in its reply (``status`` and
        ``err_type``), a pushed one a finished output with an INTERNAL
        status (UNAVAILABLE for a 503)."""
        with self._live_lock:
            lives = [lv for lv in self._live_srid.values()
                     if model is None or self._runtime_for(lv.model).model
                     == model]
            for lv in lives:
                self._live_srid.pop(lv.request_id, None)
                for erid in lv.engine_rids:
                    self._live.pop(erid, None)
        code = StatusCode.UNAVAILABLE if status == 503 else \
            StatusCode.INTERNAL
        to_service = []
        for live in lives:
            if live.stream_to_service:
                to_service.append(RequestOutput(
                    request_id=live.request_id,
                    service_request_id=live.request_id,
                    status=Status(code, message), finished=True))
            else:
                live.q.put(_EngineDied(message, status, err_type))
        self._push_outputs_to_service(to_service)

    def _die(self) -> None:
        """``worker.die_after_n_tokens`` tripped (JAX worker :1865-1888):
        look dead without ending the process. Refuse new work, drop
        every beat and keepalive (``worker.drop_heartbeats``: the lease
        expires as a crashed worker's would), cancel every live request's
        engine work and break its stream mid-frame, and push nothing more
        to the service."""
        if self._dead:
            return
        self._dead = True
        self._refuse_new = True
        logger.warning("failpoint worker.die_after_n_tokens tripped: %s "
                       "simulating death", self.name)
        self.failpoints.arm("worker.drop_heartbeats", mode="always")
        with self._live_lock:
            lives = list(self._live_srid.values())
        for live in lives:
            eng = self._runtime_for(live.model).engine
            if eng is not None:
                with self._engine_lock:
                    for erid in live.engine_rids:
                        eng.cancel(erid)
            live.q.put(_ABORT)
        self._work.set()

    def _fail_all(self, message: str) -> None:
        self.engine_error = message
        self._end_lives(message)

    # ------------------------------------------------------------------
    # Requests
    # ------------------------------------------------------------------
    def generate_failpoints(self) -> None:
        """The generate routes' injected faults (JAX worker :2174-2186),
        no-ops unless armed: a delay, a hang (then a 503) or a
        refusal."""
        v = self.failpoints.fire("worker.slow_response_ms")
        if v is not None:
            self._stop.wait((float(v) if v is not True else 100.0) / 1000.0)
        v = self.failpoints.fire("worker.hang_rpc")
        if v is not None:
            self._stop.wait(float(v) if v is not True else 3600.0)
            raise HttpError(503, "hung rpc released (failpoint)",
                            "unavailable")
        if self.failpoints.fire("worker.refuse_generate") is not None:
            raise HttpError(503, "refused by failpoint", "unavailable")

    def _parse_generate(self, body: Dict[str, Any], is_chat: bool,
                        pd_prefill: bool = False) -> _LiveRequest:
        """Parse, validate and queue one generate request. ``pd_prefill``:
        the prefill half of a PD request (JAX worker :1982-1985,
        :2036-2065): one engine request sampling only its first token,
        EOS honoured, its pages held for the handoff; the live request
        keeps the client's sampling for the answer."""
        if self.engine_error is not None:
            raise HttpError(500, self.engine_error, "engine_fault")
        model = body.get("model", self.opts.model)
        rt = self._runtime_for(model)
        if rt.engine is None:
            # As the JAX worker answers it (:1945-1950): a 400.
            raise HttpError(400, f"model {model} is asleep on this worker")
        rid = body.get("service_request_id") or \
            f"req-{secrets.token_urlsafe(16)}"
        token_ids = body.get("token_ids") or []
        if not token_ids:
            if is_chat:
                prompt = "\n".join(str(m.get("content", ""))
                                   for m in body.get("messages", []))
            else:
                prompt = body.get("prompt", "")
            token_ids = self.tokenizer.encode(prompt)
        # The master's block fetch plan, followed before admission so
        # that the admission hits the adopted blocks (multimodal prompts
        # are never prefix-cached: no fetch).
        kvf = (body.get("routing") or {}).get("kv_fetch")
        if kvf and not body.get("mm_inputs"):
            try:
                self._maybe_fetch_blocks(rt, model, list(token_ids), kvf)
            except Exception as e:  # noqa: BLE001 — the fetch only saves
                # a prefill: anything unforeseen recomputes
                logger.warning("kv block fetch failed (%s); recomputing",
                               e)
        try:
            # The service-parsed SamplingParams travel in the forwarded
            # body: what the service normalized (max_completion_tokens,
            # stop strings) is never re-derived here (JAX :1970-1978).
            if body.get("sampling"):
                sampling = SamplingParams.from_json(body["sampling"])
            else:
                sampling = parse_openai_sampling(body, is_chat)
            stream = bool(body.get("stream", False))
            engine_sampling = sampling
            if pd_prefill:
                engine_sampling = dataclasses.replace(
                    sampling, max_tokens=1, ignore_eos=False)
            validate_sampling(engine_sampling, stream)
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e)) from e
        if sampling.logit_bias:
            # Only the worker knows the vocabulary: an id past it is
            # refused, not silently ignored (JAX worker :2024-2033).
            V = rt.model_cfg.vocab_size
            bad = [t for t in sampling.logit_bias if t >= V]
            if bad:
                raise HttpError(400, f"logit_bias token ids out of vocab "
                                     f"range (< {V}): {bad[:5]}")
        mm: Dict[str, Any] = {}
        if body.get("mm_inputs"):
            try:
                token_ids, mm = self._resolve_mm(rt, body,
                                                 list(token_ids), rid)
            except TimeoutError as e:
                raise HttpError(503, str(e), "unavailable") from e
            except ValueError as e:
                raise HttpError(400, str(e)) from e
        # best_of: the larger candidate pool runs; the response keeps
        # target_n of them (ResponseCollector).
        n = 1 if pd_prefill else max(1, sampling.n, sampling.best_of or 0)
        req = EngineRequest(request_id=rid, token_ids=list(token_ids),
                            sampling=engine_sampling,
                            offline=bool(body.get("offline", False)),
                            eos_token_ids=self.tokenizer.eos_token_ids,
                            prompt_logprobs=(sampling.echo
                                             and sampling.logprobs
                                             and not is_chat
                                             and not pd_prefill),
                            hold_after_finish=pd_prefill, **mm)
        live = _LiveRequest(
            req, self.tokenizer, model, is_chat, stream,
            bool((body.get("stream_options") or {}).get("include_usage")),
            sampling,
            stream_to_service=not pd_prefill and self._topology2(), n=n)
        if not pd_prefill:
            live.target_n = max(1, sampling.n)
        live.emit_token_ids = bool(body.get("ledger_tokens"))
        # worker.fault_step_req marks a request at admission: a string
        # value marks prompts that contain it, any other every request.
        mark = self.failpoints.armed_value("worker.fault_step_req")
        marked = mark is not None and (
            not isinstance(mark, str)
            or mark in self.tokenizer.decode(list(token_ids)))
        # Registered before the engine sees the request (no output of its
        # first step finds it missing) and outside the engine lock: the
        # rank table orders worker.live before worker.engine (JAX worker
        # :2067-2088).
        with self._live_lock:
            self._live_srid[rid] = live
            for erid in live.engine_rids:
                self._live[erid] = live
        try:
            with self._engine_lock:
                eng = rt.engine
                if eng is None:
                    raise HttpError(400, f"model {model} is asleep on "
                                         f"this worker")
                if marked:
                    self._fault_marked.update(live.engine_rids)
                added: List[str] = []
                try:
                    for k, erid in enumerate(live.engine_rids):
                        creq = req
                        if n > 1:
                            # Distinct choices: a seeded request's choice
                            # k draws from seed + k; prompt scores are the
                            # same for every choice, so choice 0 computes
                            # them.
                            seed = (sampling.seed + k
                                    if sampling.seed is not None else None)
                            creq = dataclasses.replace(
                                req, request_id=erid,
                                token_ids=list(token_ids),
                                sampling=dataclasses.replace(sampling,
                                                             seed=seed),
                                prompt_logprobs=(req.prompt_logprobs
                                                 and k == 0))
                        eng.add_request(creq)
                        added.append(erid)
                except ValueError as e:
                    for erid in added:
                        eng.cancel(erid)
                    raise HttpError(400, str(e)) from e
        except BaseException:
            with self._live_lock:
                if self._live_srid.get(rid) is live:
                    self._live_srid.pop(rid, None)
                for erid in live.engine_rids:
                    if self._live.get(erid) is live:
                        self._live.pop(erid, None)
            raise
        self._work.set()
        return live

    def _process_step_output(self, live: _LiveRequest,
                             out: StepOutput) -> List[RequestOutput]:
        """One engine StepOutput as wire RequestOutputs (JAX worker
        :1735-1790): usually 0 or 1; more when its arrival releases other
        choices. Under echo with logprobs the prompt scores ride choice
        0's first output, and every other choice's deltas are held until
        they land (their logprob arrays lead with the prompt's). Choice 0
        finishing without them (cancelled before its prefill scored the
        prompt) releases the held choices with empty scores."""
        need_plp = (live.sampling.echo and live.sampling.logprobs
                    and not live.is_chat)
        arrived = out.prompt_logprobs is not None and live.prompt_lps is None
        source_died = (need_plp and live.prompt_lps is None
                       and out.prompt_logprobs is None
                       and live.choice_index(out.request_id) == 0
                       and out.finish_reason != FinishReason.NONE)
        if arrived or source_died:
            live.prompt_lps = out.prompt_logprobs if arrived else []
            ros: List[RequestOutput] = []
            ro = self._to_request_output(live, out)
            if ro is not None:
                ros.append(ro)
            for other in live.choices:
                if other.pending:
                    pend, other.pending = other.pending, []
                    ro = self._to_request_output(
                        live, _merge_step_outputs(pend))
                    if ro is not None:
                        ros.append(ro)
            return ros
        ch = live.choices[live.choice_index(out.request_id)]
        if need_plp and not ch.echo_done and not ch.finished \
                and live.prompt_lps is None:
            ch.pending.append(out)
            return []
        if ch.pending:
            pend, ch.pending = ch.pending, []
            out = _merge_step_outputs(pend + [out])
        ro = self._to_request_output(live, out)
        return [ro] if ro is not None else []

    def _to_request_output(self, live: _LiveRequest,
                           out: StepOutput) -> Optional[RequestOutput]:
        """One engine StepOutput of one choice as the wire RequestOutput:
        incremental detokenization, stop strings (the choice's engine
        request is cancelled once one fires), the echo, chosen-token and
        top logprobs, the mean logprob on the finish delta (the
        ``best_of`` ranking key) and usage once every choice finished.
        None once the choice has finished."""
        idx = live.choice_index(out.request_id)
        ch = live.choices[idx]
        if ch.finished:
            return None
        finish = out.finish_reason
        text = ch.decoder.feed(out.new_token_ids)
        if finish != FinishReason.NONE:
            text += ch.decoder.flush()
        if ch.stopper.stops:
            text = ch.stopper.feed(text)
            if ch.stopper.stopped:
                finish = FinishReason.STOP
                self._cancel([out.request_id], live.model)
            elif finish != FinishReason.NONE:
                text += ch.stopper.flush()
        ch.completion_tokens += len(out.new_token_ids)
        ch.cum_logprob += sum(out.logprobs)
        echo_lps: List[LogProb] = []
        if live.sampling.echo and not ch.echo_done:
            # The first delta of each choice leads with the prompt: its
            # text and, with logprobs, its scores (the first null).
            ch.echo_done = True
            prefix_text, echo_lps = live.echo_prefix()
            text = prefix_text + text
        logprobs = list(echo_lps)
        if live.sampling.logprobs:
            for j, tid in enumerate(out.new_token_ids):
                top = []
                if out.top_logprobs and live.sampling.top_logprobs > 0:
                    top = [{"token": live.tokenizer.decode([e["token_id"]]),
                            "token_id": e["token_id"],
                            "logprob": e["logprob"]}
                           for e in out.top_logprobs[j]
                           [:live.sampling.top_logprobs]]
                logprobs.append(LogProb(
                    token=live.tokenizer.decode([tid]), token_id=tid,
                    logprob=out.logprobs[j] if j < len(out.logprobs)
                    else 0.0,
                    top_logprobs=top))
        if finish != FinishReason.NONE:
            ch.finished = True
        seq = SequenceOutput(
            index=idx, text=text, token_ids=list(out.new_token_ids),
            finish_reason=finish, logprobs=logprobs,
            # A cancelled or empty choice ranks last (None), below every
            # real choice's negative mean.
            mean_logprob=(ch.cum_logprob / ch.completion_tokens
                          if finish not in (FinishReason.NONE,
                                            FinishReason.CANCELLED)
                          and ch.completion_tokens > 0 else None))
        usage = None
        if live.finished:
            usage = Usage(prompt_tokens=len(live.req.token_ids),
                          completion_tokens=sum(c.completion_tokens
                                                for c in live.choices))
        return RequestOutput(
            request_id=live.request_id, service_request_id=live.request_id,
            outputs=[seq], usage=usage, finished=live.finished,
            cancelled=finish == FinishReason.CANCELLED)

    def _cancel(self, engine_rids: List[str], model: str) -> None:
        """Cancel engine requests of ``model``'s runtime (nothing to do
        while it sleeps: its engine is gone)."""
        with self._engine_lock:
            eng = self._runtime_for(model).engine
            if eng is not None:
                for erid in engine_rids:
                    eng.cancel(erid)
        self._work.set()

    def cancel_request(self, service_request_id: str) -> bool:
        """``POST /cancel`` (JAX worker :2542-2561): cancel every engine
        request of a live request; each choice's stream ends with finish
        reason ``cancelled``. False when no such request is in flight."""
        with self._live_lock:
            live = (self._live_srid.get(service_request_id)
                    or self._live.get(service_request_id))
        if live is None:
            return False
        self._cancel(live.engine_rids, live.model)
        return True

    def _finalize(self, live: _LiveRequest) -> None:
        """Consumer-side cleanup: unfinished engine work whose consumer
        is gone (client disconnect, timeout) is cancelled."""
        with self._live_lock:
            self._live_srid.pop(live.request_id, None)
            for erid in live.engine_rids:
                if self._live.get(erid) is live:
                    self._live.pop(erid, None)
        unfinished = [erid for erid, ch in zip(live.engine_rids,
                                               live.choices)
                      if not ch.finished]
        if unfinished:
            self._cancel(unfinished, live.model)
        if self._fault_marked:
            with self._engine_lock:
                self._fault_marked.difference_update(live.engine_rids)

    def _next_output(self, live: _LiveRequest) -> StepOutput:
        try:
            out = live.q.get(timeout=self.opts.request_timeout_s)
        except queue.Empty:
            raise HttpError(504, f"no engine output within "
                                 f"{self.opts.request_timeout_s:g}s",
                            "timeout") from None
        if out is _ABORT:
            raise _WorkerDied("worker died (failpoint)")
        if isinstance(out, _EngineDied):
            raise HttpError(out.status, out.message, out.err_type)
        if isinstance(out, _EngineFault):
            # Blamed by the step fault boundary: the typed error the
            # master counts as a poison strike.
            raise HttpError(500, f"engine_fault: {out.verdict}",
                            "engine_fault")
        return out

    def stream_sse(self, live: _LiveRequest,
                   initial: Optional[List[RequestOutput]] = None
                   ) -> Iterator[bytes]:
        """The client's SSE frames of ``live``: the ``initial`` outputs
        (a migrated first token), then the engine's."""
        asm = (ChatStreamAssembler if live.is_chat
               else CompletionStreamAssembler)(
            live.request_id, live.model, live.include_usage,
            emit_token_ids=live.emit_token_ids)
        try:
            for ro in initial or []:
                yield from asm.on_output(ro)
            while not live.finished:
                try:
                    out = self._next_output(live)
                except HttpError as e:
                    # Headers are sent: a typed error frame, then the end.
                    yield sse_frame({"error": {"message": str(e),
                                               "type": e.err_type,
                                               "code": e.status}})
                    return
                for ro in self._process_step_output(live, out):
                    yield from asm.on_output(ro)
        finally:
            self._finalize(live)

    def collect_full(self, live: _LiveRequest,
                     initial: Optional[List[RequestOutput]] = None
                     ) -> Dict[str, Any]:
        coll = ResponseCollector(live.request_id, live.model, live.is_chat,
                                 target_n=live.target_n)
        try:
            for ro in initial or []:
                coll.add(ro)
            while not live.finished:
                for ro in self._process_step_output(
                        live, self._next_output(live)):
                    coll.add(ro)
        finally:
            self._finalize(live)
        return coll.body()

    # ------------------------------------------------------------------
    # PD disaggregation (JAX worker :3057-3905): prefill here, decode on
    # the routed decode worker; the wire format of the host shuttle is a
    # meta-JSON line, then the K bytes, then the V bytes.
    # ------------------------------------------------------------------
    def _topology2(self) -> bool:
        """The RPC topology: outputs go to the service's fan-in."""
        return self._decode_to_service and bool(self.service_addr)

    @staticmethod
    def pd_route(body: Dict[str, Any], is_chat: bool,
                 name: str) -> Optional[str]:
        """The decode worker a generate body hands its sequence to, or
        None to serve it here (JAX worker :2200-2228): routed here as the
        prefill worker with another decode worker, exactly one choice,
        no ``best_of``, no ``echo``, and more than one token to make."""
        routing = body.get("routing") or {}
        sp = body.get("sampling") or {}
        try:
            max_toks = int(sp.get("max_tokens", body.get("max_tokens", 16)))
            n = int(sp.get("n", body.get("n", 1)))
            best_of = 1 if is_chat else int(
                sp.get("best_of") or body.get("best_of") or n)
        except (TypeError, ValueError):
            return None         # the parse answers the 400
        echo = not is_chat and bool(sp.get("echo", body.get("echo", False)))
        decode = routing.get("decode_name")
        if routing.get("prefill_name") == name and decode \
                and decode != name and max_toks > 1 and n == 1 \
                and best_of <= 1 and not echo:
            return decode
        return None

    def _migration_meta(self, live: _LiveRequest,
                        tokens: List[int]) -> Dict[str, Any]:
        return {"service_request_id": live.request_id,
                "model": live.model, "tokens": list(tokens),
                "prompt_len": len(live.req.token_ids),
                "rope_delta": live.req.rope_delta,
                "mm": _mm_meta(live.req),
                "sampling": live.sampling.to_json(),
                "stream": live.stream}

    def serve_pd_prefill(self, body: Dict[str, Any], is_chat: bool,
                         decode_name: str) -> "_Reply":
        """The prefill side of a PD request: prefill, hold, export, hand
        over by the first transport that takes it, and answer with what
        the decode worker streams back (or, in the RPC topology, the
        ack). A first token that ends the request answers here."""
        live = self._parse_generate(body, is_chat, pd_prefill=True)
        srid = live.request_id
        self.spans.record(srid, "scheduled", plane="worker")
        rt = self._runtime_for(live.model)
        try:
            first = self._next_output(live)
        except HttpError:
            # Cancel, so that a late finish holds no pages.
            with self._engine_lock:
                if rt.engine is not None:
                    rt.engine.cancel(srid)
                    rt.engine.drop_held(srid)
            self._work.set()
            live.choices[0].finished = True
            self._finalize(live)
            raise
        if first.finish_reason in (FinishReason.STOP,
                                   FinishReason.CANCELLED):
            # EOS on the first token (or a cancel): nothing to migrate.
            with self._engine_lock:
                if rt.engine is not None:
                    rt.engine.drop_held(srid)
            ro = self._to_request_output(live, first)
            outs = [ro] if ro is not None else []
            live.choices[0].finished = True
            self._finalize(live)
            if self._topology2():
                self._push_outputs_to_service(outs)
                return _Reply.accepted(srid)
            return self._respond_outputs(live, outs)
        # From here the prefill-side live only carries the request's
        # metadata: the answer is assembled from the decode side's
        # outputs.
        live.choices[0].finished = True
        self._finalize(live)
        if self.failpoints.fire("worker.fail_kv_transfer") is not None:
            # An injected transport failure: every transport is skipped
            # as if the decode worker were unreachable.
            exported = self._export_held(rt, srid)
            if exported is None:
                raise HttpError(500, "prefill KV export failed",
                                "internal_error")
            logger.warning("failpoint worker.fail_kv_transfer: decoding "
                           "%s locally", srid)
            return self._local_decode_fallback(live, *exported)
        peer = (_LOCAL_WORKERS.get(decode_name)
                if self.opts.pd_direct_kv else None)
        if peer is not None and peer is not self:
            return self._migrate_direct(live, peer)
        wire = self._kv_wire_for(decode_name)
        # The export stays on the device for every transport: the wire
        # stages it, the chunked shuttle slices it.
        exported = self._export_held(rt, srid)
        if exported is None:
            raise HttpError(500, "prefill KV export failed",
                            "internal_error")
        tokens, k, v = exported
        if wire is not None:
            reply = self._migrate_device_wire(live, decode_name, tokens,
                                              k, v, wire)
            if reply is not None:
                return reply
        t0 = time.monotonic()
        meta = self._migration_meta(live, tokens)
        total, chunk_bytes = self._shuttle_send_chunks(decode_name, srid,
                                                       k, v)
        if total:
            try:
                chunks = http_stream(
                    "POST", decode_name, "/kv/import",
                    obj=stamp({**meta, "chunked": {"total": total}}),
                    timeout=self.opts.request_timeout_s)
                head = next(chunks, b"")
            except Exception as e:  # noqa: BLE001 — peer unreachable
                logger.warning("chunked kv import to %s failed (%s); "
                               "decoding locally", decode_name, e)
                return self._local_decode_fallback(live, tokens, k, v)
            parsed = self._parse_import_head(head)
            err = (parsed or {}).get("error") or {}
            msg = err.get("message", "") if isinstance(err, dict) else ""
            if parsed is None or parsed.get("status") == "accepted":
                self.kv_migration_bytes += chunk_bytes
                self.kv_migration_seconds += time.monotonic() - t0
                self.kv_migration_chunked += 1
                return self._finish_migration(live, decode_name, tokens,
                                              head, chunks, parsed, k, v)
            chunks.close()
            if not msg.startswith("chunks-missing"):
                # A real refusal: the monolithic retry would meet it too.
                logger.warning("kv import refused by %s (%r); decoding "
                               "locally", decode_name, head[:120])
                return self._local_decode_fallback(live, tokens, k, v)
            logger.warning("chunked staging incomplete on %s; retrying "
                           "monolithic", decode_name)
        payload = encode_kv_block(k, v, extra=stamp(dict(meta)))
        try:
            chunks = http_stream("POST", decode_name, "/kv/import",
                                 raw=payload,
                                 timeout=self.opts.request_timeout_s)
            head = next(chunks, b"")
        except Exception as e:  # noqa: BLE001 — peer unreachable
            logger.warning("kv migration to %s failed (%s); decoding "
                           "locally", decode_name, e)
            return self._local_decode_fallback(live, tokens, k, v)
        self.kv_migration_bytes += len(payload)
        self.kv_migration_seconds += time.monotonic() - t0
        return self._finish_migration(live, decode_name, tokens, head,
                                      chunks, self._parse_import_head(head),
                                      k, v)

    def _export_held(self, rt: ModelRuntime, srid: str):
        """``rt``'s held sequence as device tensors, or None (also when
        the model went to sleep in between)."""
        with self._engine_lock:
            eng = rt.engine
            return (eng.export_held(srid, device=True)
                    if eng is not None else None)

    def _shuttle_send_chunks(self, decode_name: str, srid: str,
                             k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[int, int]:
        """The chunked host shuttle's sends (JAX worker :3232-3296): the
        block sliced along the layers (``XLLM_KV_SHUTTLE_CHUNK_MB`` a
        chunk), every device-to-host copy started first, each chunk
        POSTed to ``/kv/chunk`` as its copy lands. Returns (chunks, bytes
        sent), or (0, 0) when chunking is off, one chunk would do, or a
        send failed (the caller then ships the block whole; the peer's
        TTL drops what it staged). The caller counts the bytes, only on
        an accepted import."""
        chunk_mb = self._kv_shuttle_chunk_mb
        if chunk_mb <= 0:
            return 0, 0
        L = int(k.shape[0])
        layer_bytes = 2 * (k.numel() // max(L, 1)) * k.element_size()
        per_chunk = max(1, int(chunk_mb * 1e6) // max(layer_bytes, 1))
        n = (L + per_chunk - 1) // per_chunk
        if n < 2:
            return 0, 0
        parts = start_host_copies(k, v, n)
        sent = 0
        for idx, (lo, hi, kh, vh, ev) in enumerate(parts):
            if ev is not None:
                ev.synchronize()
            payload = encode_kv_block(kh, vh, extra=stamp({
                "service_request_id": srid, "idx": idx,
                "total": len(parts), "lo": lo, "hi": hi}))
            try:
                status, body = http_stream_status(
                    "POST", decode_name, "/kv/chunk", raw=payload,
                    timeout=self.opts.request_timeout_s)
                body.close()
            except Exception as e:  # noqa: BLE001 — the whole block next
                logger.info("kv chunk %d/%d to %s failed (%s)", idx + 1,
                            len(parts), decode_name, e)
                return 0, 0
            if status != 200:
                logger.info("kv chunk %d/%d refused by %s (HTTP %d)",
                            idx + 1, len(parts), decode_name, status)
                return 0, 0
            sent += len(payload)
        return len(parts), sent

    def serve_kv_chunk(self, raw: bytes) -> "_Reply":
        """``POST /kv/chunk`` (JAX worker :3297-3355): stage one chunk of
        a migrating block on the device under (request, index), for the
        ``/kv/import`` manifest to assemble. Stagings older than 60 s are
        dropped (a prefill worker that died mid-send)."""
        nl = raw.find(b"\n")
        if nl < 0:
            return _Reply.error(400, "missing meta line")
        try:
            meta = json.loads(raw[:nl].decode("utf-8"))
            check_version(meta, "kv_chunk")
            k, v = decode_kv_blob(meta, raw[nl + 1:])
            srid, idx = meta["service_request_id"], int(meta["idx"])
            total = int(meta["total"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            return _Reply.error(400, f"bad kv chunk: {e}")
        dev = self.device
        k, v = k.to(dev, non_blocking=True), v.to(dev, non_blocking=True)
        now = time.monotonic()
        with self._kv_chunk_mu:
            for stale in [r for r, e in self._kv_chunk_staging.items()
                          if now - e["t"] > 60.0]:
                del self._kv_chunk_staging[stale]
                logger.warning("evicted stale kv-chunk staging for %s",
                               stale)
            entry = self._kv_chunk_staging.setdefault(
                srid, {"t": now, "total": total, "parts": {}})
            entry["t"] = now
            entry["parts"][idx] = (k, v)
        return _Reply(200, {"status": "staged"})

    def _pop_staged_chunks(self, srid: str, total: int
                           ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """A complete chunk set as one (k, v), or None when a part is
        missing."""
        with self._kv_chunk_mu:
            entry = self._kv_chunk_staging.pop(srid, None)
        if entry is None or entry["total"] != total \
                or len(entry["parts"]) != total:
            return None
        parts = [entry["parts"][i] for i in range(total)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    @staticmethod
    def _parse_import_head(head: bytes) -> Optional[Dict[str, Any]]:
        """The decode side's ``/kv/import`` answer: a dict for a JSON
        verdict ({} when unparseable), None for an SSE stream to relay."""
        if not head.startswith(b"{"):
            return None
        try:
            return json.loads(head.decode("utf-8")) or {}
        except (ValueError, UnicodeDecodeError):
            return {}

    def _finish_migration(self, live: _LiveRequest, decode_name: str,
                          tokens: List[int], head: bytes, chunks,
                          parsed: Optional[Dict[str, Any]],
                          k: torch.Tensor, v: torch.Tensor) -> "_Reply":
        """Act on the decode side's verdict (JAX worker :3357-3386):
        relay its stream, pass its ack on, or decode here after a
        refusal."""
        if parsed is None:
            return self._relay_decode_stream(live, head, chunks)
        if parsed.get("status") == "accepted":
            return _Reply(200, parsed)
        logger.warning("kv import refused by %s (%r); decoding locally",
                       decode_name, head[:120])
        return self._local_decode_fallback(live, tokens, k, v)

    def _kv_wire_for(self, decode_name: str):
        """This process's device wire, or None when it is off, there is
        none, or the peer answered wire-unsupported before."""
        if not self.opts.pd_device_wire \
                or decode_name in self._wire_refused:
            return None
        return kv_wire.get_device_wire()

    def _migrate_device_wire(self, live: _LiveRequest, decode_name: str,
                             tokens: List[int], k: torch.Tensor,
                             v: torch.Tensor, wire) -> Optional["_Reply"]:
        """The handoff over the device wire (JAX worker :3400-3478): stage
        the block, send a ticket in the ``/kv/import`` meta line, release
        the uuid when the peer answers. None tells the caller to take the
        host shuttle (the block is still in hand)."""
        t0 = time.monotonic()
        try:
            uuid = wire.stage(k, v)
        except Exception as e:  # noqa: BLE001 — the shuttle instead
            logger.warning("kv device-wire staging failed (%s)", e)
            return None
        meta = {**self._migration_meta(live, tokens),
                "transfer": wire.ticket(uuid)}
        try:
            chunks = http_stream(
                "POST", decode_name, "/kv/import",
                raw=json.dumps(stamp(meta)).encode("utf-8") + b"\n",
                timeout=self.opts.request_timeout_s)
            head = next(chunks, b"")
        except Exception as e:  # noqa: BLE001 — peer unreachable
            logger.warning("kv device-wire handshake to %s failed (%s)",
                           decode_name, e)
            # Refused: the ticket never arrived. Anything later is
            # ambiguous: the peer may be copying.
            wire.release(uuid,
                         leaked=not isinstance(e, ConnectionRefusedError))
            return None
        parsed = self._parse_import_head(head)
        err = (parsed or {}).get("error") or {}
        code = err.get("code") if isinstance(err, dict) else None
        if code == 424:
            msg = str(err.get("message", ""))
            if msg.startswith("wire-unsupported:"):
                self._wire_refused.add(decode_name)
                logger.info("decode %s cannot pull the device wire; host "
                            "shuttle from now on", decode_name)
            wire.release(uuid, leaked=msg.startswith("wire-pull:"))
            chunks.close()
            return None
        # Accepted, rejected before a pull (400) or refused after it
        # (503): the segment is free; anything else leaves the pull's
        # state unknown.
        wire.release(uuid, leaked=code not in (None, 400, 503))
        if code is None:
            self.kv_migration_bytes += 2 * k.numel() * k.element_size()
            self.kv_migration_seconds += time.monotonic() - t0
            self.kv_migration_device_wire += 1
        return self._finish_migration(live, decode_name, tokens, head,
                                      chunks, parsed, k, v)

    def _migrate_direct(self, live: _LiveRequest,
                        peer: "Worker") -> "_Reply":
        """The handoff to a decode worker of this process (JAX worker
        :3480-3554): the gathered block stays a device tensor from export
        to the peer's scatter; the peer's outputs are read from its live
        request in-process."""
        srid = live.request_id
        exported = self._export_held(self._runtime_for(live.model), srid)
        if exported is None:
            raise HttpError(500, "prefill KV export failed",
                            "internal_error")
        tokens, k, v = exported
        t0 = time.monotonic()
        ok, dlive, first_out = peer.adopt_migrated(
            self._migration_meta(live, tokens), k, v)
        if not ok:
            if dlive is not None and dlive.stream_to_service:
                return _Reply.accepted(srid)    # a live duplicate
            logger.warning("direct kv migration to %s refused; decoding "
                           "locally", peer.name)
            return self._local_decode_fallback(live, tokens, k, v)
        if peer.device.type == "cuda":
            torch.cuda.synchronize(peer.device)
        self.kv_migration_bytes += 2 * k.numel() * k.element_size()
        self.kv_migration_seconds += time.monotonic() - t0
        self.kv_migration_direct += 1
        if dlive.stream_to_service:
            return _Reply.accepted(srid)
        outs = peer._iter_live_outputs(dlive)
        if live.stream:
            asm = (ChatStreamAssembler if live.is_chat
                   else CompletionStreamAssembler)(
                srid, live.model, live.include_usage,
                emit_token_ids=live.emit_token_ids)

            def gen() -> Iterator[bytes]:
                yield from asm.on_output(first_out)
                for ro in outs:
                    yield from asm.on_output(ro)
            return self._tracked_relay(gen(), outs.close)
        coll = ResponseCollector(srid, live.model, live.is_chat)
        coll.add(first_out)
        for ro in outs:
            coll.add(ro)
        return _Reply(200, coll.body())

    def _tracked_relay(self, frames: Iterator[bytes],
                       *cleanups) -> "_Reply":
        """An SSE reply relaying another worker's stream after this
        worker's own live request ended, counted for the drain (JAX
        worker :3555-3568): counted now, uncounted once when the handler
        closes it, after ``cleanups``."""
        with self._live_lock:
            self._relay_streams += 1

        def uncount() -> None:
            with self._live_lock:
                self._relay_streams -= 1
        return _Reply.sse(_Closing(frames, *cleanups, uncount))

    def _respond_outputs(self, live: _LiveRequest,
                         outs: List[RequestOutput]) -> "_Reply":
        if live.stream:
            asm = (ChatStreamAssembler if live.is_chat
                   else CompletionStreamAssembler)(
                live.request_id, live.model, live.include_usage,
                emit_token_ids=live.emit_token_ids)
            return _Reply.sse(iter([f for ro in outs
                                    for f in asm.on_output(ro)]))
        coll = ResponseCollector(live.request_id, live.model, live.is_chat)
        for ro in outs:
            coll.add(ro)
        return _Reply(200, coll.body())

    def _relay_decode_stream(self, live: _LiveRequest, head: bytes,
                             chunks) -> "_Reply":
        """The decode worker's RequestOutput SSE frames as the client's
        answer (JAX worker :3608-3637)."""

        def payloads() -> Iterator[RequestOutput]:
            def all_chunks():
                if head:
                    yield head
                yield from chunks
            for payload in iter_sse_events(all_chunks()):
                if payload == "[DONE]":
                    return
                yield RequestOutput.from_json(json.loads(payload))

        if live.stream:
            asm = (ChatStreamAssembler if live.is_chat
                   else CompletionStreamAssembler)(
                live.request_id, live.model, live.include_usage,
                emit_token_ids=live.emit_token_ids)

            def gen() -> Iterator[bytes]:
                for ro in payloads():
                    yield from asm.on_output(ro)
            return self._tracked_relay(gen(), chunks.close)
        try:
            return self._respond_outputs(live, list(payloads()))
        finally:
            chunks.close()

    def _local_decode_fallback(self, live: _LiveRequest, tokens: List[int],
                               k, v) -> "_Reply":
        """Decode here when no transport took the sequence (JAX worker
        :3639-3682): adopt the exported block into this engine."""
        srid = live.request_id
        req = EngineRequest(request_id=srid,
                            token_ids=list(live.req.token_ids),
                            sampling=live.sampling,
                            eos_token_ids=live.req.eos_token_ids)
        new_live = _LiveRequest(req, self.tokenizer, live.model,
                                live.is_chat, live.stream,
                                live.include_usage, live.sampling,
                                stream_to_service=self._topology2())
        new_live.emit_token_ids = live.emit_token_ids
        first_out = self._adopted_first_output(new_live, tokens)
        with self._live_lock:
            self._live[srid] = new_live
            self._live_srid[srid] = new_live
        with self._engine_lock:
            eng = self._runtime_for(live.model).engine
            ok = eng is not None and eng.import_sequence(req, tokens, k, v)
            if ok and new_live.stream_to_service:
                self._service_push_buffer.append(first_out)
        if not ok:
            self._drop_live(srid)
            with self._live_lock:
                self._live_srid.pop(srid, None)
            raise HttpError(503, "no local capacity for fallback",
                            "unavailable")
        self._work.set()
        if new_live.stream_to_service:
            return _Reply.accepted(srid)
        if live.stream:
            return _Reply.sse(self.stream_sse(new_live,
                                              initial=[first_out]))
        return _Reply(200, self.collect_full(new_live, initial=[first_out]))

    @staticmethod
    def _adopted_first_output(live: _LiveRequest,
                              tokens: List[int]) -> RequestOutput:
        """The migrated first token as its RequestOutput, counted in the
        choice's completion tokens (it bypasses ``_to_request_output``)."""
        live.choices[0].completion_tokens = 1
        srid = live.request_id
        return RequestOutput(
            request_id=srid, service_request_id=srid,
            outputs=[SequenceOutput(
                index=0, text=live.choices[0].decoder.feed([tokens[-1]]),
                token_ids=[tokens[-1]])])

    def adopt_migrated(self, meta: Dict[str, Any], k, v
                       ) -> Tuple[bool, Optional[_LiveRequest],
                                  Optional[RequestOutput]]:
        """The decode side's adoption (JAX worker :3684-3782), shared by
        ``/kv/import`` and the direct path: (ok, live, first output). A
        duplicate of a live request returns (False, that live, None), so
        the caller can answer idempotently; a refusal (no slot or pages,
        a layout mismatch, a dead engine) returns (False, None, None). A
        multimodal sequence keeps its embeddings, positions, rope streams
        and delta (JAX worker :3717-3736). Counted in ``_inflight_parse`` like every
        work-accepting entry (the direct path has no HTTP handler), and
        refused while draining (JAX worker :3684-3712)."""
        with self._live_lock:
            self._inflight_parse += 1
        try:
            return self._adopt_migrated(meta, k, v)
        finally:
            with self._live_lock:
                self._inflight_parse -= 1

    def _adopt_migrated(self, meta: Dict[str, Any], k, v
                        ) -> Tuple[bool, Optional[_LiveRequest],
                                   Optional[RequestOutput]]:
        model = str(meta.get("model", self.opts.model))
        rt = self._runtime_for(model)
        if self._refuse_new or self.engine_error is not None \
                or rt.engine is None:
            return False, None, None
        tokens = [int(t) for t in meta["tokens"]]
        srid = str(meta["service_request_id"])
        sampling = SamplingParams.from_json(meta.get("sampling"))
        prompt = tokens[:int(meta.get("prompt_len", len(tokens) - 1))]
        mm = meta.get("mm") or None
        req = EngineRequest(
            request_id=srid, token_ids=prompt, sampling=sampling,
            eos_token_ids=self.tokenizer.eos_token_ids,
            rope_delta=int(meta.get("rope_delta", 0) or 0),
            mm_embeds=(multimodal.embeds_from_wire(mm["embeds"]) if mm
                       else None),
            mm_positions=list(mm.get("positions") or []) if mm else None,
            mm_rope_pos=(np.asarray(mm["rope_pos"], np.int32)
                         if mm and mm.get("rope_pos") is not None
                         else None))
        live = _LiveRequest(req, self.tokenizer, model,
                            is_chat=False, stream=bool(meta.get("stream")),
                            include_usage=False, sampling=sampling,
                            stream_to_service=self._topology2())
        with self._live_lock:
            dup = self._live_srid.get(srid)
            if dup is not None:
                # A transport ambiguity (a timeout, then a retry) must
                # not adopt one sequence twice.
                logger.warning("duplicate kv import for %s refused", srid)
                return False, dup, None
            self._live[srid] = live
            self._live_srid[srid] = live
        first_out = self._adopted_first_output(live, tokens)
        with self._engine_lock:
            eng = rt.engine
            ok = eng is not None and eng.import_sequence(req, tokens, k, v)
            if ok and live.stream_to_service:
                # Under the engine lock: ahead of any later step output.
                self._service_push_buffer.append(first_out)
        if not ok:
            self._drop_live(srid)
            with self._live_lock:
                self._live_srid.pop(srid, None)
            return False, None, None
        self._work.set()
        # The decode side's span: received and scheduled in one adoption
        # (JAX worker :3780-3781); the master merges it beside the
        # prefill worker's.
        self.spans.record(srid, "received", plane="worker")
        self.spans.record(srid, "scheduled", plane="worker")
        return True, live, first_out

    def serve_kv_import(self, raw: bytes) -> "_Reply":
        """``POST /kv/import`` (JAX worker :3784-3869), three body forms:
        the meta line and the block's bytes (monolithic shuttle), or a
        meta object alone with a ``chunked`` manifest (the parts came by
        ``/kv/chunk``) or a ``transfer`` ticket (the device wire). A 424
        asks the prefill side to take another transport; a 503 to decode
        locally."""
        nl = raw.find(b"\n")
        try:
            meta = json.loads((raw[:nl] if nl >= 0 else raw)
                              .decode("utf-8"))
            if not isinstance(meta, dict):
                raise ValueError("meta must be an object")
        except (ValueError, UnicodeDecodeError) as e:
            return _Reply.error(400, f"bad meta: {e}")
        check_version(meta, "kv_import")
        if "service_request_id" not in meta or "tokens" not in meta:
            return _Reply.error(400, "bad meta: missing request or tokens")
        chunked, tr = meta.get("chunked"), meta.get("transfer")
        try:
            if chunked is not None:
                got = self._pop_staged_chunks(meta["service_request_id"],
                                              int(chunked.get("total", 0)))
                if got is None:
                    return _Reply.error(
                        424, "chunks-missing: staging incomplete or "
                             "expired")
                k, v = got
            elif tr is not None:
                try:
                    k, v = kv_wire.pull_block(tr)
                except kv_wire.WireUnsupported as e:
                    return _Reply.error(424, f"wire-unsupported: {e}")
                except kv_wire.WireNoPull as e:
                    return _Reply.error(424, f"wire-nopull: {e}")
                except Exception as e:  # noqa: BLE001 — failed mid-pull
                    return _Reply.error(424, f"wire-pull: {e}")
            else:
                k, v = decode_kv_blob(meta, raw[nl + 1:])
        except (ValueError, KeyError, TypeError) as e:
            return _Reply.error(400, str(e))
        srid = str(meta["service_request_id"])
        ok, live, first_out = self.adopt_migrated(meta, k, v)
        if not ok:
            if live is not None and live.stream_to_service:
                return _Reply.accepted(srid)
            return _Reply.error(503, "no capacity on decode instance",
                                "unavailable")
        if live.stream_to_service:
            return _Reply.accepted(srid)
        outs = self._iter_live_outputs(live)

        def gen() -> Iterator[bytes]:
            try:
                yield sse_frame(first_out.to_json())
                for ro in outs:
                    yield sse_frame(ro.to_json())
                    if ro.finished:
                        yield SSE_DONE
                        return
            finally:
                outs.close()
        return _Reply.sse(gen())

    def _iter_live_outputs(self, live: _LiveRequest
                           ) -> Iterator[RequestOutput]:
        """An adopted request's engine outputs as RequestOutputs, until
        it finishes (JAX worker :3871-3905). A timeout cancels it; an
        engine failure ends the iteration with a finished output that
        carries the error. The live request is finalized however the
        consumer leaves."""
        try:
            while not live.finished:
                try:
                    out = self._next_output(live)
                except HttpError as e:
                    yield RequestOutput(
                        request_id=live.request_id,
                        service_request_id=live.request_id,
                        status=Status(StatusCode.INTERNAL, str(e)),
                        finished=True)
                    return
                yield from self._process_step_output(live, out)
        finally:
            self._finalize(live)

    # ------------------------------------------------------------------
    # The cross-worker block fetch
    # ------------------------------------------------------------------
    def serve_kv_blocks(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /kv/blocks`` (JAX worker :3914-3978), the holder's side:
        the K/V of a contiguous run of the requested digests, as a
        staged CUDA IPC ticket (``{"status": "staged", "blocks",
        "transfer"}``) when the ask carries ``FETCH_WIRE`` and the whole
        run is on the device, else as octet-stream bytes (the
        ``encode_kv_block`` meta line with ``blocks``, then K and V).
        The model resolves strictly (a digest hashes token ids only, so
        another model's engine could hold it): one not served here is a
        404, as is a run whose leading digest is no longer held."""
        check_version(body, "kv_blocks")
        model = body.get("model", self.opts.model)
        rt = self.runtimes.get(model)
        if rt is None:
            return _Reply.error(404, f"model {model!r} not served here")
        try:
            hashes = [bytes.fromhex(h) for h in body.get("hashes", [])]
        except (TypeError, ValueError):
            return _Reply.error(400, "bad digest hex")
        if not hashes:
            return _Reply.error(400, "no hashes requested")
        # A worker without a store has no heartbeat loop: its tickets'
        # TTL sweep runs here.
        self._sweep_kv_fetch_staged()
        wire = None
        if body.get("wire") == FETCH_WIRE and self.opts.pd_device_wire:
            wire = kv_wire.get_device_wire()
        t0 = time.monotonic()
        with self._engine_lock:
            eng = rt.engine
            if eng is None:
                return _Reply.error(503, f"model {model!r} asleep",
                                    "unavailable")
            exported = eng.export_blocks(hashes, device=wire is not None)
            pool_device = eng.kv[0].device
        if exported is None:
            # Evicted since the master's index last heard of it: the
            # requester recomputes, and the next beat's removals catch
            # the index up.
            return _Reply.error(404, "blocks no longer held")
        n, k, v = exported
        reply = None
        if wire is not None and k.device == pool_device:
            try:
                uuid = wire.stage(k, v)
            except Exception as e:  # noqa: BLE001 — the bytes instead
                logger.warning("kv block staging failed (%s); serving "
                               "bytes", e)
            else:
                with self._kv_fetch_mu:
                    self._kv_fetch_staged[uuid] = (time.monotonic(), wire)
                reply = _Reply(200, {"status": "staged", "blocks": n,
                                     "transfer": wire.ticket(uuid)})
        with self._kv_fetch_mu:
            self.kv_blocks_served += 1
            self.kv_blocks_export_seconds += time.monotonic() - t0
        if reply is not None:
            return reply
        return _Reply(data=encode_kv_block(k, v,
                                           extra=stamp({"blocks": n})))

    def serve_kv_blocks_done(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /kv/blocks_done {"uuid", "outcome"}`` (JAX worker
        :3980-4000): the requester's word on a staged ticket. ``pulled``
        and ``nopull`` free the segment (this wire's release has no
        drain to run), anything else leaves it reserved as leaked."""
        try:
            uuid = int(body.get("uuid"))
        except (TypeError, ValueError):
            return _Reply.error(400, "invalid body")
        outcome = body.get("outcome", "pulled")
        with self._kv_fetch_mu:
            entry = self._kv_fetch_staged.pop(uuid, None)
        if entry is None:
            return _Reply(200, {"ok": True, "known": False})
        entry[1].release(uuid, leaked=outcome not in ("pulled", "nopull"))
        return _Reply(200, {"ok": True, "known": True})

    def _sweep_kv_fetch_staged(self, ttl: float = 60.0) -> None:
        """Release, as leaked, the tickets no requester acknowledged
        within ``ttl`` seconds (it died mid-pull: whether a copy still
        reads the segment is unknown). At heartbeat cadence, and at each
        ``/kv/blocks``."""
        now = time.monotonic()
        with self._kv_fetch_mu:
            stale = [(u, e[1]) for u, e in self._kv_fetch_staged.items()
                     if now - e[0] > ttl]
            for u, _ in stale:
                del self._kv_fetch_staged[u]
        for u, wire in stale:
            wire.release(u, leaked=True)

    def _maybe_fetch_blocks(self, rt: ModelRuntime, model: str,
                            token_ids: List[int],
                            kvf: Dict[str, Any]) -> None:
        """The requester's side (JAX worker :4016-4145): follow the
        master's ``kv_fetch`` plan before admission. The planned leading
        blocks this worker's pools and host tier do not hold come from
        the holder and are adopted into the pools, so that the admission
        hits them as a local prefix. Every failure (the holder's refusal,
        the transport, a layout or page refusal, an armed
        ``worker.fail_kv_fetch``) is counted and falls back to the
        request's own prefill."""
        eng = rt.engine
        if eng is None or not eng.prefix_cache.enable:
            return
        holder = kvf.get("holder") or ""
        holder_addr = kvf.get("holder_addr") or holder
        try:
            end = int(kvf.get("blocks", 0))
            bs = int(kvf.get("block_size", 0))
        except (TypeError, ValueError):
            return
        if not holder_addr or holder == self.name or end <= 0:
            return
        if bs != eng.ecfg.page_size:
            # Planned on another block size: adopted blocks would be
            # keyed wrong.
            logger.warning("kv fetch plan block_size=%d != page_size=%d; "
                           "recomputing", bs, eng.ecfg.page_size)
            return
        hashes = eng.prefix_cache.block_hashes(token_ids)
        end = min(end, len(hashes))
        with self._engine_lock:
            start = 0
            while start < end and (
                    eng.prefix_cache.page_of(hashes[start]) is not None
                    or (eng.host_tier is not None
                        and hashes[start] in eng.host_tier)):
                start += 1
        if start >= end:
            return              # the local tiers cover the plan
        with self._kv_fetch_mu:
            self.kv_fetch_attempts += 1
        t0 = time.monotonic()
        got = None
        if self.failpoints.fire("worker.fail_kv_fetch") is not None:
            logger.warning("failpoint worker.fail_kv_fetch: recomputing "
                           "%d planned blocks", end - start)
        else:
            try:
                got = self._ask_holder(holder_addr, hashes[start:end],
                                       model)
            except Exception as e:  # noqa: BLE001 — holder unreachable
                logger.warning("kv block fetch from %s failed (%s); "
                               "recomputing", holder_addr, e)
        adopted = 0
        if got is not None:
            k, v, over_wire = got
            t1 = time.monotonic()
            with self._engine_lock:
                adopted = eng.adopt_blocks(token_ids, start, k, v)
            t2 = time.monotonic()
        with self._kv_fetch_mu:
            if not adopted:
                self.kv_fetch_failures += 1
                return
            self.kv_fetch_bytes += 2 * k.numel() * k.element_size()
            self.kv_fetch_seconds += t2 - t0
            self.kv_fetch_adopt_seconds += t2 - t1
            self.kv_fetch_device_wire += int(over_wire)
        logger.info("adopted %d cached blocks from %s in %.1f ms", adopted,
                    holder_addr, 1e3 * (t2 - t0))

    def _ask_holder(self, holder_addr: str, hashes: List[bytes],
                    model: str) -> Optional[Tuple[Any, Any, bool]]:
        """``POST /kv/blocks`` to the holder: (k, v, over the wire), or
        None on a refusal or a bad answer. The CUDA IPC wire is offered
        (``FETCH_WIRE``) when this process has one and the holder is in
        another process that never answered a ticket this process could
        not pull. Such a ticket (a JAX holder's PJRT one, or one of this
        process) is acknowledged ``nopull``, and the same fetch asks once
        more for the bytes, never offering that holder the wire again."""
        offer = (self.opts.pd_device_wire
                 and holder_addr not in _LOCAL_WORKERS
                 and holder_addr not in self._fetch_wire_refused
                 and kv_wire.get_device_wire() is not None)
        for wire in ((True, False) if offer else (False,)):
            status, body_iter = http_stream_status(
                "POST", holder_addr, "/kv/blocks",
                obj=stamp({"model": model,
                           "wire": FETCH_WIRE if wire else False,
                           "hashes": [h.hex() for h in hashes]}),
                timeout=self._kv_fetch_timeout_s)
            raw = b"".join(body_iter)
            if status != 200:
                logger.info("kv block fetch refused by %s (HTTP %d); "
                            "recomputing", holder_addr, status)
                return None
            if not (raw.startswith(b"{") and b"\n" not in raw):
                nl = raw.find(b"\n")
                try:
                    k, v = decode_kv_blob(
                        json.loads(raw[:nl].decode("utf-8")), raw[nl + 1:])
                except (ValueError, KeyError, UnicodeDecodeError) as e:
                    logger.warning("bad kv block payload from %s: %s",
                                   holder_addr, e)
                    return None
                return k, v, False
            # A staged ticket.
            try:
                head = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return None
            if not isinstance(head, dict) or \
                    head.get("status") != "staged" or \
                    not head.get("transfer"):
                return None
            tr = head["transfer"]
            k = v = None
            retry = False
            try:
                k, v = kv_wire.pull_block(tr)
                outcome = "pulled"
            except kv_wire.WireUnsupported:
                outcome, retry = "nopull", True
            except kv_wire.WireNoPull:
                outcome = "nopull"
            except Exception:  # noqa: BLE001 — failed mid-pull
                outcome = "error"
            try:
                http_json("POST", holder_addr, "/kv/blocks_done",
                          {"uuid": tr.get("uuid"), "outcome": outcome},
                          timeout=10.0)
            except Exception:  # noqa: BLE001 — the holder's TTL sweep
                pass            # releases it
            if k is not None:
                return k, v, True
            if not retry:
                logger.info("kv block wire pull from %s failed (%s); "
                            "recomputing", holder_addr, outcome)
                return None
            self._fetch_wire_refused.add(holder_addr)
            logger.info("holder %s staged a ticket this process cannot "
                        "pull; bytes from now on", holder_addr)
        return None

    def flip_role(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /flip_role {"instance_type"}`` (JAX worker :2522-2540):
        take the new role and re-register under its prefix (a fresh lease
        removes the old key), so that the master's lists follow."""
        try:
            self.instance_type = InstanceType(body.get("instance_type", ""))
        except ValueError:
            return _Reply.error(
                400, f"bad instance_type {body.get('instance_type')!r}")
        if self._lease_id is not None:
            try:
                self._register()
            except Exception as e:  # noqa: BLE001 — the next beat's
                logger.warning("flip re-register failed: %s", e)
        return _Reply(200, {"ok": True,
                            "instance_type": self.instance_type.value})

    # ------------------------------------------------------------------
    # The EPD encode plane (JAX worker :2563-3054)
    # ------------------------------------------------------------------
    def _init_encode_plane(self, tower) -> None:
        """The vision tower's state (built at first use, or now on an
        ENCODE worker), the batched encode queue, the content-addressed
        embedding cache and their books; the environment read once
        here."""
        self._vision_tower = tower
        self._vision: Optional[Tuple[str, Any, Any]] = None
        self._vision_lock = make_lock("worker.vision", 90)
        self._vision_image_size = int(os.environ.get(
            "XLLM_VISION_IMAGE_SIZE", "224") or 224)
        try:
            self._encode_timeout_s = float(os.environ.get(
                "XLLM_ENCODE_TIMEOUT_S", "120") or 120)
        except ValueError:
            self._encode_timeout_s = 120.0
        self._encode_q: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self._embed_cache: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._embed_cache_cap = int(os.environ.get(
            "XLLM_EMBED_CACHE_CAP", "256") or 256)
        # The cache, its heartbeat delta (digests stored and evicted since
        # the last delivered beat) and the recent step ms, under this.
        self._embed_mu = make_lock("worker.embedcache", 87)
        self._embed_stored_pending: List[str] = []
        self._embed_removed_pending: List[str] = []
        self._encode_recent_ms: List[float] = []
        self.encode_seconds = 0.0
        self.encode_calls = 0
        self.encode_images_total = 0
        self.encode_steps = 0
        self.encode_cache_hits = 0
        self.encode_cache_misses = 0
        # The embeddings staged on the CUDA IPC wire for a requester's
        # pull, uuid -> (staged at, wire) (JAX worker :780-783); released
        # by /encode_done or the TTL sweep.
        self._encode_staged: Dict[int, Tuple[float, Any]] = {}
        self._encode_staged_mu = make_lock("worker.encstage", 26)
        if self.opts.instance_type == InstanceType.ENCODE:
            self._get_vision()

    @property
    def mm_spliced_tokens(self) -> int:
        """Image tokens the awake engines spliced embeddings over."""
        return sum(eng.mm_spliced_tokens for _, eng in self._awake())

    def _get_vision(self) -> Tuple[str, Any, Any]:
        """(kind, config, encode function) of this worker's tower, built
        at its first use (JAX worker :2625-2684): the one given at
        construction, else the model directory's Qwen2-VL or Qwen2.5-VL
        tower (in the model's dtype, resized to XLLM_VISION_IMAGE_SIZE),
        else the synthetic ViT from seed 0. An encode function maps
        pixels [N, S, S, 3] to float32 embeddings [N, tokens, hidden]."""
        with self._vision_lock:
            if self._vision is None:
                self._vision = self._build_vision()
            return self._vision

    def _build_vision(self) -> Tuple[str, Any, Any]:
        cfg = self.model_cfg
        tower = self._vision_tower
        if tower is None and self.opts.model_dir:
            tower = checkpoint.load_qwen2vl_vision(
                self.opts.model_dir, self.device,
                image_size=self._vision_image_size,
                dtype=getattr(torch, cfg.dtype))
        if tower is None:
            vcfg = (vision.VisionConfig.tiny(cfg.hidden_size)
                    if cfg.name.startswith("tiny")
                    else vision.VisionConfig.for_model(cfg))
            gen = torch.Generator(device=self.device).manual_seed(0)
            tower = (vcfg, vision.init_vision_params(vcfg, gen, self.device))
        vcfg, params = tower
        if isinstance(vcfg, vision.VisionConfig):
            def synthetic(pixels: np.ndarray) -> np.ndarray:
                x = torch.from_numpy(pixels).to(self.device)
                return vision.encode_image(params, vcfg, x).float() \
                    .cpu().numpy()
            return "synthetic", vcfg, synthetic
        if isinstance(vcfg, qwen2vl_vision.Qwen25VLVisionConfig):
            entry = qwen2vl_vision.encode_images_fixed_grid_v25
            kind = "qwen25vl"
        else:
            entry = qwen2vl_vision.encode_images_fixed_grid
            kind = "qwen2vl"
        return kind, vcfg, lambda pixels: entry(params, vcfg, pixels)

    def encode_images(self, mm_inputs: List[Any]) -> np.ndarray:
        """Run this worker's tower on ``mm_inputs`` descriptors -> [N,
        tokens_per_image, hidden] float32, under the engine lock."""
        _kind, vcfg, fn = self._get_vision()
        t0 = time.monotonic()
        pixels = np.stack([multimodal.load_image(m, vcfg.image_size)
                           for m in mm_inputs])
        with self._engine_lock, torch.inference_mode():
            out = fn(pixels)
        self.encode_seconds += time.monotonic() - t0
        self.encode_calls += 1
        self.encode_images_total += len(mm_inputs)
        return out

    def _encode_image_size(self) -> int:
        """The registration's image grid: the built tower's side, 0
        before it is built (registration builds nothing)."""
        with self._vision_lock:
            if self._vision is None:
                return 0
            return int(getattr(self._vision[1], "image_size", 0) or 0)

    def _encode_loop(self) -> None:
        """Drain the encode queue, one tower step per drain (at most 64
        jobs). A job's failure is attached to it; an exception escaping
        the step is a bug, and the supervised thread restarts."""
        while not self._stop.is_set():
            try:
                jobs = [self._encode_q.get(timeout=0.2)]
            except queue.Empty:
                continue
            while len(jobs) < 64:
                try:
                    jobs.append(self._encode_q.get_nowait())
                except queue.Empty:
                    break
            self._encode_step(jobs)

    def _encode_step(self, jobs: List[Dict[str, Any]]) -> None:
        """One encode step (JAX worker :2733-2801): every job's digests
        against the embedding cache, one tower run over all the images it
        missed, the cache filled (LRU) with the beat's delta recorded,
        and each job handed its [N, tokens, hidden] embeddings."""
        t0 = time.monotonic()
        need: List[Tuple[int, int]] = []
        rows: List[List[Optional[np.ndarray]]] = []
        with self._embed_mu:
            for ji, job in enumerate(jobs):
                jrows: List[Optional[np.ndarray]] = []
                for ii, dig in enumerate(job["digests"]):
                    hit = self._embed_cache.get(dig)
                    if hit is not None:
                        self._embed_cache.move_to_end(dig)
                        self.encode_cache_hits += 1
                    else:
                        self.encode_cache_misses += 1
                        need.append((ji, ii))
                    jrows.append(hit)
                rows.append(jrows)
        fresh: Dict[Tuple[int, int], np.ndarray] = {}
        if need:
            try:
                out = self.encode_images([jobs[ji]["mm"][ii]
                                          for ji, ii in need])
            except Exception as e:  # noqa: BLE001 — a bad image spec is
                # the callers' 400, not a dead loop
                for job in jobs:
                    job["err"] = e
                    job["ev"].set()
                return
            with self._embed_mu:
                for pos, (ji, ii) in enumerate(need):
                    emb = np.asarray(out[pos], np.float32)
                    fresh[(ji, ii)] = emb
                    dig = jobs[ji]["digests"][ii]
                    if dig not in self._embed_cache:
                        self._embed_cache[dig] = emb
                        self._embed_stored_pending.append(dig)
                        while len(self._embed_cache) > self._embed_cache_cap:
                            old, _ = self._embed_cache.popitem(last=False)
                            self._embed_removed_pending.append(old)
        step_ms = 1000.0 * (time.monotonic() - t0)
        self.encode_steps += 1
        self.obs.histogram("xllm_worker_encode_step_ms",
                           "wall time of one batched encode step"
                           ).observe(step_ms)
        with self._embed_mu:
            self._encode_recent_ms.append(step_ms)
            del self._encode_recent_ms[:-64]
        for ji, job in enumerate(jobs):
            try:
                job["out"] = np.stack([r if r is not None else fresh[(ji, ii)]
                                       for ii, r in enumerate(rows[ji])])
                job["hits"] = sum(r is not None for r in rows[ji])
            except Exception as e:  # noqa: BLE001 — towers of different
                job["err"] = e      # shapes in one cache: a verdict
            job["ev"].set()

    def encode_via_queue(self, mm_inputs: List[Any],
                         timeout: Optional[float] = None
                         ) -> Tuple[np.ndarray, int]:
        """Encode through the batched queue and the embedding cache:
        (embeddings, cache hits). Raises the job's error (a bad spec is a
        ValueError) or TimeoutError past ``timeout``."""
        job: Dict[str, Any] = {
            "mm": list(mm_inputs),
            "digests": [multimodal.image_digest(m, self.opts.murmur_seed)
                        for m in mm_inputs],
            "ev": threading.Event()}
        self._encode_q.put(job)
        if not job["ev"].wait(timeout if timeout and timeout > 0
                              else 300.0):
            raise TimeoutError("encode queue did not serve the job in time")
        if "err" in job:
            raise job["err"]
        return job["out"], int(job.get("hits", 0))

    def serve_encode(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /encode {"images" | "mm_inputs", "raw", "wire"}`` (JAX
        worker :2827-2881): ``worker.hang_encode`` stalls the handler
        (value: seconds, default 30) and ``worker.fail_encode`` answers a
        500, first; then the embeddings as a staged CUDA IPC ticket
        (``{"status": "staged", "cache_hits", "transfer"}``) when the ask
        carries ``FETCH_WIRE`` and this process has a wire, else as the
        meta line and float32 bytes (``raw``) or base64 JSON, with the
        cache hits. A JAX requester's ``"wire": true`` offers a PJRT wire
        that cannot pull a CUDA IPC ticket: it gets bytes. A bad image
        spec is a 400, a queue that did not serve in time a 503."""
        hang = self.failpoints.fire("worker.hang_encode")
        if hang is not None:
            self._stop.wait(float(hang) if hang is not True else 30.0)
        if self.failpoints.fire("worker.fail_encode") is not None:
            return _Reply.error(500, "injected encode failure "
                                     "(failpoint worker.fail_encode)")
        images = body.get("images") or body.get("mm_inputs") or []
        if not images:
            return _Reply.error(400, "no images")
        # A worker without a store has no heartbeat loop: its tickets'
        # TTL sweep runs here.
        self._sweep_encode_staged()
        try:
            embeds, hits = self.encode_via_queue(images)
        except ValueError as e:
            return _Reply.error(400, str(e))
        except TimeoutError as e:
            return _Reply.error(503, str(e), "unavailable")
        wire = (kv_wire.get_device_wire()
                if body.get("wire") == FETCH_WIRE and self.opts.pd_device_wire
                else None)
        if wire is not None:
            try:
                uuid = wire.stage_one(torch.from_numpy(np.ascontiguousarray(
                    embeds, dtype=np.float32)).to(wire.device))
            except Exception as e:  # noqa: BLE001 — the bytes instead
                logger.warning("embedding staging failed (%s); serving "
                               "bytes", e)
            else:
                with self._encode_staged_mu:
                    self._encode_staged[uuid] = (time.monotonic(), wire)
                return _Reply(200, {"status": "staged", "cache_hits": hits,
                                    "transfer": wire.ticket(uuid)})
        if body.get("raw"):
            meta = multimodal.embeds_raw_meta(embeds)
            meta["cache_hits"] = hits
            return _Reply(data=json.dumps(stamp(meta)).encode("utf-8")
                          + b"\n" + np.ascontiguousarray(
                              embeds, dtype=np.float32).tobytes())
        out = multimodal.embeds_to_wire(embeds)
        out["cache_hits"] = hits
        return _Reply(200, out)

    def serve_encode_done(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /encode_done {"uuid", "outcome"}`` (JAX worker
        :2885-2920): the requester's word on a staged embedding ticket,
        released as ``/kv/blocks_done`` releases a block's."""
        try:
            uuid = int(body.get("uuid"))
        except (TypeError, ValueError):
            return _Reply.error(400, "invalid body")
        outcome = body.get("outcome", "pulled")
        with self._encode_staged_mu:
            entry = self._encode_staged.pop(uuid, None)
        if entry is None:
            return _Reply(200, {"ok": True, "known": False})
        entry[1].release(uuid, leaked=outcome not in ("pulled", "nopull"))
        return _Reply(200, {"ok": True, "known": True})

    def _sweep_encode_staged(self, ttl: float = 60.0) -> None:
        """Release, as leaked, the embedding tickets no requester
        acknowledged within ``ttl`` seconds (JAX worker :2906-2920). At
        heartbeat cadence, and at each ``/encode``."""
        now = time.monotonic()
        with self._encode_staged_mu:
            stale = [(u, e[1]) for u, e in self._encode_staged.items()
                     if now - e[0] > ttl]
            for u, _ in stale:
                del self._encode_staged[u]
        for u, wire in stale:
            wire.release(u, leaked=True)

    def encode_staged_count(self) -> int:
        with self._encode_staged_mu:
            return len(self._encode_staged)

    def _count_encode_fallback(self, reason: str, source: str,
                               target: str) -> None:
        """A routed encode stage not served by its instance: counted and
        an event (JAX worker :2940-2955)."""
        self.obs.counter(
            "xllm_encode_fallback_total",
            "routed encode stages rerouted to a survivor or degraded to "
            "local encode, by reason", labelnames=("reason",)
        ).inc(reason=reason)
        self.events.emit("encode_fallback", reason=reason, source=source,
                         target=target)
        logger.warning("encode fallback (%s): %s -> %s", reason, source,
                       target or "local")

    def _fetch_remote_embeds(self, target: str, mm_inputs: List[Any],
                             timeout: float) -> Tuple[np.ndarray, int]:
        """One ``/encode`` ask of ``target`` (JAX worker :2935-2990): the
        CUDA IPC wire is offered (``FETCH_WIRE``) when this process has
        one and ``target`` is in another process that never staged a
        ticket this process could not pull; a staged ticket is pulled and
        acknowledged with its outcome. A ticket that cannot be pulled is
        acknowledged ``nopull`` and the same target is asked again for
        the bytes (one that can never be pulled bars the target from the
        wire, in ``_fetch_wire_refused``). Else the raw bytes, or a
        base64 JSON answer. Raises on any failure: the caller walks the
        fallbacks."""
        offer = (self.opts.pd_device_wire
                 and target not in _LOCAL_WORKERS
                 and target not in self._fetch_wire_refused
                 and kv_wire.get_device_wire() is not None)
        for wire in ((True, False) if offer else (False,)):
            status, body_iter = http_stream_status(
                "POST", target, "/encode",
                obj=stamp({"images": list(mm_inputs), "raw": True,
                           "wire": FETCH_WIRE if wire else False}),
                timeout=timeout)
            raw = b"".join(body_iter)
            if status != 200:
                raise RuntimeError(f"/encode returned HTTP {status}")
            if not (raw.startswith(b"{") and b"\n" not in raw):
                nl = raw.find(b"\n")
                if nl < 0:
                    raise ValueError("malformed raw embed payload")
                meta = json.loads(raw[:nl].decode("utf-8"))
                check_version(meta, "encode")
                return (multimodal.embeds_from_raw(meta, raw[nl + 1:]),
                        int(meta.get("cache_hits", 0)))
            head = json.loads(raw.decode("utf-8"))
            tr = head.get("transfer")
            if head.get("status") != "staged" or not tr:
                return (multimodal.embeds_from_wire(head),
                        int(head.get("cache_hits", 0)))
            arr, refused = None, False
            try:
                arr = kv_wire.pull_one(tr).cpu().numpy()
                outcome = "pulled"
            except kv_wire.WireUnsupported:
                outcome, refused = "nopull", True
            except kv_wire.WireNoPull:
                outcome = "nopull"
            except Exception:  # noqa: BLE001 — failed mid-pull
                outcome = "error"
            try:
                http_json("POST", target, "/encode_done",
                          {"uuid": tr.get("uuid"), "outcome": outcome},
                          timeout=min(10.0, timeout))
            except Exception:  # noqa: BLE001 — the holder's TTL sweep
                pass            # releases it
            if arr is not None:
                return arr, int(head.get("cache_hits", 0))
            if outcome != "nopull":
                raise RuntimeError(f"embedding wire pull failed ({outcome})")
            if refused:
                self._fetch_wire_refused.add(target)
            logger.info("%s staged embeddings this process cannot pull; "
                        "asking for the bytes", target)
        raise RuntimeError(f"{target} answered no embeddings")

    def _resolve_mm_embeds(self, mm_inputs: List[Any], encode_name: str,
                           fallbacks: Optional[List[str]] = None,
                           srid: str = "") -> np.ndarray:
        """The encode stage (JAX worker :2996-3054): the routed encode
        instance, then its ranked survivors, under one
        XLLM_ENCODE_TIMEOUT_S deadline with jittered pacing between
        attempts, then this worker's own tower: an encode worker's death
        is never the client's error. ``srid``'s span gets ``encoded``
        with the instance that encoded (``remote``, "" for this
        worker), its cache hits, the images and the ms."""
        t_start = time.monotonic()
        deadline = t_start + self._encode_timeout_s
        policy = RetryPolicy(max_attempts=1, base_delay_s=0.05,
                             max_delay_s=2.0, multiplier=2.0, jitter=0.5)
        targets: List[str] = []
        for t in [encode_name] + list(fallbacks or []):
            if t and t != self.name and t not in targets:
                targets.append(t)
        for attempt, target in enumerate(targets):
            remaining = deadline - time.monotonic()
            if remaining <= 0.05:
                self._count_encode_fallback("deadline", target, "local")
                break
            try:
                embeds, hits = self._fetch_remote_embeds(
                    target, mm_inputs, remaining)
            except Exception as e:  # noqa: BLE001 — any failure walks on
                nxt = targets[attempt + 1] if attempt + 1 < len(targets) \
                    else "local"
                self._count_encode_fallback(
                    "unreachable" if isinstance(e, (OSError,
                                                    ConnectionError))
                    else "error", target, nxt)
                policy.sleep(attempt, deadline=deadline,
                             stop_event=self._stop)
                continue
            self._encoded_span(srid, target, hits, mm_inputs, t_start)
            return embeds
        embeds, hits = self.encode_via_queue(
            mm_inputs, timeout=max(deadline - time.monotonic(), 5.0))
        self._encoded_span(srid, "", hits, mm_inputs, t_start)
        return embeds

    def _encoded_span(self, srid: str, remote: str, hits: int,
                      mm_inputs: List[Any], t_start: float) -> None:
        if srid:
            self.spans.record(
                srid, "encoded", plane="worker", remote=remote,
                cache_hits=hits, images=len(mm_inputs),
                ms=round(1000.0 * (time.monotonic() - t_start), 3))

    def _resolve_mm(self, rt: ModelRuntime, body: Dict[str, Any],
                    token_ids: List[int], srid: str = ""
                    ) -> Tuple[List[int], Dict[str, Any]]:
        """A generate body's images (JAX worker :1986-2023): their
        embeddings from the encode stage, each placeholder expanded to
        that many image tokens, and for an mrope model the prompt's 3-D
        rope streams and delta (the merged grid side from the embeddings'
        token count, the one source right whichever worker encoded).
        Returns (the expanded token ids, the EngineRequest's multimodal
        fields)."""
        routing = body.get("routing") or {}
        embeds = self._resolve_mm_embeds(
            list(body["mm_inputs"]), routing.get("encode_name", ""),
            routing.get("encode_fallbacks", []), srid=srid)
        n_img, tpi, _ = embeds.shape
        img_tok = multimodal.image_token_id(rt.model_cfg.vocab_size)
        token_ids, positions = multimodal.expand_image_placeholders(
            token_ids, self.tokenizer.encode(multimodal.IMAGE_PLACEHOLDER),
            n_img, tpi, img_tok)
        mm: Dict[str, Any] = {"mm_embeds": embeds.reshape(n_img * tpi, -1),
                              "mm_positions": positions}
        if rt.model_cfg.is_mrope:
            side = int(round(tpi ** 0.5))
            if side * side != tpi:
                raise ValueError(f"non-square image token count {tpi}; "
                                 f"cannot derive the mrope grid")
            mm["mm_rope_pos"], mm["rope_delta"] = \
                multimodal.mrope_positions(
                    token_ids, img_tok, [(1, 2 * side, 2 * side)] * n_img, 2)
        return token_ids, mm

    def serve_embeddings(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /v1/embeddings {"input", "model"}`` (JAX worker
        :2566-2618): each input's mean-pooled, L2-normalized final hidden
        state. Inputs pad to a power of two in count and length; one
        longer than ``EMBED_MAX_TOKENS`` is a 400."""
        inputs = body.get("input", [])
        if isinstance(inputs, str):
            inputs = [inputs]
        if not inputs:
            return _Reply.error(400, "input is required")
        model = body.get("model", self.opts.model)
        rt = self._runtime_for(model)
        if rt.engine is None:
            return _Reply.error(503, f"model {model} asleep", "unavailable")
        id_lists = [self.tokenizer.encode(t) or [0] for t in inputs]
        for i, ids in enumerate(id_lists):
            if len(ids) > self.EMBED_MAX_TOKENS:
                return _Reply.error(
                    400, f"input {i} is {len(ids)} tokens; the embeddings "
                         f"endpoint accepts at most {self.EMBED_MAX_TOKENS} "
                         f"tokens per input")
        B = 1 << max(len(id_lists) - 1, 0).bit_length()
        T = 1 << max(max(len(i) for i in id_lists) - 1, 0).bit_length()
        toks = np.zeros((B, T), np.int64)
        lens = np.zeros((B,), np.int32)
        for i, ids in enumerate(id_lists):
            toks[i, :len(ids)] = ids
            lens[i] = len(ids)
        if rt.mesh is not None:
            return _Reply.error(501, "/v1/embeddings is not sharded: not "
                                     "available under a mesh",
                                "not_implemented")
        with self._engine_lock, torch.inference_mode():
            eng = rt.engine
            if eng is None:
                return _Reply.error(503, f"model {model} asleep",
                                    "unavailable")
            out = forward_embedding(
                eng.params, rt.model_cfg,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device), eng.kv).cpu()
        total = int(lens.sum())
        return _Reply(200, {
            "object": "list", "model": model,
            "data": [{"object": "embedding", "index": i,
                      "embedding": out[i].tolist()}
                     for i in range(len(id_lists))],
            "usage": {"prompt_tokens": total, "total_tokens": total}})

    def guarded(self, fn, *args) -> "_Reply":
        """Every work-accepting route (JAX worker :2110-2127): counted in
        ``_inflight_parse`` before the refusal check (the other order
        races a drain's sample of the counters), refused with a 503 while
        draining or dead. By the time ``fn`` returns, its request is
        refused, served, or registered in ``_live_srid`` or
        ``_relay_streams``."""
        with self._live_lock:
            self._inflight_parse += 1
        try:
            if self._refuse_new:
                return _Reply.error(503, "instance is draining",
                                    "unavailable")
            return fn(*args)
        finally:
            with self._live_lock:
                self._inflight_parse -= 1

    def _ingress_span(self, srid: str, t_recv: float, headers) -> None:
        """Open this worker's side of the request's span (JAX worker
        :2156-2166) under the id the master used; the correlation header
        it stamped on the forward is kept as an attr."""
        corr = headers.get(REQUEST_ID_HEADER, "")
        if corr:
            self.spans.annotate(srid, correlation_header=corr)
        self.spans.record(srid, "received", plane="worker", t_mono=t_recv)

    def serve_generate(self, body: Dict[str, Any], is_chat: bool,
                       headers, t_recv: float) -> "_Reply":
        """``POST /v1/completions`` and ``/v1/chat/completions``: the
        failpoints, then the PD handoff or a local request: the RPC
        topology's ack, an SSE stream, or the whole response. The span
        is ``received`` at ``t_recv`` (the handler's entry; ``headers``
        are the request's) and ``scheduled`` once the engine holds the
        request."""
        self.generate_failpoints()
        srid_hint = body.get("service_request_id") or ""
        if srid_hint:
            self._ingress_span(srid_hint, t_recv, headers)
        decode = self.pd_route(body, is_chat, self.name)
        if decode is not None:
            return self.serve_pd_prefill(body, is_chat, decode)
        live = self._parse_generate(body, is_chat)
        if not srid_hint:       # sent straight here: the id was minted
            self._ingress_span(live.request_id, t_recv, headers)
        self.spans.record(live.request_id, "scheduled", plane="worker")
        if live.stream_to_service:
            # The RPC topology: the outputs go to the service's fan-in;
            # this reply is the ack it waits for.
            return _Reply.accepted(live.request_id)
        if live.stream:
            return _Reply.sse(_Closing(self.stream_sse(live),
                                       lambda: self._finalize(live)))
        return _Reply(200, self.collect_full(live))

    def models_body(self) -> Dict[str, Any]:
        """``GET /v1/models``: every runtime with its state."""
        return {"object": "list",
                "data": [{"id": m, "object": "model",
                          "owned_by": "xllm-service-tpu", "state": rt.state}
                         for m, rt in list(self.runtimes.items())]}

    def weights_body(self, model: str) -> Dict[str, Any]:
        """``GET /admin/weights?model=``: the awake model's weights as
        per-leaf sha256 digests (``checkpoint.param_digests``: equal
        digests are bit-equal weights), their bytes, and the last boot's
        or wake's timings (where they came from, the load's seconds and
        bytes). The primary model without ``model``. Only the reference
        to the parameters is taken under the engine lock: the hash runs
        outside it, so the streams keep stepping (no step writes a
        weight, and a sleep meanwhile only frees them after the hash)."""
        rt = self.runtimes.get(model) if model else self.primary_runtime()
        if rt is None:
            raise HttpError(404, f"model {model} not on this worker")
        with self._engine_lock:
            eng = rt.engine
            if eng is None:
                raise HttpError(409, f"model {rt.model} is asleep",
                                "unavailable")
            params = eng.params
        digests = checkpoint.param_digests(params)
        nbytes = _params_bytes(params)
        return {"model": rt.model, "digests": digests, "bytes": nbytes,
                **{k: rt.timings.get(k) for k in ("source", "load_s",
                                                  "load_bytes")}}

    # ------------------------------------------------------------------
    # Several models: staging, sleep and wake (JAX worker :2469-2520)
    # ------------------------------------------------------------------
    def fork_master(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /fork_master {"models"}``: stage more models asleep
        (nothing on the device until a wake)."""
        created = []
        for model in body.get("models", []):
            if model in self.runtimes:
                continue
            try:
                cfg = resolve_model_config(model)
            except ValueError as e:
                return _Reply.error(400, str(e))
            self.runtimes[model] = ModelRuntime(
                model, cfg, self.engine_cfg, self.device,
                murmur_seed=self.opts.murmur_seed, start_asleep=True)
            created.append(model)
        return _Reply(200, {"ok": True, "created": created})

    @contextlib.contextmanager
    def _model_flip(self) -> Iterator[None]:
        """Hold the engine loop between steps (it yields to a waiting
        flip) and the engine lock; on the way out, wait for a beat in
        flight: one built before a model's state flipped lands before the
        route answers, not after, with the old state."""
        with self._flip_mu:
            self._flips_waiting += 1
        try:
            self._loop_mu.acquire()
        finally:
            with self._flip_mu:
                self._flips_waiting -= 1
        try:
            with self._engine_lock:
                yield
        finally:
            self._loop_mu.release()
        with self._hb_lock:
            pass

    def sleep_model(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /sleep {"model"}``: park the model's parameters on the
        host and free its device memory (``ModelRuntime.sleep``), after
        the engine loop's current step. Its requests in flight end with a
        503 (the JAX worker leaves them to their timeout)."""
        model = body.get("model", "")
        rt = self.runtimes.get(model)
        if rt is None:
            return _Reply.error(404, f"model {model} not on this worker")
        with self._model_flip():
            rt.sleep()
        self._end_lives(f"model {model} was put to sleep", model=model,
                        status=503, err_type="unavailable")
        return _Reply(200, {"ok": True, "model": model, "state": rt.state})

    def wakeup_model(self, body: Dict[str, Any]) -> "_Reply":
        """``POST /wakeup {"model"}``: a new engine on the parked (or, for
        a staged model, random) parameters, and the worker's warmup ladder
        captured again under the engine lock; a 409 while draining (a
        wake would advertise the model awake again)."""
        if self._draining:
            return _Reply.error(409, "instance is draining", "unavailable")
        model = body.get("model", "")
        rt = self.runtimes.get(model)
        if rt is None:
            return _Reply.error(404, f"model {model} not on this worker")
        with self._model_flip():
            woke = rt.state != MODEL_AWAKE
            rt.wakeup()
            if woke and self._should_warmup():
                rt.timings["warmup_s"] = self.warmup(rt)
        self._work.set()
        return _Reply(200, {"ok": True, "model": model, "state": rt.state})


def _response(reply: "_Reply") -> Response:
    """A route's ``_Reply`` as the server's ``Response``: an SSE stream,
    octet-stream bytes, or a JSON body."""
    if reply.frames is not None:
        return Response.sse(reply.frames)
    if reply.data is not None:
        return Response(reply.status, reply.data,
                        content_type="application/octet-stream")
    return Response.json(reply.body or {}, reply.status)


def _dropped() -> Iterator[bytes]:
    """The body of a request whose worker died (simulated) before it
    answered: it fails at once, so that the server ends the connection
    with no complete answer, as a killed process's would."""
    raise _WorkerDied("worker died (failpoint)")
    yield b""       # a generator: the raise comes at the server's first read


def _json_body(req: Request) -> Dict[str, Any]:
    try:
        body = json.loads(req.body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError):
        raise HttpError(400, "invalid JSON body") from None
    if not isinstance(body, dict):
        raise HttpError(400, "request body must be an object")
    return body


def _route(fn, body_of=_json_body, internal_500: bool = False):
    """A router handler around ``fn(body, req)``: ``HttpError`` becomes
    its typed answer, ``_WorkerDied`` a dropped connection, and with
    ``internal_500`` any other exception a 500 naming the path (the
    control routes: a refused /sleep would desync the master's model
    states). Without it, the router's own 500 answers."""
    def handler(req: Request) -> Response:
        try:
            return _response(fn(body_of(req), req))
        except HttpError as e:
            return Response.error(e.status, str(e), e.err_type)
        except _WorkerDied:
            return Response(200, content_type="text/event-stream",
                            stream=_dropped())
        except Exception as e:  # noqa: BLE001
            if not internal_500:
                raise
            logger.exception("%s failed", req.path)
            return Response.error(500, f"{req.path}: {e!r}",
                                  "internal_error")
    return handler


def _query_float(req: Request, name: str) -> float:
    try:
        return float(req.param(name, "0") or 0)
    except ValueError:
        return 0.0


# The routes that admission never sheds (JAX worker :815-829): the
# shared control plane, the control verbs, and the continuations of a
# request already admitted elsewhere (a PD import, a block fetch, an
# encode for a request in flight).
ADMISSION_EXEMPT = _ADMISSION_EXEMPT + (
    "/sleep", "/wakeup", "/cancel", "/flip_role", "/fork_master",
    "/kv/import", "/kv/chunk", "/kv/blocks", "/kv/blocks_done", "/encode",
    "/encode_done")


def build_router(worker: Worker) -> Router:
    """The worker's routes, with the JAX worker's paths and methods
    (plus ``GET /admin/weights``)."""
    w = worker
    r = Router()
    r.route("GET", "/hello", lambda req: Response.json({"ok": True}))
    r.route("GET", "/v1/models",
            lambda req: Response.json(w.models_body()))
    r.route("GET", "/metrics", lambda req: Response(
        200, w.metrics_text().encode(),
        content_type="text/plain; version=0.0.4"))
    r.route("GET", "/admin/failpoints",
            lambda req: Response.json(w.failpoints.state()))
    r.route("GET", "/admin/weights", _route(
        lambda _, req: _Reply(200, w.weights_body(req.param("model"))),
        body_of=lambda req: None))
    r.route("GET", "/admin/steptrace", lambda req: Response.json(
        w.steptrace_body(int(_query_float(req, "n")),
                         _query_float(req, "seconds"))))

    def generate(is_chat: bool):
        def fn(body, req):
            return w.guarded(w.serve_generate, body, is_chat, req.headers,
                             time.monotonic())
        return _route(fn)

    r.route("POST", "/v1/completions", generate(False))
    r.route("POST", "/v1/chat/completions", generate(True))

    def arm_failpoint(body, req):
        try:
            w.failpoints.arm_from_body(body)
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e)) from e
        return _Reply(200, {"ok": True, "state": w.failpoints.state()})

    r.route("POST", "/admin/failpoint", _route(arm_failpoint))
    r.route("POST", "/cancel", _route(lambda body, req: _Reply(
        200, {"ok": w.cancel_request(
            str(body.get("service_request_id", "")))})))
    # The control routes, exempt from the drain's refusal (JAX worker
    # :815-830): a refused /sleep would desync the master's model
    # states, a refused /kv/blocks_done leaks a staged segment.
    for path, fn in (("/sleep", w.sleep_model), ("/wakeup", w.wakeup_model),
                     ("/fork_master", w.fork_master),
                     ("/flip_role", w.flip_role),
                     ("/kv/blocks_done", w.serve_kv_blocks_done),
                     ("/encode", w.serve_encode),
                     ("/encode_done", w.serve_encode_done)):
        r.route("POST", path, _route(lambda body, req, fn=fn: fn(body),
                                     internal_500=True))
    for path, fn in (("/kv/blocks", w.serve_kv_blocks),
                     ("/v1/embeddings", w.serve_embeddings)):
        r.route("POST", path, _route(
            lambda body, req, fn=fn: w.guarded(fn, body), internal_500=True))
    # The PD handoff's octet-stream routes.
    for path, fn in (("/kv/import", w.serve_kv_import),
                     ("/kv/chunk", w.serve_kv_chunk)):
        r.route("POST", path, _route(lambda raw, req, fn=fn: w.guarded(
            fn, raw), body_of=lambda req: req.body))
    return r


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="OpenAI worker on the PyTorch/CUDA engine")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    # A catalog name, or with --model-dir any name for the directory's
    # config.json (JAX worker CLI :4527).
    p.add_argument("--model", default="tiny",
                   help=f"model name (catalog: {', '.join(_MODEL_REGISTRY)})")
    p.add_argument("--model-dir", default="",
                   help="HuggingFace model directory: config.json, the "
                        "tokenizer and the *.safetensors weights")
    p.add_argument("--device", default="cuda")
    p.add_argument("--instance-type", default=InstanceType.DEFAULT.value,
                   choices=[t.value for t in InstanceType])
    p.add_argument("--service-addr", default="",
                   help="service RPC host:port for heartbeats")
    p.add_argument("--store-addr", default="",
                   help="coordination store: host:port of a StoreServer, "
                        "etcd://host:port of an etcd v3 JSON gateway ('' "
                        "with a --service-addr = private in-process "
                        "store)")
    p.add_argument("--heartbeat-interval-s", type=float, default=3.0)
    # Must equal the service's --murmur-hash3-seed.
    p.add_argument("--murmur-seed", type=int, default=0)
    d = EngineConfig()
    p.add_argument("--page-size", type=int, default=d.page_size)
    p.add_argument("--num-pages", type=int, default=d.num_pages)
    p.add_argument("--max-model-len", type=int, default=d.max_model_len)
    p.add_argument("--max-batch-size", type=int, default=d.max_batch_size)
    p.add_argument("--max-prefill-tokens", type=int,
                   default=d.max_prefill_tokens)
    p.add_argument("--prefill-buckets",
                   default=",".join(map(str, d.prefill_buckets)),
                   help="comma-separated prefill window buckets")
    p.add_argument("--decode-steps", type=int, default=d.decode_steps,
                   help="decode steps fused into one dispatch")
    p.add_argument("--warmup", dest="warmup", default=None,
                   action="store_true",
                   help="capture the engine's graphs before serving "
                        "(default: auto, on for CUDA)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false")
    p.add_argument("--pd-direct-kv", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="PD handoff to a decode worker of this process "
                        "as device tensors")
    p.add_argument("--pd-device-wire", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="PD handoff and block fetch between processes "
                        "over CUDA IPC (else bytes over HTTP)")
    p.add_argument("--enable-profiling", action="store_true",
                   help="measure TTFT/TPOT samples for the registration")
    p.add_argument("--max-concurrency", type=int,
                   default=WorkerOptions.max_concurrency,
                   help="concurrent entry requests before a 503 with "
                        "Retry-After (0 = no cap)")
    p.add_argument("--role", default="", choices=["", "encode"],
                   help="encode: serve the vision tower only (the model "
                        "sleeps; registers as ENCODE)")
    # The mesh (parallel/mesh.py): one process per rank; without
    # --dist-* this worker starts its other ranks itself.
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--dist-coordinator", default="",
                   help="host:port of process 0's rendezvous (a world "
                        "started by the caller; '' = this worker starts "
                        "its ranks)")
    p.add_argument("--dist-num-processes", type=int, default=0)
    p.add_argument("--dist-process-id", type=int, default=-1,
                   help="this process's rank; > 0 runs the follower loop")
    p.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                   help="collectives' backend ('' = nccl on CUDA, gloo on "
                        "the CPU; two ranks on one card need gloo)")
    return p.parse_args(argv)


def build_worker(args: argparse.Namespace,
                 params: Optional[Params] = None,
                 model_cfg: Optional[ModelConfig] = None) -> Worker:
    """The Worker the CLI serves, from parsed arguments (``params``:
    weights to serve instead of random ones from the engine's seed;
    ``model_cfg``: the model to serve instead of the one ``--model`` and
    ``--model-dir`` resolve to)."""
    ecfg = engine_config(args)
    opts = WorkerOptions(
        host=args.host, port=args.port, model=args.model,
        model_dir=args.model_dir, device=args.device, warmup=args.warmup,
        instance_type=InstanceType(args.instance_type),
        service_addr=args.service_addr, store_addr=args.store_addr,
        heartbeat_interval_s=args.heartbeat_interval_s,
        murmur_seed=args.murmur_seed, pd_direct_kv=args.pd_direct_kv,
        pd_device_wire=args.pd_device_wire,
        enable_profiling=args.enable_profiling,
        encode_only=args.role == "encode",
        max_concurrency=args.max_concurrency, ep=args.ep,
        dist_coordinator=args.dist_coordinator,
        dist_num_processes=args.dist_num_processes,
        dist_process_id=args.dist_process_id,
        dist_backend=args.dist_backend)
    return Worker(opts, engine_cfg=ecfg, model_cfg=model_cfg, params=params)


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The engine config the CLI's arguments name."""
    return EngineConfig(
        page_size=args.page_size, num_pages=args.num_pages,
        max_model_len=args.max_model_len,
        max_batch_size=args.max_batch_size,
        max_prefill_tokens=args.max_prefill_tokens,
        prefill_buckets=tuple(int(b) for b in
                              args.prefill_buckets.split(",") if b),
        decode_steps=args.decode_steps, tp=args.tp, dp=args.dp, sp=args.sp)


def run_rank(args: argparse.Namespace) -> int:
    """A process of a caller-started world whose id is not 0: build its
    shard of the model the arguments name and follow process 0."""
    ecfg = engine_config(args)
    spec = MeshSpec(dp=args.dp, ep=args.ep, sp=args.sp, tp=args.tp)
    if args.dist_num_processes not in (0, spec.num_devices):
        raise ValueError(f"--dist-num-processes {args.dist_num_processes} "
                         f"is not the mesh's {spec.num_devices} ranks")
    devices = [args.device] * spec.num_devices
    launch = ranks.Launch(
        resolve_model_config(args.model, args.model_dir), ecfg, spec,
        devices, args.dist_backend or default_backend(args.device),
        f"tcp://{args.dist_coordinator}", model_dir=args.model_dir,
        murmur_seed=args.murmur_seed)
    calls = ranks.run_follower(launch, args.dist_process_id)
    logger.info("rank %d: followed %d runner calls", args.dist_process_id,
                calls)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.dist_coordinator and args.dist_process_id > 0:
        return run_rank(args)
    w = build_worker(args)
    w.start()
    print(f"XLLM_TORCH_WORKER_UP http={w.name}", flush=True)

    def on_signal(signum, frame) -> None:
        w._stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    w.serve_forever()
    w.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
