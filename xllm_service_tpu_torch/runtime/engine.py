"""Continuous-batching inference engine over the paged KV cache.

The counterpart of the JAX package's ``runtime/engine.py`` for one model
on one CUDA device (or on the CPU, where every kernel runs its plain
version). Each ``step()`` is one iteration of the JAX engine's
scheduler:

- interleaved (the default): decode every running sequence in one
  fixed-slot batch of ``max_batch_size`` rows, then spend what is left
  of ``step_token_budget`` on prefill windows. Once the oldest waiting
  prompt has queued past ``prefill_deadline_ms``, that residual is
  floored at the smallest prefill bucket;
- prefill-first (``interleave=False``): prefill whole-bucket windows if
  any prompt can be scheduled, else decode;
- ragged (``ragged_attn``): an interleaved iteration that both decodes
  and prefills runs as ONE forward over a ragged batch, the decode rows
  as length-1 continuation windows first, then the prefill windows,
  each layer attending with the ragged kernel.

Decode and prefill forwards write the KV in the order
``write_then_attend`` picks (see ``models/transformer.py``), resolved
once at init as the JAX engine resolves it: the config's value or the
``XLLM_WRITE_THEN_ATTEND`` environment, else on for a CUDA engine
(where the kernels run, as the JAX engine's default follows its Pallas
switch) and off on the CPU (as on the JAX engine's pure-XLA path). The
ragged step always writes first.

A prompt prefills in windows of at most one bucket of
``prefill_buckets``; an interleaved window snaps down to the largest
bucket that fits the residual budget, so prompts longer than it prefill
in chunks over several steps, each window starting where the last
ended. A batch pads to a power of two rows and its window to the bucket
that holds the longest window. Tokens are sampled on the device inside
the step (``ops/sampling.py``) with each request's ``logit_bias``, and
in decode its presence and frequency penalties over a [B, V] count of
its generated tokens, which the decode steps update on the device and
the engine rebuilds from its token lists wherever the batch changed
outside a decode (``_ensure_counts``, as the JAX engine). A seeded row
draws the JAX package's threefry noise from (seed, position), so its
stream equals the JAX engine's. Only the sampled ids, their logprobs
and, when a request asked for logprobs, the top-k alternatives
(``num_top_logprobs``) cross to the host. A prompt-scored request (echo
with logprobs) prefills alone and skips prefix hits; its window scores
are stitched into ``prompt_logprobs`` on its first sampled token.

Pages are allocated as the JAX engine allocates them: admission takes
only the pages of the first window (plus the first sampled token's when
that window completes the prompt), a later window extends the table to
cover it, and every decode grows it to cover the token it writes. When
the pool runs out, the most recently arrived offline request holding
pages is preempted by recompute (its slot and pages are released and it
requeues with its generated tokens, to be prefilled again); with no
offline victim, the sequence that needs the pages is its own victim.
Online requests queue before offline ones. Only a prompt whose KV can
never fit the pool is refused.

The prefix cache (``enable_prefix_cache``, ``runtime/kv_cache.py``)
registers every full page under its chained block digest as the
sequence fills it, and at its finish or preemption. Admission matches
the prompt's leading full pages, restores the ones the host spill tier
holds (``kv_spill_mb``), allocates only the pages past the hit, and
prefills from the cached start. Released pages stay reclaimable until
allocation pressure takes them (LRU), spilling them to the host tier
first when it is on. The digests stored, removed and offloaded drain
into the worker's heartbeat (``drain_kvcache_event``).

Multimodal requests (the EPD path), as the JAX engine serves them: a
request's ``mm_embeds`` rows splice over its prompt's image tokens
(``mm_positions``) in whichever prefill windows hold them, through the
prefill runner's embedding buffer; an mrope model's prompt rotates by
its ``mm_rope_pos`` streams and its generated tokens at position +
``rope_delta``, a per-slot decode input. Such sequences neither hit nor
feed the prefix cache (their KV depends on the images, not only on the
token ids), and an mrope model never takes the ragged step (its decode
rows need the delta, as in the JAX engine). ``mm_spliced_tokens``
counts the embedding rows spliced.

Uniform sliding-window models release the leading pages that every
later window masks (``_swa_trim``); the freed table entries become the
NULL page 0, which every kernel reads only in window-masked lanes.

A sequence finishes on EOS, a stop token id, ``max_tokens`` or
``max_model_len``; its slot is freed and its pages are released then.

PD disaggregation, as the JAX engine hands a sequence over: a request
with ``hold_after_finish`` (a PREFILL worker's, sampling its first token
only) keeps its pages when it finishes, unless it was cancelled;
``export_held`` gathers their K/V ([L, n, page_size, H, D] from each
pool, both pools of an MLA model as the JAX engine ships them) and
releases them, ``drop_held`` releases them unread, and
``import_sequence`` adopts such a block on the decode side as a RUNNING
sequence with the first token still to be written. The gather and the
scatter are plain tensor indexing, as the JAX engine's are XLA.

The cross-worker block fetch, as the JAX engine serves it: on the holder,
``export_blocks`` gathers the K/V of a contiguous run of block digests
out of the pools, extended with blocks parked in the host tier; on the
requester, ``adopt_blocks`` scatters such a run into fresh pages, in
place, and registers them under their digests as cached, reclaimable
pages, so that the request's admission hits them like a local prefix.

Decode runs through ``runtime/decode_graph.py``: one CUDA graph per
(table width, steps, sampling mode), captured by ``warmup()`` (or at a
key's first use), as the JAX engine compiles its decode programs. With
``decode_steps = N > 1`` one dispatch runs N forwards, each feeding its
sampled token forward on the device; the host accepts each sequence's
tokens up to its first stop, and one ``StepOutput`` carries the burst.
With the pipeline (``decode_pipeline``) burst k+1 is dispatched from
burst k's device-resident carries before burst k is read back, and
discarded, with the generator's state restored, when burst k's post
changed the batch; token streams are those of the pipeline off.

Prefill, prefill-first and ragged steps run through
``runtime/prefill_graph.py``: one CUDA graph per (kind, pow2 rows,
bucket, table width, sampling mode), in the decode graphs' memory pool,
the counterpart of ``_jit_prefill`` / ``_jit_ragged``. ``warmup()``
captures the JAX engine's ladder of both runners; a shape it missed is
captured at first use and counted after warmup, by program
(``capture_report()``; ``compile_report()`` counts every program's
graphs). The prefix cache's restore runs before the forward, outside
the graph.

The step fault boundary's engine side, as the JAX engine's: every
section records its batch (``step_members``) and calls ``fault_hook``
(the worker's failpoint hook, which may raise) before it stages or
packs anything; ``last_step_partial_outs`` is the list the sections of
a step extend, so that a worker can salvage the outputs of the sections
that completed before a fault. ``isolate`` confines the next step to a
set of requests (the others are preempted or parked, and new arrivals
park), ``release_isolation`` undoes it, and ``fault_reset`` evicts the
blamed requests and requeues every survivor for re-prefill with its
tokens, releasing its pages unregistered and marking the device state
the runners keep between steps stale, to be rebuilt from host truth.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the engine is one rank
of a sharded instance: it slices the full parameters to its shard
(``parallel/sharding.shard_params``), holds its share of the KV pools
and runs the forwards with its view of the model
(``shard_config``). Rank 0 schedules; every call it makes on its
runners that touches their device state is broadcast to the other
ranks first, which make the same call on theirs
(``runtime/ranks.py``), so that the collectives inside the forwards
meet. The sharded steps run eagerly: ``cuda_graphs=True`` with a mesh
of several ranks raises. The decode pipeline saves and restores the
generator through the decode runner, so every rank's sampler stays in
step across a discarded speculation. With an
sp axis, a prompt longer than the largest bucket and at most ``sp``
buckets long prefills in ONE ring step (``forward_prefill_ring``;
``_ring_eligible``), counted under ``prefill_ring`` in the step census.
The KV plane (the PD export and import, the block fetch, the host spill
tier) moves full-head blocks [L, n, page_size, Hkv, D], the layout of an
unsharded engine's pools, through ``kv_plane`` (``ranks.KvPlane``):
rank 0 gathers the pages' heads from the ranks holding them, or sends
each rank its slice. A multimodal splice's embedding rows reach every
rank whole, in a tensor broadcast of their own
(``PrefillGraphs.stage_mm``); the mrope streams ride the packed step
buffer and the decode runner's staged deltas. A call
that leaves the ranks out of step (a fault between a launch and its
agreement) re-forms the world before its error goes on (``_rejoin``),
so that the worker contains it as with one rank.

``warmup()`` also fills ``roofline``: program -> variant key ->
{"flops", "bytes", "tokens"} from the analytic count of
``models/cost.py``, keyed as the JAX engine keys its ``cost_analysis``
table (``obs/steptrace.py`` reads it).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import enum
import functools
import os
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence as Seq,
                    Tuple)

import numpy as np
import torch

from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import cost, transformer
from xllm_service_tpu_torch.ops.kernels import paged_attention
from xllm_service_tpu_torch.ops.sampling import (SamplingTensors,
                                                 batch_bias, batch_mode)
from xllm_service_tpu_torch.parallel import sharding
from xllm_service_tpu_torch.parallel.mesh import AXIS_SP, Mesh
from xllm_service_tpu_torch.runtime import decode_graph, prefill_graph, ranks
from xllm_service_tpu_torch.runtime.kv_cache import (HostKvTier,
                                                     KvCacheEvent,
                                                     PageAllocator,
                                                     PrefixCacheIndex)
from xllm_service_tpu_torch.utils.types import FinishReason, SamplingParams


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (there is
    no silent move to the CPU: callers ask for it with device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_write_then_attend(flag: Optional[bool],
                              device: torch.device) -> bool:
    """``EngineConfig.write_then_attend`` for an engine on ``device``:
    an explicit value wins; None means on where the CUDA kernels run."""
    return device.type == "cuda" if flag is None else bool(flag)


def resolve_cuda_graphs(flag: Optional[bool], device: torch.device) -> bool:
    """``EngineConfig.cuda_graphs`` for an engine on ``device``: None
    means on for CUDA; there are no graphs on the CPU."""
    if device.type != "cuda":
        return False
    return True if flag is None else bool(flag)


_GREEDY = SamplingParams(temperature=0.0)
# The sampling variants every warmed shape is captured in: (greedy,
# seeded) = greedy, sampled, sampled with a seeded row. Decode captures
# each with and without the penalty counts; every one at the default
# logit-bias width.
_VARIANTS = ((True, False), (False, False), (False, True))


@dataclasses.dataclass
class EngineRequest:
    """A tokenized generation request."""

    request_id: str
    token_ids: List[int]
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # Offline (batch-tier) requests queue behind online ones and are the
    # first victims when the pool runs out.
    offline: bool = False
    eos_token_ids: Tuple[int, ...] = ()
    arrival_time: float = 0.0
    # Completion-API echo with logprobs: score every prompt token (the
    # first is None: nothing to condition on). Such a sequence prefills
    # alone, through the prompt-scoring graph, and skips prefix-cache
    # hits (cached positions are never scored).
    prompt_logprobs: bool = False
    # PD disaggregation: keep the pages resident after the finish, for
    # ``export_held`` to hand the KV to a decode worker.
    hold_after_finish: bool = False
    # EPD multimodal: vision embeddings [M, hidden] and the prompt
    # positions they splice over (one per row, the image token spans).
    mm_embeds: Optional[np.ndarray] = None
    mm_positions: Optional[List[int]] = None
    # mrope models: the prompt's [3, prompt_len] rope position streams
    # (``runtime/multimodal.mrope_positions``) and the rope-minus-storage
    # offset of every generated token. None / 0: plain text.
    mm_rope_pos: Optional[np.ndarray] = None
    rope_delta: int = 0


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Sequence:
    req: EngineRequest
    tokens: List[int]                  # prompt + generated
    pages: List[int] = dataclasses.field(default_factory=list)
    num_computed: int = 0              # tokens with KV resident
    num_cached_tokens: int = 0         # prefix-cache hit size
    slot: int = -1                     # decode slot, -1 = none
    status: SeqStatus = SeqStatus.WAITING
    first_token_time: float = 0.0
    # Sliding-window models: leading pages already released (every
    # position in them is below all later attention windows).
    num_trimmed: int = 0
    # Window the scheduler pinned for this step's prefill.
    sched_window: int = 0
    # Echo with logprobs: the prompt tokens' scores, filled window by
    # window (index 0 stays None), handed out with the first sampled
    # token.
    prompt_lps: Optional[List[Optional[float]]] = None

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.req.token_ids)

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.num_prompt_tokens


@dataclasses.dataclass
class StepOutput:
    """Per-request delta produced by one engine step."""

    request_id: str
    new_token_ids: List[int]
    logprobs: List[float]
    finish_reason: FinishReason = FinishReason.NONE
    num_prompt_tokens: int = 0
    num_generated: int = 0
    # Prompt tokens served from the prefix cache; rides the output that
    # carries the first sampled token.
    num_cached_tokens: int = 0
    # Per new token, the top-k alternatives [{"token_id", "logprob"}]
    # (only when the engine computes them and the request asked for
    # logprobs).
    top_logprobs: Optional[List[List[Dict[str, Any]]]] = None
    # Echo with logprobs: one entry per prompt token (the first None),
    # on the output that carries the first sampled token.
    prompt_logprobs: Optional[List[Optional[float]]] = None

    @property
    def finished(self) -> bool:
        return self.finish_reason != FinishReason.NONE


def _check_mesh_config(ecfg: EngineConfig) -> None:
    """Refuse what a sharded engine does not run: CUDA graphs (its steps
    run eagerly: a gloo collective cannot be captured, and NCCL capture
    needs a machine with several cards to be tried on)."""
    if ecfg.cuda_graphs:
        raise ValueError(
            "cuda_graphs=True with a mesh of several ranks: the sharded "
            "engine runs its steps eagerly (set cuda_graphs=False or "
            "leave it unset)")


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _rejoins(method):
    """An engine call that may broadcast to the ranks: when it raises
    with the world out of step, re-form the world first
    (``Engine._rejoin``)."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        try:
            return method(self, *args, **kwargs)
        except Exception as exc:
            self._rejoin(exc)
            raise
    return call


class Engine:
    """Single-model continuous-batching engine. Not thread-safe: drive
    ``step()`` from one thread (the worker's engine loop)."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[transformer.Params] = None,
                 device="cuda", seed: int = 0,
                 murmur_seed: int = 0, mesh: Optional[Mesh] = None,
                 name: str = "", sharded: bool = False) -> None:
        """``mesh``: this rank's mesh (module docstring); ``name``: the
        model its broadcasts name, which keys the followers' engines
        (``runtime/ranks.py``); ``sharded``: ``params`` are this rank's
        shard already (a warm wake's parked copy), not the full
        weights."""
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        transformer.check_supported(model_cfg)
        # A mesh of one rank is no mesh.
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            _check_mesh_config(engine_cfg)
        if params is None:
            init_gen = torch.Generator(device=self.device).manual_seed(0)
            params = transformer.init_params(model_cfg, init_gen,
                                             self.device)
        # The rank's view of the model: its heads (the weights' shapes
        # carry the rest).
        self.shard_cfg = model_cfg
        if self.mesh is not None:
            if not sharded:
                params = sharding.shard_params(params, self.mesh, model_cfg)
            self.shard_cfg = sharding.shard_config(model_cfg,
                                                   self.mesh.spec)
        self.params = params
        self.kv = transformer.init_kv_cache(
            self.shard_cfg, engine_cfg.num_pages, engine_cfg.page_size,
            self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.allocator = PageAllocator(engine_cfg.num_pages)
        self.prefix_cache = PrefixCacheIndex(
            self.allocator, engine_cfg.page_size, seed=murmur_seed,
            enable=engine_cfg.enable_prefix_cache)
        # The host spill tier: cached pages reclaimed under pressure are
        # copied to host memory (and on to disk when configured) and
        # restored on a later hit. None unless kv_spill_mb > 0, and on a
        # follower rank (rank 0 holds the instance's tier, full heads).
        self.host_tier: Optional[HostKvTier] = None
        spill_bytes = int(engine_cfg.kv_spill_mb * 1e6)
        if spill_bytes > 0 and engine_cfg.enable_prefix_cache and (
                self.mesh is None or self.mesh.rank == 0):
            self.host_tier = HostKvTier(
                spill_bytes, disk_dir=engine_cfg.kv_spill_dir,
                disk_capacity_bytes=int(engine_cfg.kv_spill_disk_mb * 1e6))
            self.prefix_cache.spill_hook = self._spill_page
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self._by_id: Dict[str, Sequence] = {}
        self._slots: List[Optional[Sequence]] = \
            [None] * engine_cfg.max_batch_size
        self._cancelled: set = set()
        # Finished PD prefills whose pages wait for export_held.
        self._held: Dict[str, Sequence] = {}
        self.step_count = 0
        # The interleaver's knobs and the ragged switch, resolved once.
        self.interleave = engine_cfg.interleave is not False
        self.step_token_budget = (engine_cfg.step_token_budget
                                  or engine_cfg.max_prefill_tokens)
        self.prefill_deadline_ms = float(engine_cfg.prefill_deadline_ms)
        # MLA models have no ragged mixed step, and neither do mrope
        # models (their decode rows need the per-slot rope delta), as in
        # the JAX engine: their mixed iterations run split.
        self.mrope = model_cfg.is_mrope
        self.ragged = (bool(engine_cfg.ragged_attn) and not model_cfg.mla
                       and not self.mrope)
        self.write_then_attend = resolve_write_then_attend(
            engine_cfg.write_then_attend, self.device)
        # Fused multi-step decode and its pipeline (None = on when
        # bursts are fused), as the JAX engine resolves them.
        self.decode_steps = max(1, int(engine_cfg.decode_steps))
        dp = engine_cfg.decode_pipeline
        self.decode_pipeline = self.decode_steps > 1 and (
            dp is None or bool(dp))
        if self.device.type == "cuda":
            # The split kernels' tickets at their largest size (a decode
            # step's rows, a ragged launch's), before any capture.
            rows = max(engine_cfg.max_batch_size,
                       min(_pow2(engine_cfg.max_batch_size), 256))
            paged_attention.reserve_tickets(
                self.device, rows * self.shard_cfg.kv_cache_heads)
        use_graphs = (resolve_cuda_graphs(engine_cfg.cuda_graphs, self.device)
                      and self.mesh is None)
        # Sequence-parallel ring prefill, where the mesh has an sp axis.
        self._sp = self.mesh.size(AXIS_SP) if self.mesh is not None else 1
        # Top-k alternative logprobs computed inside every step (0: none).
        self.num_top = int(engine_cfg.num_top_logprobs)
        self.graphs = decode_graph.DecodeGraphs(
            self.params, self.shard_cfg, self.kv, engine_cfg.max_batch_size,
            self.decode_steps, self.write_then_attend, self.generator,
            self.device, use_graphs, self.num_top, mesh=self.mesh)
        # The prefill and ragged steps' runner, in the decode runner's
        # memory pool.
        # Its embedding buffer holds the most rows one step can splice:
        # the windows of a step never exceed the larger of the budget and
        # the largest bucket.
        self.prefill_graphs = prefill_graph.PrefillGraphs(
            self.params, self.shard_cfg, self.kv,
            _pow2(engine_cfg.max_batch_size), self.write_then_attend,
            self.generator, self.device, use_graphs, self.graphs.pool,
            self.num_top, mm_cap=(0 if model_cfg.mla else max(
                engine_cfg.max_prefill_tokens, self.step_token_budget,
                engine_cfg.prefill_buckets[-1])),
            mesh=self.mesh, ring=self._sp > 1)
        # The KV plane: page sets in and out as full-head blocks.
        self.kv_plane = ranks.KvPlane(self, self.mesh)
        if self.mesh is not None and self.mesh.rank == 0:
            # Rank 0 leads: its runner calls reach every rank.
            self.graphs = ranks.Mirror(self.graphs, "decode", self.mesh,
                                       name)
            self.prefill_graphs = ranks.Mirror(self.prefill_graphs,
                                               "prefill", self.mesh, name)
            self.kv_plane = ranks.Mirror(self.kv_plane, "kv", self.mesh,
                                         name)
        self.name = name
        self.mm_spliced_tokens = 0
        # Whether the decode runner's [B, V] output-token counts hold the
        # running batch's histogram (the JAX engine's ``_counts`` is not
        # None): dropped wherever the batch changes outside a decode
        # (prefill, ragged, a speculation's rollback) and rebuilt from
        # host truth by the next penalized decode (``_ensure_counts``).
        self._counts_valid = False
        # The batch the decode runner's token and position carries hold
        # (see _snapshot), or None when they were not kept.
        self._resident: Optional[Tuple] = None
        # The in-flight speculative burst (consumed or rolled back by
        # the next step).
        self._pending: Optional[Dict[str, Any]] = None
        # Device-idle attribution between consecutive bursts.
        self._last_burst_ready_t: Optional[float] = None
        self._last_burst_step = -1
        self.phase_counts: Dict[str, int] = collections.Counter()
        self.phase_times: Dict[str, float] = collections.Counter()
        # What the last step() did (the JAX engine's step ledger). A
        # forward is one attention dispatch: decode, prefill or ragged.
        self.last_step_kind = "idle"    # "prefill"|"decode"|"mixed"|"idle"
        self.last_step_tokens = 0
        self.last_step_prefill_tokens = 0
        self.last_step_decode_tokens = 0
        # Host seconds of the step's prefill forward, its sampled tokens
        # read back (a ragged forward's whole time): the heartbeat's
        # measured prefill rate.
        self.last_step_prefill_s = 0.0
        self.last_step_prefill_windows: Tuple[int, ...] = ()
        self.last_step_decode_deferred = False
        self.last_step_ragged = False
        self.last_step_attn_dispatches = 0
        self.ragged_steps = 0           # ragged forwards run so far
        self.num_preemptions = 0
        # (token, expert) assignments lost to MoE expert capacity, over
        # the engine's life; 0 on dense and MLA models.
        self.moe_dropped_tokens = 0
        self._count_drops = model_cfg.is_moe and not model_cfg.mla
        # The prefix-reuse ledger: admitted lookups and the prompt tokens
        # the cache covered (local hits and tier restores).
        self.prefix_lookups = 0
        self.prefix_hit_tokens = 0
        # Blocks adopted from another worker (``adopt_blocks``).
        self.fetched_blocks = 0
        # The step fault boundary (module docstring): the worker reads
        # ``step_members`` and ``last_step_partial_outs`` after a fault
        # and drives ``isolate`` / ``fault_reset``; ``fault_hook`` is its
        # injection point, called with each section's members.
        self.fault_hook: Optional[Callable[[Tuple[str, ...]], None]] = None
        self.step_members: Tuple[str, ...] = ()
        self.last_step_partial_outs: List[StepOutput] = []
        self._fault_isolated = False
        self._parked: List[Sequence] = []
        # The roofline table, filled at warmup (XLLM_ROOFLINE=0 leaves it
        # empty; XLLM_ROOFLINE_VARIANTS caps the variants per program).
        self.roofline: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._roofline_enabled = os.environ.get(
            "XLLM_ROOFLINE", "1").strip() not in ("0", "false", "no")
        try:
            self._roofline_cap = max(1, int(os.environ.get(
                "XLLM_ROOFLINE_VARIANTS", "8")))
        except ValueError:
            self._roofline_cap = 8

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    def _rejoin(self, exc: BaseException) -> None:
        """After ``exc``: when it left the ranks out of step (raised
        between a broadcast call and its agreement), re-form the world
        (``Mesh.reform``; ``MeshLost`` when a rank does not come back).
        In step, nothing to do: the followers wait for the next call."""
        if self.mesh is not None and not self.mesh.synced:
            self.mesh.reform(exc)

    def _block_shape(self, n: int) -> Tuple[int, ...]:
        """The layout of a KV block of ``n`` pages: every KV head (the
        full model's, whatever share of them this rank's pools hold)."""
        return (self.cfg.num_layers, n, self.ecfg.page_size,
                self.cfg.kv_cache_heads, self.cfg.kv_cache_dim)

    def add_request(self, req: EngineRequest) -> None:
        if not req.token_ids:
            raise ValueError("empty prompt")
        if req.mm_embeds is not None:
            if self.cfg.mla:
                raise ValueError("MLA models have no multimodal splice")
            if len(req.mm_positions or ()) != len(req.mm_embeds):
                raise ValueError("mm_positions must name one prompt "
                                 "position per embedding row")
        max_prompt = self.ecfg.max_model_len - 1
        if len(req.token_ids) > max_prompt:
            raise ValueError(
                f"prompt of {len(req.token_ids)} tokens exceeds the "
                f"engine's limit of {max_prompt}")
        # A prompt (and its first sampled token) whose KV can never fit
        # the pool is refused: admitted, it would preempt itself forever.
        # Page 0 is the NULL page, hence the -1.
        pool_pages = self.ecfg.num_pages - 1
        if self._pages_needed(len(req.token_ids) + 1) > pool_pages:
            raise ValueError(
                f"prompt of {len(req.token_ids)} tokens needs more KV "
                f"pages than the pool holds ({pool_pages} × "
                f"{self.ecfg.page_size} tokens)")
        if len(req.token_ids) + req.sampling.max_tokens > \
                self.ecfg.max_model_len:
            req = dataclasses.replace(
                req, sampling=dataclasses.replace(
                    req.sampling,
                    max_tokens=max(
                        1, self.ecfg.max_model_len - len(req.token_ids))))
        if req.arrival_time == 0.0:
            req.arrival_time = time.monotonic()
        # Prefill-first routing prefills this prompt on the next step,
        # which a speculative burst did not assume; the interleaver
        # decodes first and drains only when a prefill lands.
        if not self.interleave:
            self.drain_pipeline()
        seq = Sequence(req=req, tokens=list(req.token_ids))
        self._by_id[req.request_id] = seq
        if self._fault_isolated:
            # An arrival during a bisection probe waits outside it.
            self._parked.append(seq)
            return
        self.waiting.append(seq)
        self._sort_waiting()

    def _sort_waiting(self) -> None:
        # Sequences between chunked windows first (they hold a slot and
        # pages), then online before offline, then by arrival.
        self.waiting.sort(key=lambda s: (s.slot < 0, s.req.offline,
                                         s.req.arrival_time))

    def cancel(self, request_id: str) -> None:
        self._cancelled.add(request_id)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._cancelled)

    # ------------------------------------------------------------------
    # Load reporting (the worker's heartbeat and /metrics). The heartbeat
    # thread calls these without the engine lock, so they read snapshots.
    # ------------------------------------------------------------------
    def load_metrics(self) -> Dict[str, Any]:
        """The heartbeat's LoadMetrics, with the JAX engine's formulas:
        reclaimable cached pages count as free, and the MoE capacity
        drops are the engine's running total."""
        used = (self.ecfg.num_pages - 1 - self.allocator.num_free
                - self.prefix_cache.num_reclaimable)
        return {
            "waiting_requests": len(self.waiting),
            "running_requests": len(self.running),
            "waiting_prefill_tokens": self.waiting_prefill_tokens(),
            "kv_cache_usage": used / max(self.ecfg.num_pages - 1, 1),
            "num_preemptions": self.num_preemptions,
            "moe_dropped_tokens": self.moe_dropped_tokens,
        }

    def prefix_cache_stats(self) -> Dict[str, int]:
        """The ``xllm_worker_prefix_cache_*`` series: lifetime lookups,
        hit tokens, blocks adopted from another worker and spill
        traffic."""
        tier = self.host_tier
        return {
            "lookups_total": self.prefix_lookups,
            "hit_tokens_total": self.prefix_hit_tokens,
            "fetched_blocks_total": self.fetched_blocks,
            "spilled_pages": tier.spilled_blocks if tier else 0,
            "restored_pages": tier.restored_blocks if tier else 0,
        }

    def drain_kvcache_event(self) -> KvCacheEvent:
        """The cache-content delta since the last drain: the index's
        stored / removed / offloaded digests, then the tier's own
        demotions and drops."""
        ev = self.prefix_cache.drain_event()
        if self.host_tier is not None:
            ev.merge(self.host_tier.drain_event())
        return ev

    def _note_moe_dropped(self, dropped: int) -> None:
        if self._count_drops:
            self.moe_dropped_tokens += int(dropped)

    def waiting_prefill_tokens(self) -> int:
        """Prefill backlog: prompt tokens queued but not yet computed."""
        return sum(max(len(s.tokens) - s.num_computed, 0)
                   for s in list(self.waiting))

    def kv_block_bytes(self) -> int:
        """Bytes of one KV page across every layer, K and V (the
        registration record's ``kv_block_bytes``)."""
        k_pages = self.kv[0]
        per_rank = 2 * k_pages.numel() * k_pages.element_size() \
            // k_pages.shape[1]
        # The instance's page: every KV head, not this rank's share.
        return per_rank * self.cfg.kv_cache_heads \
            // self.shard_cfg.kv_cache_heads

    # ------------------------------------------------------------------
    # Pages and slots
    # ------------------------------------------------------------------
    def _pages_needed(self, num_tokens: int) -> int:
        ps = self.ecfg.page_size
        return (num_tokens + ps - 1) // ps

    def _free_slot(self) -> int:
        return next((i for i, s in enumerate(self._slots) if s is None), -1)

    def _window_pages_covered(self, seq: Sequence, window: int,
                              start: Optional[int] = None) -> int:
        """Token positions the pages must cover for a prefill window of
        ``window`` tokens from ``start`` (default ``seq.num_computed``):
        the window, plus the token it samples when it completes the
        prompt."""
        end = (seq.num_computed if start is None else start) + window
        return end + (1 if end >= len(seq.tokens) else 0)

    def _preempt_one_offline(self) -> bool:
        """Preempt the most recently arrived offline sequence that holds
        pages: running, or waiting between chunked windows (slot >= 0).
        False when there is none."""
        victims = [s for s in self.running if s.req.offline]
        victims += [s for s in self.waiting
                    if s.req.offline and s.slot >= 0]
        if not victims:
            return False
        self._preempt_seq(max(victims, key=lambda s: s.req.arrival_time))
        return True

    def _try_admit(self, seq: Sequence, cap: int) -> bool:
        """Take a free slot, the prompt's cached leading pages (an index
        hit, extended by the host tier's restores) and fresh pages for
        the first prefill window past them, of at most ``cap`` tokens;
        later windows and decode grow the table. An online sequence
        short of pages preempts offline ones first. On success
        ``seq.num_computed`` is the cached start."""
        slot = self._free_slot()
        if slot < 0:
            return False
        # A prompt-scored sequence skips hits (cached positions would
        # never be scored), and so does a multimodal one (its KV depends
        # on the images, not only on the token ids).
        scored = seq.req.prompt_logprobs or seq.req.mm_embeds is not None
        cached_pages, cached_tokens = [], 0
        if not scored:
            cached_pages, cached_tokens = \
                self.prefix_cache.match_prefix(seq.req.token_ids)
        if self.host_tier is not None and not scored:
            cached_pages, cached_tokens = self._restore_spilled(
                seq.req.token_ids, cached_pages, cached_tokens)
        if cached_tokens and self._ring_preferred(seq, cached_tokens):
            # A cached prefix forces the chunked windows (the ring's
            # positions start at 0): for a ring-eligible prompt it is
            # cheaper to recompute the prefix inside the one ring step,
            # as the JAX engine decides. Also the readmission path of a
            # preempted long prompt, whose own pages match as a prefix.
            self.prefix_cache.release_pages(cached_pages)
            cached_pages, cached_tokens = [], 0
        cap = self._ring_cap(seq, cached_tokens, cap)
        window = min(len(seq.tokens) - cached_tokens, cap)
        need = max(self._pages_needed(self._window_pages_covered(
            seq, window, cached_tokens)) - len(cached_pages), 0)
        new_pages = self.prefix_cache.alloc(need)
        while new_pages is None and not seq.req.offline and \
                self._preempt_one_offline():
            new_pages = self.prefix_cache.alloc(need)
        if new_pages is None:
            self.prefix_cache.release_pages(cached_pages)
            return False
        seq.pages = list(cached_pages) + new_pages
        seq.num_computed = cached_tokens
        seq.num_cached_tokens = cached_tokens
        # Only admitted lookups count: a refused one retries every step.
        if not scored:
            self.prefix_lookups += 1
            self.prefix_hit_tokens += cached_tokens
        seq.slot = slot
        self._slots[slot] = seq
        return True

    def _swa_trim(self, seq: Sequence) -> None:
        """Uniform sliding-window models: release the leading pages whose
        every position is below all later attention windows (positions
        < num_computed - W), so a sequence holds O(W) KV. The freed
        table entries become the NULL page 0; the kernels read such
        entries only in window-masked lanes. Per-layer window mixes keep
        every page (their full layers read the whole history), and so
        does a PD-held prefill (its export ships the whole prefix)."""
        W = self.cfg.sliding_window
        if not W or self.cfg.layer_sliding is not None \
                or seq.req.hold_after_finish:
            return
        bound = min((seq.num_computed - W) // self.ecfg.page_size,
                    len(seq.pages))
        if bound <= seq.num_trimmed:
            return
        for i in range(seq.num_trimmed, bound):
            pid = seq.pages[i]
            if pid:
                self.prefix_cache.release_pages([pid])
                seq.pages[i] = 0
        seq.num_trimmed = bound

    def _preempt_seq(self, seq: Sequence) -> None:
        """Preemption by recompute: register the computed full pages,
        release the slot and pages and requeue; the generated tokens are
        kept and prefilled again on readmission (from whatever of them
        the cache still holds)."""
        if seq.slot >= 0:
            self._slots[seq.slot] = None
            seq.slot = -1
        self._register_pages(seq)
        self.prefix_cache.release_pages([p for p in seq.pages if p])
        seq.pages = []
        seq.num_trimmed = 0
        seq.num_computed = 0
        seq.sched_window = 0
        seq.status = SeqStatus.WAITING
        self.num_preemptions += 1
        if seq in self.running:
            self.running.remove(seq)
        if seq not in self.waiting:     # a partial prefill already waits
            self.waiting.append(seq)
        self._sort_waiting()

    def _register_pages(self, seq: Sequence) -> None:
        """Register the full pages of ``seq``'s computed tokens in the
        prefix cache, unless it is multimodal."""
        if seq.req.mm_embeds is None:
            self.prefix_cache.register_full_pages(
                seq.tokens[:seq.num_computed], seq.pages)

    def _grow_pages(self, seq: Sequence, lookahead: int = 0) -> bool:
        """Pages for ``seq``'s next ``1 + lookahead`` token writes (see
        ``_ensure_pages``)."""
        return self._ensure_pages(seq, len(seq.tokens) + lookahead)

    def _ensure_pages(self, seq: Sequence, covered: int) -> bool:
        """Extend ``seq``'s page table to cover ``covered`` token
        positions. When the pool is short, an online ``seq`` preempts
        offline sequences (latest arrival first); with none left,
        ``seq`` preempts itself and False is returned."""
        need = self._pages_needed(covered) - len(seq.pages)
        if need <= 0:
            return True
        pages = self.prefix_cache.alloc(need)
        while pages is None:
            victims = [s for s in self.running
                       if s.req.offline and s is not seq]
            victims += [s for s in self.waiting
                        if s.req.offline and s.slot >= 0 and s is not seq]
            if victims and not seq.req.offline:
                self._preempt_seq(
                    max(victims, key=lambda s: s.req.arrival_time))
            else:
                self._preempt_seq(seq)
                return False
            pages = self.prefix_cache.alloc(need)
        seq.pages.extend(pages)
        return True

    def _grow_running(self) -> None:
        """Grow every running sequence's table for this step's decode
        write; growth may preempt, hence the snapshot."""
        for seq in list(self.running):
            if seq.status == SeqStatus.RUNNING:
                self._grow_pages(seq)

    def _finish_seq(self, seq: Sequence, reason: FinishReason) -> None:
        seq.status = SeqStatus.FINISHED
        if seq.slot >= 0:
            self._slots[seq.slot] = None
            seq.slot = -1
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        # Full pages become reusable by later prompts; only
        # tokens[:num_computed] have KV (the last sampled token has none).
        self._register_pages(seq)
        if seq.req.hold_after_finish and reason != FinishReason.CANCELLED:
            # PD handoff: the pages stay referenced until export_held.
            self._held[seq.req.request_id] = seq
        else:
            self.prefix_cache.release_pages([p for p in seq.pages if p])
            seq.pages = []
        self._by_id.pop(seq.req.request_id, None)
        self._cancelled.discard(seq.req.request_id)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------
    @_rejoins
    def step(self) -> List[StepOutput]:
        """One iteration, interleaved or prefill-first (see the module
        docstring); ``last_step_*`` describe it afterwards."""
        self.step_count += 1
        outs = self._drain_cancelled()
        # Every section extends this list: after a fault the worker
        # salvages the outputs of the sections that completed.
        self.last_step_partial_outs = outs
        self.step_members = ()
        self.last_step_prefill_tokens = 0
        self.last_step_decode_tokens = 0
        self.last_step_prefill_s = 0.0
        self.last_step_prefill_windows = ()
        self.last_step_decode_deferred = False
        self.last_step_ragged = False
        self.last_step_attn_dispatches = 0
        if self.interleave:
            self._step_interleaved(outs)
        else:
            self._step_prefill_first(outs)
        pf = self.last_step_prefill_tokens
        dc = self.last_step_decode_tokens
        self.last_step_tokens = pf + dc
        self.last_step_kind = ("mixed" if pf and dc else
                               "prefill" if pf else
                               "decode" if dc else "idle")
        return outs

    def _step_interleaved(self, outs: List[StepOutput]) -> None:
        if self.ragged and self.running and self.waiting and \
                self._step_ragged_mixed(outs):
            return
        if self.running:
            self._decode_section(outs)
        # Decode tokens count against the iteration's budget, so prefill
        # windows shrink exactly when decode load is high.
        budget = self.step_token_budget - self.last_step_decode_tokens
        if self.waiting:
            budget = max(budget, self._starvation_quantum())
        if budget > 0 and self.waiting:
            batch = self._schedule_prefill(budget)
            if batch:
                self._prefill_section(batch, outs)

    def _step_prefill_first(self, outs: List[StepOutput]) -> None:
        batch = self._schedule_prefill()
        if batch:
            # Live decode streams wait this iteration out.
            self.last_step_decode_deferred = bool(self.running)
            self._prefill_section(batch, outs)
        elif self.running:
            self._decode_section(outs)

    def _decode_section(self, outs: List[StepOutput]) -> None:
        decoded = self._decode_once()
        self.last_step_decode_tokens = sum(len(o.new_token_ids)
                                           for o in decoded)
        outs.extend(decoded)

    def _prefill_section(self, batch: List[Sequence],
                         outs: List[StepOutput]) -> None:
        # The landing prefill is what changes a speculative burst's batch.
        self.drain_pipeline()
        self._note_members(batch)
        # Prefill occupancy is the prompt tokens computed, not the one
        # token sampled per window.
        self.last_step_prefill_windows = tuple(s.sched_window for s in batch)
        self.last_step_prefill_tokens = sum(self.last_step_prefill_windows)
        t0 = time.perf_counter()
        outs.extend(self._run_prefill(batch))
        self.last_step_prefill_s = time.perf_counter() - t0

    def _starvation_quantum(self) -> int:
        """Floor on an iteration's prefill budget: the smallest bucket
        once the oldest waiting prompt has queued past
        ``prefill_deadline_ms``, even if decode used up the budget."""
        oldest = min(s.req.arrival_time for s in self.waiting)
        if (time.monotonic() - oldest) * 1000.0 < self.prefill_deadline_ms:
            return 0
        return self.ecfg.prefill_buckets[0]

    def _step_ragged_mixed(self, outs: List[StepOutput]) -> bool:
        """Serve this iteration as one ragged forward of the running
        decoders and the prefill windows scheduled beside them. False,
        with nothing changed, when no window fits the budget: the
        caller then runs the split sections (pages grown for the decode
        rows stay grown)."""
        self._grow_running()
        if not self.running:
            return False
        # The ragged program samples without the penalty counts: a
        # penalized decoder takes the split sections.
        if any(s.req.sampling.presence_penalty
               or s.req.sampling.frequency_penalty for s in self.running):
            return False
        # A ragged decode row spends one token of the budget.
        budget = max(self.step_token_budget - len(self.running),
                     self._starvation_quantum())
        if budget <= 0:
            return False
        batch = self._schedule_prefill(budget)
        if not batch:
            return False
        # Admission may have preempted offline decoders: they skip this
        # iteration's decode. With none left, or a prompt-scored window
        # (the ragged program scores none), the committed batch runs
        # through the split sections.
        decode_seqs = [s for s in self.running
                       if s.status == SeqStatus.RUNNING]
        if not decode_seqs or batch[0].req.prompt_logprobs or \
                batch[0].sched_window > self.ecfg.prefill_buckets[-1]:
            if self.running:
                self._decode_section(outs)
            self._prefill_section(batch, outs)
            return True
        self._run_ragged(decode_seqs, batch, outs)
        return True

    def _drain_cancelled(self) -> List[StepOutput]:
        outs = []
        for rid in list(self._cancelled):
            seq = self._by_id.get(rid)
            self._cancelled.discard(rid)
            if seq is None:
                continue
            self._finish_seq(seq, FinishReason.CANCELLED)
            outs.append(StepOutput(
                request_id=rid, new_token_ids=[], logprobs=[],
                finish_reason=FinishReason.CANCELLED,
                num_prompt_tokens=seq.num_prompt_tokens,
                num_generated=seq.num_generated))
        return outs

    # Bounded skip-ahead past refused admissions: a prompt behind one
    # whose pages do not fit still admits this step; the refused one
    # keeps its place and retries first on the next step.
    _ADMIT_SKIP_AHEAD = 4

    def _ring_eligible(self, seq: Sequence, start: int) -> bool:
        """Whether the whole prompt prefills in one ring step, as the JAX
        engine decides: an sp axis, from position 0 (no cached prefix),
        no window, Gemma, MLA or GPT-OSS layer, no multimodal splice, no
        prompt scores, and longer than the largest bucket but within sp
        of them."""
        cap1 = self.ecfg.prefill_buckets[-1]
        return (self._sp > 1 and start == 0
                and not self.cfg.sliding_window and not self.cfg.gemma
                and not self.cfg.mla and not self.cfg.gptoss
                and seq.req.mm_embeds is None
                and not seq.req.prompt_logprobs
                and cap1 < len(seq.tokens) <= cap1 * self._sp)

    def _ring_preferred(self, seq: Sequence, cached_tokens: int) -> bool:
        """Forgoing a cached prefix to ring the whole prompt wins while
        the ring's per-rank work (len / sp) is below the chunked path's
        remaining work (len - cached)."""
        n = len(seq.tokens)
        return (self._ring_eligible(seq, 0)
                and n / max(self._sp, 1) < n - cached_tokens)

    def _ring_cap(self, seq: Sequence, start: int, cap: int) -> int:
        """A window cap of ``sp`` buckets for a ring-eligible prompt
        (exempt from an interleaved budget: its one step is the whole
        prompt), else ``cap``."""
        if self._ring_eligible(seq, start):
            return self.ecfg.prefill_buckets[-1] * self._sp
        return cap

    def _window_cap(self, budget: Optional[int]) -> int:
        """Largest window one prefill step takes: the largest bucket, or
        under an interleaved ``budget`` the largest bucket not above it
        (0 if none), so windows stay bucket-shaped."""
        buckets = self.ecfg.prefill_buckets
        if budget is None:
            return buckets[-1]
        i = bisect.bisect_right(buckets, budget)
        return buckets[i - 1] if i else 0

    def _schedule_prefill(self, budget: Optional[int] = None
                          ) -> List[Sequence]:
        """Pick this step's prefill windows in queue order and pin each
        on ``seq.sched_window``. ``budget`` is an interleaved
        iteration's residual token budget, which each window's cap
        follows as it shrinks; None is the prefill-first step's
        ``max_prefill_tokens`` with whole-bucket windows."""
        batch: List[Sequence] = []
        interleaved = budget is not None
        if budget is None:
            budget = self.ecfg.max_prefill_tokens
        skipped = 0
        cap1 = self.ecfg.prefill_buckets[-1]
        for seq in list(self.waiting):
            cap = self._window_cap(budget if interleaved else None)
            window = min(len(seq.tokens) - seq.num_computed,
                         self._ring_cap(seq, seq.num_computed, cap))
            if window <= 0:
                break               # residual below the smallest bucket
            if batch and window > budget:
                break
            if batch and (window > cap1 or seq.req.prompt_logprobs):
                break               # a ring or prompt-scored window
            if seq.slot < 0:        # runs alone
                if not self._try_admit(seq, cap):
                    if self._free_slot() < 0 or \
                            skipped >= self._ADMIT_SKIP_AHEAD:
                        break       # no slot at all, or the bound is hit
                    skipped += 1
                    continue        # pages short: try the next prompt
                # The window starts past the cached prefix: the budget
                # is charged, and the executor runs, only what is left.
                window = min(len(seq.tokens) - seq.num_computed,
                             self._ring_cap(seq, seq.num_computed, cap))
            elif not self._ensure_pages(
                    seq, self._window_pages_covered(seq, window)):
                continue            # preempted itself: waits, slotless
            seq.sched_window = window
            budget -= window
            self.waiting.remove(seq)
            batch.append(seq)
            if seq.req.prompt_logprobs or window > cap1:
                break
            if budget <= 0 or len(batch) >= self.ecfg.max_batch_size:
                break
        return batch

    def _bucket(self, n: int) -> int:
        buckets = self.ecfg.prefill_buckets
        return buckets[bisect.bisect_left(buckets, n)]

    def _forward_windows(self, rows: List[Sequence],
                         spans: List[Tuple[int, int]],
                         ragged: bool) -> prefill_graph.Result:
        """One forward_prefill over ``rows`` through the prefill runner,
        row i taking the tokens [start, start + n) of ``spans[i]``; the
        batch pads to a power of two rows and to the bucket of the
        longest span. Returns the token sampled after each row's last
        token, its logprob and, where asked for, the top entries; a
        prompt-scored row (alone in its batch) also gets its window's
        prompt scores, stitched into ``seq.prompt_lps``."""
        B = _pow2(len(rows))
        T = self._bucket(max(n for _, n in spans))
        # The writer and the attention kernels touch only [start,
        # start + n) of a row, inside its own pages.
        MP = min(_pow2(max(len(s.pages) for s in rows)),
                 self.ecfg.max_pages_per_seq)
        params = [s.req.sampling for s in rows]
        padded = params + [_GREEDY] * (B - len(rows))
        bias = batch_bias(padded, B, self.cfg.vocab_size)
        scored = rows[0] if rows[0].req.prompt_logprobs else None
        targets = None
        if scored is not None:
            # Window position t scores the prompt token at start + t + 1
            # (target 0 past the prompt).
            start, n = spans[0]
            scored_at = [(t, start + t + 1) for t in range(n)
                         if start + t + 1 < scored.num_prompt_tokens]
            targets = np.zeros((B, T), np.int32)
            for t, g in scored_at:
                targets[0, t] = scored.tokens[g]
        K = bias[0].shape[1]
        mm = self.mrope or any(s.req.mm_embeds is not None for s in rows)
        mm_index = self._stage_splice(rows, spans, B, T) if mm else None
        rope_pos = None
        if self.mrope:
            rope_pos = np.zeros((B, 3, T), np.int32)
            for i, (seq, (st, _)) in enumerate(zip(rows, spans)):
                rope_pos[i] = self._rope_window(seq, st, T)
        self.prefill_graphs.stage((B, T, MP, K, scored is not None, mm),
                                  prefill_graph.pack(
            (B, T, MP), [(seq.tokens[st:st + n], st, seq.pages)
                         for seq, (st, n) in zip(rows, spans)],
            SamplingTensors.pack_batch(padded), bias, targets, mm_index,
            rope_pos))
        greedy_only, seeded = batch_mode(params)
        res = self.prefill_graphs.launch(
            prefill_graph.Key("ragged" if ragged else "prefill", B, T, MP,
                              greedy_only, seeded, K, scored is not None,
                              mm),
            want_top=self._want_top(rows))
        self.last_step_attn_dispatches += 1
        self._note_moe_dropped(res.dropped)
        if scored is not None:
            if scored.prompt_lps is None:
                scored.prompt_lps = [None] * scored.num_prompt_tokens
            for t, g in scored_at:
                scored.prompt_lps[g] = res.prompt_lps[0][t]
        # The batch changed outside a decode: the penalty counts are
        # rebuilt from host truth before the next penalized decode.
        self._counts_valid = False
        return res

    def _stage_splice(self, rows: List[Sequence],
                      spans: List[Tuple[int, int]], B: int, T: int
                      ) -> np.ndarray:
        """Stage the embedding rows whose prompt positions fall in this
        step's windows (the JAX engine's window-relative ``mm_positions``;
        the rest splice in another window) and return the [B, T] index
        into them, -1 where the token's own embedding stays."""
        index = np.full((B, T), -1, np.int32)
        picked: List[np.ndarray] = []
        n_rows = 0
        for i, (seq, (st, n)) in enumerate(zip(rows, spans)):
            if seq.req.mm_embeds is None:
                continue
            pos = np.asarray(seq.req.mm_positions, np.int64) - st
            sel = np.nonzero((pos >= 0) & (pos < n))[0]
            if not len(sel):
                continue
            index[i, pos[sel]] = n_rows + np.arange(len(sel))
            picked.append(np.asarray(seq.req.mm_embeds)[sel])
            n_rows += len(sel)
        if picked:
            self.prefill_graphs.stage_mm(np.concatenate(picked))
        self.mm_spliced_tokens += n_rows
        return index

    def _rope_window(self, seq: Sequence, start: int, T: int) -> np.ndarray:
        """[3, T] mrope ids of the window [start, start + T): prompt
        positions take the request's streams, later (generated, padding)
        positions storage + delta on all three (plain text by then), as
        the JAX engine's ``_rope_window``."""
        g = np.arange(start, start + T, dtype=np.int32)
        out = np.broadcast_to(g + seq.req.rope_delta, (3, T)).copy()
        rp = seq.req.mm_rope_pos
        if rp is not None:
            n = max(0, min(rp.shape[1] - start, T))
            if n > 0:
                out[:, :n] = rp[:, start:start + n]
        return out

    def _want_top(self, seqs) -> bool:
        """Whether a step's top logprobs cross to the host: computed
        (``num_top_logprobs``) and some sequence asked for logprobs."""
        return self.num_top > 0 and any(s.req.sampling.logprobs
                                        for s in seqs)

    def _top_entry(self, seq: Sequence, tops, row: int
                   ) -> Optional[List[List[Dict[str, Any]]]]:
        """One sampled token's top alternatives for ``seq`` (None unless
        read back and the request asked for logprobs)."""
        if tops is None or not seq.req.sampling.logprobs:
            return None
        return [tops[row]]

    def _run_prefill(self, batch: List[Sequence]) -> List[StepOutput]:
        windows = [s.sched_window for s in batch]
        if windows[0] > self.ecfg.prefill_buckets[-1]:
            return self._run_prefill_ring(batch[0], windows[0])
        res = self._forward_windows(
            batch, [(s.num_computed, w) for s, w in zip(batch, windows)],
            ragged=False)
        return self._finish_windows(batch, windows, res, 0)

    def _run_ragged(self, decode_seqs: List[Sequence], batch: List[Sequence],
                    outs: List[StepOutput]) -> None:
        """One forward for a mixed iteration: the decode rows first, each
        a length-1 window at start = len(tokens) - 1 (mid-page as often
        as not), then the scheduled prefill windows. Rows are indexed by
        their place in the batch, not by decode slot."""
        self.drain_pipeline()
        windows = [s.sched_window for s in batch]
        rows = decode_seqs + batch
        nd = len(decode_seqs)
        self._note_members(rows)
        self.last_step_ragged = True
        self.last_step_prefill_windows = tuple(windows)
        self.last_step_prefill_tokens = sum(windows)
        self.last_step_decode_tokens = nd
        spans = [(len(s.tokens) - 1, 1) for s in decode_seqs] + \
            [(s.num_computed, w) for s, w in zip(batch, windows)]
        t0 = time.perf_counter()
        res = self._forward_windows(rows, spans, ragged=True)
        self.last_step_prefill_s = time.perf_counter() - t0
        self.ragged_steps += 1
        for i, seq in enumerate(decode_seqs):
            if seq.status == SeqStatus.RUNNING:
                seq.num_computed = len(seq.tokens)
            outs.append(self._append_token(
                seq, res.tokens[i], res.logprobs[i],
                self._top_entry(seq, res.tops, i)))
        outs.extend(self._finish_windows(batch, windows, res, nd))

    def _run_prefill_ring(self, seq: Sequence, window: int
                          ) -> List[StepOutput]:
        """One ring prefill step for a whole long prompt
        (``_ring_eligible`` makes ``window`` the whole prompt), as the
        JAX engine's ``_run_prefill_ring``: the sequence pads to sp x
        the bucket of window / sp so that every rank holds an equal
        block; the token is sampled in the step."""
        sp = self._sp
        T = self._bucket(-(-window // sp)) * sp
        MP = _pow2(max(len(seq.pages),
                       self._pages_needed(window + 1)))
        params = [seq.req.sampling]
        bias = batch_bias(params, 1, self.cfg.vocab_size)
        K = bias[0].shape[1]
        self.prefill_graphs.stage((1, T, MP, K, False, False),
                                  prefill_graph.pack(
            (1, T, MP), [(seq.tokens[:window], 0, seq.pages)],
            SamplingTensors.pack_batch(params), bias))
        greedy_only, seeded = batch_mode(params)
        res = self.prefill_graphs.launch(
            prefill_graph.Key("prefill_ring", 1, T, MP, greedy_only, seeded,
                              K),
            want_top=self._want_top([seq]))
        self.last_step_attn_dispatches += 1
        self._note_moe_dropped(res.dropped)
        self._counts_valid = False
        return self._finish_windows([seq], [window], res, 0)

    def _finish_windows(self, batch: List[Sequence], windows: List[int],
                        res: prefill_graph.Result, first: int
                        ) -> List[StepOutput]:
        """The post of ``batch``'s windows, whose sampled tokens are the
        rows of ``res`` from ``first`` on."""
        now = time.monotonic()
        outs: List[StepOutput] = []
        for j, seq in enumerate(batch):
            i = first + j
            seq.sched_window = 0
            seq.num_computed += windows[j]
            if seq.num_computed < len(seq.tokens):
                # Mid-prompt window: its sampled token is discarded and
                # the sequence (slot and pages kept) waits for its next
                # window at the front of the queue.
                self._swa_trim(seq)
                self.waiting.append(seq)
                continue
            seq.status = SeqStatus.RUNNING
            seq.first_token_time = now
            self.running.append(seq)
            out = self._append_token(seq, res.tokens[i], res.logprobs[i],
                                     self._top_entry(seq, res.tops, i))
            out.num_cached_tokens = seq.num_cached_tokens
            if seq.prompt_lps is not None:
                out.prompt_logprobs = seq.prompt_lps
                seq.prompt_lps = None
            outs.append(out)
        self._sort_waiting()
        return outs

    # ------------------------------------------------------------------
    # Decode: single steps, fused bursts and the speculative pipeline
    # ------------------------------------------------------------------
    def _decode_once(self) -> List[StepOutput]:
        self._note_members(self.running)
        N = self.decode_steps
        # A burst writes KV up to position len + N - 2: a sequence that
        # would cross max_model_len takes single steps.
        if N > 1 and all(len(s.tokens) + N - 1 <= self.ecfg.max_model_len
                         for s in self.running):
            return self._run_decode_multi()
        # Single-step fallback: the burst carries are unusable.
        self.drain_pipeline()
        return self._run_decode()

    def _table_width(self) -> int:
        """Page-table columns the running batch needs, as a power of two
        (clamped to ``max_pages_per_seq``): one graph per width."""
        mp = max((len(s.pages) for s in self.running), default=1)
        return min(_pow2(mp), self.ecfg.max_pages_per_seq)

    def _snapshot(self) -> Tuple:
        return tuple((s.req.request_id, s.slot, s.tokens[-1],
                      len(s.tokens) - 1) for s in self.running)

    def _active_table(self, width: int) -> Tuple[np.ndarray, np.ndarray]:
        B = self.ecfg.max_batch_size
        active = np.zeros((B,), np.bool_)
        table = np.zeros((B, width), np.int32)
        for seq in self.running:
            active[seq.slot] = True
            n = min(len(seq.pages), width)
            table[seq.slot, :n] = seq.pages[:n]
        return active, table

    def _stage_decode(self, steps: int) -> decode_graph.Key:
        """Fill the decode runner's inputs from the running batch, each
        only where it changed: the active mask and page table, the
        slots' packed sampling pair and logit bias, the penalty counts
        (rebuilt when they are stale, ``_ensure_counts``), and the token
        and position carries unless they already hold this batch
        (``_resident``). Returns the step's graph key."""
        width = self._table_width()
        self.graphs.stage_active_table(*self._active_table(width))
        params = [_GREEDY] * self.ecfg.max_batch_size
        for seq in self.running:
            params[seq.slot] = seq.req.sampling
        self.graphs.stage_sampling(SamplingTensors.pack_batch(params))
        bias = batch_bias(params, len(params), self.cfg.vocab_size)
        self.graphs.stage_bias(*bias)
        if self.mrope:
            delta = np.zeros((self.ecfg.max_batch_size,), np.int32)
            for seq in self.running:
                delta[seq.slot] = seq.req.rope_delta
            self.graphs.stage_rope_delta(delta)
        penalized = self._ensure_counts()
        if self._resident != self._snapshot():
            B = self.ecfg.max_batch_size
            tokens = np.zeros((B,), np.int64)
            positions = np.zeros((B,), np.int32)
            for seq in self.running:
                tokens[seq.slot] = seq.tokens[-1]
                positions[seq.slot] = len(seq.tokens) - 1
            self.graphs.stage_carries(tokens, positions)
        self._resident = None           # the launch advances the carries
        greedy_only, seeded = batch_mode(
            [s.req.sampling for s in self.running])
        return decode_graph.Key(width, steps, greedy_only, seeded,
                                penalized, bias[0].shape[1])

    def _ensure_counts(self) -> bool:
        """Whether this decode applies the penalties: some running
        sequence sets one. The runner's [B, V] counts are then rebuilt
        from the host's token lists if they are stale (the JAX engine's
        ``_ensure_counts``)."""
        if not any(s.req.sampling.presence_penalty
                   or s.req.sampling.frequency_penalty
                   for s in self.running):
            self._counts_valid = False
            return False
        if not self._counts_valid:
            counts = np.zeros((self.ecfg.max_batch_size,
                               self.cfg.vocab_size), np.int32)
            for seq in self.running:
                gen = seq.tokens[seq.num_prompt_tokens:]
                if seq.slot >= 0 and gen:
                    np.add.at(counts[seq.slot], gen, 1)
            self.graphs.stage_counts(counts)
            self._counts_valid = True
        return True

    def _run_decode(self) -> List[StepOutput]:
        self._grow_running()
        if not self.running:
            return []
        key = self._stage_decode(1)
        launch = self.graphs.launch(key, self._want_top(self.running))
        self.last_step_attn_dispatches += 1
        toks, lps, tops = launch.read()
        self._note_moe_dropped(launch.moe_dropped)
        outs = []
        # (seq, slot) first: a growth below may preempt an offline
        # sequence later in the list, which still takes its token.
        for seq, slot in [(s, s.slot) for s in self.running]:
            if seq.status == SeqStatus.RUNNING:
                seq.num_computed = len(seq.tokens)
            outs.append(self._append_token(
                seq, toks[0][slot], lps[0][slot],
                self._top_entry(seq, tops[0] if tops else None, slot)))
        # Every slot's carry is its sampled token and the next position.
        self._resident = self._snapshot()
        return outs

    def _run_decode_multi(self) -> List[StepOutput]:
        """N fused decode steps per dispatch (one graph replay).

        Pages are pre-grown for the whole lookahead; finish detection
        runs on the host afterwards, discarding tokens sampled past a
        stop. Each surviving sequence gets ONE StepOutput carrying its
        accepted tokens.

        Pipelined (``decode_pipeline``): burst k+1's inputs are burst
        k's device-resident carries, so when no host event can be
        pending it is dispatched before burst k's outputs are read, and
        burst k's host post overlaps its device work. A speculation that
        the post invalidates (a finish, a preemption, an admission, a
        page-table change) is discarded: the generator's state saved
        before it is restored, so the replacement burst draws what the
        pipeline-off engine draws, and its in-place KV writes land only
        at positions at or past every sequence's computed length, which
        the replacement rewrites before anything reads them."""
        burst = None
        pending, self._pending = self._pending, None
        if pending is not None:
            if self._pending_matches(pending):
                # Speculation hit: nothing to pack or upload.
                self.phase_counts["decode_multi.spec_hit"] += 1
                self._note_burst_gap(overlapped=True)
                burst = pending
            else:
                self._discard_spec(pending)
        if burst is None:
            burst = self._dispatch_burst()
            if burst is None:
                return []
        # Two-deep pipeline: enqueue burst k+1 before blocking on burst
        # k's host copy.
        spec = self._dispatch_spec(burst) if self.decode_pipeline else None
        toks, lps, tops = burst["launch"].read()          # [N][B] each
        self._note_moe_dropped(burst["launch"].moe_dropped)
        self._last_burst_ready_t = time.monotonic()
        self._last_burst_step = self.step_count
        outs = self._post_decode_multi(toks, lps, tops,
                                       carry_free=spec is None)
        if spec is not None:
            if self._pending_matches(spec):
                self._pending = spec
            else:
                self._discard_spec(spec)
        return outs

    def _dispatch_burst(self) -> Optional[Dict[str, Any]]:
        """Stage and dispatch one fused burst from host truth; None when
        the pre-growth preempted the whole batch away."""
        N = self.decode_steps
        # Pre-grow pages for the burst's KV writes, clamped to the tokens
        # each sequence can still take (a sequence 2 tokens from its
        # max_tokens reserves no pages for N - 1 more). Writes past the
        # clamp land on the NULL page, and their tokens are discarded on
        # the host. May preempt: iterate over a snapshot.
        for seq in list(self.running):
            if seq.status != SeqStatus.RUNNING:
                continue
            remaining = min(N, seq.req.sampling.max_tokens - seq.num_generated)
            self._grow_pages(seq, lookahead=max(remaining - 1, 0))
        if not self.running:
            return None
        key = self._stage_decode(N)
        self._note_burst_gap(overlapped=False)
        want_top = self._want_top(self.running)
        launch = self.graphs.launch(key, want_top)
        self.last_step_attn_dispatches += 1
        self.phase_counts["decode_multi.dispatch"] += 1
        return {"launch": launch, "key": key, "want_top": want_top}

    def _dispatch_spec(self, burst: Dict[str, Any]
                       ) -> Optional[Dict[str, Any]]:
        """Dispatch the NEXT burst from ``burst``'s carries before
        ``burst`` is read back; the generator's state before it is kept
        to restore on a rollback."""
        if not self._spec_eligible():
            return None
        self.graphs.save_generator()
        launch = self.graphs.launch(burst["key"], burst["want_top"])
        self.last_step_attn_dispatches += 1
        self.phase_counts["decode_multi.spec_dispatch"] += 1
        return {"launch": launch, "key": burst["key"],
                "want_top": burst["want_top"],
                "members": tuple((s.req.request_id, s.slot)
                                 for s in self.running)}

    def _spec_eligible(self) -> bool:
        """May the next burst go out before this one is read back? Only
        when the host post cannot need what the speculation lacks: no
        queued or cancelled work, nobody can expire by length inside the
        current burst (an EOS still rolls back), the speculative writes
        stay inside ``max_model_len`` and inside the pages already held
        (a speculation never allocates, so a rollback has nothing to
        undo), and not while the penalty counts await their rebuild."""
        N = self.decode_steps
        if self.waiting or self._cancelled:
            return False
        ps = self.ecfg.page_size
        for s in self.running:
            rem = s.req.sampling.max_tokens - s.num_generated
            if rem <= N:
                return False
            if len(s.tokens) + 2 * N - 1 > self.ecfg.max_model_len:
                return False
            if len(s.pages) * ps < len(s.tokens) + N + min(N, rem - N) - 1:
                return False
        if not self._counts_valid and any(
                s.req.sampling.presence_penalty
                or s.req.sampling.frequency_penalty for s in self.running):
            return False
        return True

    def _pending_matches(self, p: Dict[str, Any]) -> bool:
        """A speculative burst stays valid while the batch is what its
        carries assumed: the same members in the same slots (so every
        one accepted the whole burst, and the host's token tails equal
        the carries) and an unchanged active mask and page table."""
        members = tuple((s.req.request_id, s.slot) for s in self.running)
        if not members or members != p["members"]:
            return False
        return self.graphs.active_table_matches(
            *self._active_table(p["key"][0]))

    def _discard_spec(self, p: Dict[str, Any]) -> None:
        """Roll a speculative burst back: its device work finishes on its
        own and its outputs are dropped; the generator goes back to its
        state before it, and the carries are re-uploaded."""
        self.phase_counts["decode_multi.spec_rollback"] += 1
        self.graphs.restore_generator()
        # Its in-place count updates went into the counts: rebuilt from
        # host truth at the next dispatch.
        self._counts_valid = False
        self._resident = None
        # A rolled-back boundary was busy on the discarded burst: it is
        # kept out of the idle ledger.
        self._last_burst_ready_t = None

    def drain_pipeline(self) -> None:
        """Discard any in-flight speculative burst; called wherever the
        batch changes outside the decode loop (prefill sections, the
        ragged step, admission under prefill-first, warmup)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._discard_spec(pending)

    # ------------------------------------------------------------------
    # The step fault boundary (the worker's ``_contain_engine_fault``
    # drives these under its engine lock, as it drives ``step()``)
    # ------------------------------------------------------------------
    def _note_members(self, seqs: List[Sequence]) -> None:
        """Record a section's batch for fault attribution, then let the
        worker's hook raise. Called before the section stages or packs
        anything, so that a raise leaves no half-written input."""
        self.step_members = tuple(s.req.request_id for s in seqs)
        if self.fault_hook is not None:
            self.fault_hook(self.step_members)

    def live_request_ids(self) -> Tuple[str, ...]:
        """Every request the engine still owns (``_by_id``: a fault in a
        step can leave a sequence in neither queue)."""
        return tuple(self._by_id)

    def isolate(self, keep_rids: Seq[str]) -> None:
        """Confine the next step to ``keep_rids``: every other running
        sequence is preempted by recompute and every other waiting one
        parked; new arrivals park too, so a probe never takes in a
        bystander."""
        keep = set(keep_rids)
        self._fault_isolated = True
        for seq in [s for s in self.running
                    if s.req.request_id not in keep]:
            self._preempt_seq(seq)
        parked = [s for s in self.waiting
                  if s.req.request_id not in keep]
        for seq in parked:
            self.waiting.remove(seq)
        self._parked.extend(parked)

    def release_isolation(self) -> None:
        """Undo ``isolate``: the parked sequences rejoin the waiting
        queue (a probe's survivors keep their progress)."""
        self._fault_isolated = False
        parked, self._parked = self._parked, []
        for seq in parked:
            if seq.status != SeqStatus.FINISHED \
                    and seq not in self.waiting:
                self.waiting.append(seq)
        if parked:
            self._sort_waiting()

    @_rejoins
    def fault_reset(self, evict_rids: Seq[str] = ()) -> List[str]:
        """Recover from a step fault: ``evict_rids`` leave the engine and
        every survivor requeues for re-prefill with its tokens (the shape
        of a preemption by recompute). The KV the faulted step touched is
        suspect, so pages are released without being registered in the
        prefix cache; the speculative carry is dropped (draining it may
        itself raise); and the device state the runners keep between
        steps (the penalty counts, the staged table, sampling pair and
        bias, the carries) is marked stale, to be rebuilt from host
        truth by the next step. No static buffer is freed or
        reallocated. Returns the ids evicted."""
        self.release_isolation()
        try:
            self.drain_pipeline()
        except Exception:  # noqa: BLE001 — the carry may be the corrupt
            self._pending = None    # state; drop it unconsumed
        evict = set(evict_rids)
        evicted: List[str] = []
        for seq in list(self._by_id.values()):
            if seq.slot >= 0:
                self._slots[seq.slot] = None
                seq.slot = -1
            self.prefix_cache.release_pages([p for p in seq.pages if p])
            seq.pages = []
            seq.num_trimmed = 0
            seq.num_computed = 0
            seq.sched_window = 0
            seq.prompt_lps = None
            if seq in self.running:
                self.running.remove(seq)
            if seq.req.request_id in evict:
                seq.status = SeqStatus.FINISHED
                if seq in self.waiting:
                    self.waiting.remove(seq)
                self._by_id.pop(seq.req.request_id, None)
                self._cancelled.discard(seq.req.request_id)
                evicted.append(seq.req.request_id)
            else:
                seq.status = SeqStatus.WAITING
                self.num_preemptions += 1
                if seq not in self.waiting:
                    self.waiting.append(seq)
        self._sort_waiting()
        self._counts_valid = False
        self._resident = None
        self.graphs.invalidate_staged()
        return evicted

    def _note_burst_gap(self, overlapped: bool) -> None:
        """Host time between the previous burst's outputs being ready and
        this dispatch, during which the device had nothing queued (0 when
        a speculative burst covered it). Only consecutive decode bursts
        count."""
        t = self._last_burst_ready_t
        if t is None or self.step_count != self._last_burst_step + 1:
            return
        gap = 0.0 if overlapped else max(time.monotonic() - t, 0.0)
        self.phase_times["decode_multi.device_idle"] += gap
        self.phase_counts["decode_multi.device_idle"] += 1

    def _post_decode_multi(self, toks: List[List[int]],
                           lps: List[List[float]], tops,
                           carry_free: bool) -> List[StepOutput]:
        """Accept each sequence's burst tokens up to its first stop,
        register the pages they filled and trim sliding windows (a trim
        changes the page table, so it rolls a speculation back).
        ``carry_free``: no speculative burst went out, so the carries
        still hold this batch."""
        outs: List[StepOutput] = []
        for seq, slot in [(s, s.slot) for s in self.running]:
            accepted: List[int] = []
            logprobs: List[float] = []
            top = ([] if tops is not None and seq.req.sampling.logprobs
                   else None)
            reason = FinishReason.NONE
            for k in range(len(toks)):
                tok = toks[k][slot]
                seq.tokens.append(tok)
                accepted.append(tok)
                logprobs.append(lps[k][slot])
                if top is not None:
                    top.append(tops[k][slot])
                reason = self._finish_reason(seq, tok)
                if reason != FinishReason.NONE:
                    break
            # KV is resident for every token but the last sampled one.
            seq.num_computed = len(seq.tokens) - 1
            outs.append(StepOutput(
                request_id=seq.req.request_id, new_token_ids=accepted,
                logprobs=logprobs, finish_reason=reason,
                num_prompt_tokens=seq.num_prompt_tokens,
                num_generated=seq.num_generated, top_logprobs=top))
            if reason != FinishReason.NONE:
                self._finish_seq(seq, reason)
            else:
                self._register_pages(seq)
                self._swa_trim(seq)
        if carry_free:
            self._resident = self._snapshot()
        return outs

    def overlap_metrics(self) -> Dict[str, Any]:
        """Decode-pipeline health: speculation dispatch/hit/rollback
        counts, the hit ratio, and host-side device-idle ms per burst
        boundary (0 for boundaries a speculative burst covered)."""
        disp = self.phase_counts.get("decode_multi.spec_dispatch", 0)
        hits = self.phase_counts.get("decode_multi.spec_hit", 0)
        idle_n = self.phase_counts.get("decode_multi.device_idle", 0)
        idle_s = self.phase_times.get("decode_multi.device_idle", 0.0)
        return {
            "spec_dispatches": disp,
            "spec_hits": hits,
            "spec_rollbacks": self.phase_counts.get(
                "decode_multi.spec_rollback", 0),
            "hit_ratio": hits / disp if disp else 0.0,
            "device_idle_ms_per_burst":
                1e3 * idle_s / idle_n if idle_n else 0.0,
        }

    # ------------------------------------------------------------------
    # Warmup and the capture census
    # ------------------------------------------------------------------
    def warmup(self, buckets: Optional[Seq[int]] = None,
               extended: bool = True,
               prefill_shapes: Optional[Seq[Tuple[int, int, int]]] = None,
               decode_widths: Optional[Seq[int]] = None) -> float:
        """Capture every graph this configuration's steady state runs,
        on the JAX engine's warmup ladder, each in every sampling variant
        (greedy, sampled, sampled with a seeded row; decode each with and
        without the penalty counts) at the default logit-bias width:

        - prefill: every (pow2 B, bucket T) with (B - 1) + T <=
          max(budget, T), at the table widths pow2(pages(T)) and
          pow2(pages(T + 1)) (``prefill_graph.ladder``); only the first
          pair when not ``extended``; exactly ``prefill_shapes`` ((B, T,
          MP) triples) when given;
        - decode: each table width (``decode_widths``, default every
          power of two up to ``max_pages_per_seq`` and the clamp; the
          first only when not ``extended``), single steps and N-step
          bursts; a caller that passes its widths with ``decode_steps >
          1`` gets the bursts only (the JAX engine's scoped warmup);
        - ragged (when on, and ``extended``): the cross product of the
          pow2 batches, the prefill shapes' buckets and their widths
          with the decode widths.

        A shape warmup missed, a wider logit bias or a prompt-scored
        prefill is captured at its first use and counted as a capture
        after warmup, by program (the JAX engine's recompile counters;
        it compiles the counts' decode variant lazily too). Nothing is written to the pools and the
        generator's state is kept. Returns the seconds spent."""
        self.drain_pipeline()
        t0 = time.monotonic()
        # A second call (a wider scope) is warmup too, not a late capture.
        self.graphs.warm = self.prefill_graphs.warm = False
        buckets = tuple(buckets or self.ecfg.prefill_buckets)
        batch_pows = self._batch_pows()
        if prefill_shapes is None:
            prefill_shapes = prefill_graph.ladder(
                batch_pows, buckets, self.ecfg.max_prefill_tokens,
                self.ecfg.page_size, extended)
        for B, T, mp in prefill_shapes:
            self._roofline_capture("prefill", B, T, mp)
            for greedy, seeded in _VARIANTS:
                self.prefill_graphs.prepare(
                    ("prefill", B, T, mp, greedy, seeded))
        if decode_widths is None:
            widths = decode_graph.decode_widths(self.ecfg.max_pages_per_seq)
            if not extended:
                widths = widths[:1]
        else:
            widths = list(decode_widths)
        steps = sorted({1, self.decode_steps})
        if decode_widths is not None and self.decode_steps > 1:
            steps = [self.decode_steps]
        for width in widths:
            for n in steps:
                self._roofline_capture(
                    "decode" if n == 1 else "decode_multi",
                    self.ecfg.max_batch_size, 1, width)
                for greedy, seeded in _VARIANTS:
                    for penalized in (False, True):
                        self.graphs.prepare(
                            (width, n, greedy, seeded, penalized))
        if self.ragged and extended:
            t_set = sorted({T for _, T, _ in prefill_shapes})
            mp_set = sorted({mp for *_, mp in prefill_shapes} | set(widths))
            for B in batch_pows:
                for T in t_set:
                    for mp in mp_set:
                        self._roofline_capture("ragged", B, T, mp)
                        for greedy, seeded in _VARIANTS:
                            self.prefill_graphs.prepare(
                                ("ragged", B, T, mp, greedy, seeded))
        self.graphs.warm = self.prefill_graphs.warm = True
        return time.monotonic() - t0

    def _roofline_capture(self, program: str, B: int, T: int,
                          mp: int) -> None:
        """One warmup shape's analytic count (``models/cost.py``) into
        ``roofline``, under the JAX engine's key (``B{B}xT{T}xmp{mp}``
        with B x T tokens for ``prefill`` / ``ragged``; ``mp{mp}`` with
        the slots, times the burst for ``decode_multi``), at most
        ``XLLM_ROOFLINE_VARIANTS`` keys a program."""
        if not self._roofline_enabled:
            return
        table = self.roofline.setdefault(program, {})
        key = (f"B{B}xT{T}xmp{mp}" if program in ("prefill", "ragged")
               else f"mp{mp}")
        if key in table or len(table) >= self._roofline_cap:
            return
        table[key] = cost.forward_cost(self.cfg, program, B, T, mp,
                                       self.ecfg.page_size,
                                       self.decode_steps)

    def _batch_pows(self) -> List[int]:
        """The pow2 batch ladder up to ``max_batch_size``."""
        out, b = [], 1
        while b <= self.ecfg.max_batch_size:
            out.append(b)
            b <<= 1
        return out

    def late_window_shapes(self) -> List[Tuple[int, int, int]]:
        """The prefill ladder's (B, T) pairs at every other table width a
        step can take (the decode widths): a window that starts past
        token 0 (a chunked prompt's later window, a prefix-cache hit)
        takes a wider table than the pair's own. The JAX engine leaves
        these to lazy compiles; the worker captures them in its
        warmup."""
        ladder = prefill_graph.ladder(
            self._batch_pows(), self.ecfg.prefill_buckets,
            self.ecfg.max_prefill_tokens, self.ecfg.page_size, True)
        widths = decode_graph.decode_widths(self.ecfg.max_pages_per_seq)
        pairs = sorted({(B, T) for B, T, _ in ladder})
        return [(B, T, w) for B, T in pairs for w in widths
                if (B, T, w) not in ladder]

    def capture_report(self) -> Dict[str, Any]:
        """Per program (``prefill``, ``ragged``, ``decode``,
        ``decode_multi``): the graphs by key with their replays, the
        captures made after ``warmup()``, and the steps run eagerly, by
        reason: ``graphs_off`` (``cuda_graphs=False`` on CUDA) or
        ``cpu``; and their sums over every program."""
        return decode_graph.census_totals(
            {**self.prefill_graphs.programs(), **self.graphs.programs()},
            self.graphs.use_graphs)

    def compile_report(self) -> Dict[str, int]:
        """Graphs captured per program, warmup included (on the CPU, or
        with graphs off, the keys recorded): the counterpart of the JAX
        engine's ``compile_report``. ``ragged`` only where the ragged
        step is on."""
        rep = self.capture_report()
        return {p: rep[p]["captured"]
                for p in ("prefill", "ragged", "prefill_ring", "decode",
                          "decode_multi")
                if (p != "ragged" or self.ragged)
                and (p != "prefill_ring" or self._sp > 1)}

    def _append_token(self, seq: Sequence, tok: int, logprob: float,
                      top: Optional[List[List[Dict[str, Any]]]] = None
                      ) -> StepOutput:
        seq.tokens.append(tok)
        reason = self._finish_reason(seq, tok)
        out = StepOutput(
            request_id=seq.req.request_id, new_token_ids=[tok],
            logprobs=[logprob], finish_reason=reason,
            num_prompt_tokens=seq.num_prompt_tokens,
            num_generated=seq.num_generated, top_logprobs=top)
        if reason != FinishReason.NONE:
            self._finish_seq(seq, reason)
        elif seq.status == SeqStatus.RUNNING:
            # Register the pages the computed tokens filled (the token
            # just sampled has no KV yet), trim a sliding window, and
            # grow the table for the next token's write; the growth may
            # preempt ``seq``, which keeps this token and prefills it
            # again later.
            self._register_pages(seq)
            self._swa_trim(seq)
            self._grow_pages(seq)
        return out

    # ------------------------------------------------------------------
    # PD disaggregation: the KV handoff
    # ------------------------------------------------------------------
    @_rejoins
    def export_held(self, request_id: str, device: bool = False
                    ) -> Optional[Tuple[List[int], torch.Tensor,
                                        torch.Tensor]]:
        """A held (prefill-finished) sequence's KV, out of the pools:
        (tokens, k, v) with k and v [L, n_pages, page_size, H, D], gathered
        into fresh tensors, and its pages released. ``tokens`` end with the
        first sampled token, whose KV is not written yet (the decode side
        writes it in its first step). On the engine's device with
        ``device=True`` (the co-hosted direct path and the device wire),
        else on the CPU. None when nothing is held under the id."""
        seq = self._held.pop(request_id, None)
        if seq is None:
            return None
        self.drain_pipeline()
        k, v = self.kv_plane.gather(seq.pages, device=device)
        self.prefix_cache.release_pages([p for p in seq.pages if p])
        seq.pages = []
        return list(seq.tokens), k, v

    def drop_held(self, request_id: str) -> None:
        """Release a held sequence's pages unread."""
        seq = self._held.pop(request_id, None)
        if seq is not None:
            self.prefix_cache.release_pages([p for p in seq.pages if p])
            seq.pages = []

    @property
    def num_held(self) -> int:
        return len(self._held)

    @_rejoins
    def import_sequence(self, req: EngineRequest, tokens: Seq[int],
                        k, v) -> bool:
        """Adopt a migrated sequence mid-generation (the decode side of
        the handoff): ``tokens`` are the prompt and the first sampled
        token, ``k`` / ``v`` (tensors on any device, or numpy arrays) the
        KV of ``tokens[:-1]`` in the pools' layout. Takes a free slot and
        fresh pages (an online request preempts offline ones), scatters
        the block, adds a RUNNING sequence and registers its full pages
        in the prefix cache. False, with nothing changed, when the layout
        differs from this engine's (every KV head, also under a mesh) or
        no slot or pages are free: the caller decodes elsewhere."""
        self.drain_pipeline()
        n_pages = self._pages_needed(len(tokens))
        expect = self._block_shape(n_pages)
        if tuple(k.shape) != expect or tuple(v.shape) != expect \
                or k.dtype != v.dtype:
            return False
        slot = self._free_slot()
        if slot < 0:
            return False
        pages = self.prefix_cache.alloc(n_pages)
        while pages is None and not req.offline and \
                self._preempt_one_offline():
            pages = self.prefix_cache.alloc(n_pages)
        if pages is None:
            return False
        try:
            self.kv_plane.scatter(pages, k, v)
        except BaseException:
            # Unregistered: straight back to the free list.
            self.prefix_cache.release_pages(pages)
            raise
        seq = Sequence(req=req, tokens=list(tokens), pages=pages,
                       num_computed=len(tokens) - 1, slot=slot,
                       status=SeqStatus.RUNNING,
                       first_token_time=time.monotonic())
        self._by_id[req.request_id] = seq
        self.running.append(seq)
        self._slots[slot] = seq
        # The decode runner's staged rows change: the new slot's table,
        # sampling pair and bias restage at the next decode (each is
        # compared with what it holds), its carries with the batch
        # snapshot, and the penalty counts are rebuilt from the token
        # lists, the migrated first token included.
        self._counts_valid = False
        self._resident = None
        self._register_pages(seq)
        return True

    # ------------------------------------------------------------------
    # The cross-worker block fetch
    # ------------------------------------------------------------------
    @_rejoins
    def export_blocks(self, hashes: Seq[bytes], device: bool = False
                      ) -> Optional[Tuple[int, torch.Tensor, torch.Tensor]]:
        """The holder's side of a fetch (JAX engine ``export_blocks``):
        the K/V of a contiguous run of block digests, gathered out of the
        pools and extended with the blocks parked in the host tier (its
        disk copies included). Returns (n, k, v), k and v [L, n,
        page_size, H, D], or None when the leading digest is held
        nowhere. On the engine's device only with ``device=True`` and the
        whole run in the pools (for the device wire; a tier block is on
        the host already), else on the CPU.

        ``pages_for_hashes`` pins the pages: a reclamation racing the
        gather would hand the requester another prompt's KV. The pins
        drop in the ``finally`` as soon as the gather is enqueued: the
        gather lands in a fresh tensor, on the current stream (the
        device's default stream, the one the engine loop's steps and
        graph replays run on), so it is ordered before any later write
        of a reclaimed page by the same stream."""
        pages = self.prefix_cache.pages_for_hashes(hashes)
        n_pool = len(pages)
        k = v = None
        on_device = device and n_pool == len(hashes)
        try:
            if n_pool:
                k, v = self.kv_plane.gather(pages, device=on_device)
        finally:
            self.prefix_cache.release_pages(pages)
        if n_pool and on_device:
            return n_pool, k, v
        parts_k = [k] if n_pool else []
        parts_v = [v] if n_pool else []
        i = n_pool
        while self.host_tier is not None and i < len(hashes):
            blk = self.host_tier.peek(hashes[i])
            if blk is None:
                break
            parts_k.append(torch.as_tensor(blk[0]).unsqueeze(1))
            parts_v.append(torch.as_tensor(blk[1]).unsqueeze(1))
            i += 1
        if not parts_k:
            return None
        return i, torch.cat(parts_k, dim=1), torch.cat(parts_v, dim=1)

    @_rejoins
    def adopt_blocks(self, token_ids: Seq[int], start_block: int,
                     k, v) -> int:
        """The requester's side (JAX engine ``adopt_blocks``): blocks
        ``start_block .. start_block + n - 1`` of ``token_ids``' digest
        chain, k and v [L, n, page_size, H, D] (tensors on any device, or
        numpy arrays), written into fresh pages and registered as cached,
        reclaimable pages, so that the prompt's admission hits them as a
        local prefix. Returns the blocks adopted; 0, with nothing
        changed, on a layout that is not the pools', a run past the
        prompt's full blocks, a lead block held neither in the pools nor
        in the host tier (the run would be unreachable), or no free
        pages: the caller then prefills from its own hit.

        The scatter is an in-place ``index_copy_``: the pools are the
        static buffers the decode, prefill and ragged graphs captured.
        The adopted pages belong to no sequence, so nothing a runner
        stages changes; the next admission's page table is packed whole
        into the prefill runner's buffer."""
        self.drain_pipeline()
        n = int(k.shape[1]) if len(getattr(k, "shape", ())) == 5 else 0
        expect = self._block_shape(n)
        if n <= 0 or tuple(k.shape) != expect or \
                tuple(v.shape) != expect:
            return 0
        hashes = self.prefix_cache.block_hashes(token_ids)
        if start_block + n > len(hashes):
            return 0
        # The chain below the run must resolve here, or its digests would
        # be unreachable (match_prefix walks from block 0). A lead in the
        # host tier counts: the admission restores it and then picks up
        # the adopted pages behind it. The pool's leads stay pinned
        # across the allocation, whose reclamation would otherwise free
        # the chain's own head.
        lead = []
        for h in hashes[:start_block]:
            pid = self.prefix_cache.page_of(h)
            if pid is not None:
                lead.append(pid)
            elif self.host_tier is None or h not in self.host_tier:
                return 0
        self.prefix_cache.acquire_pages(lead)
        try:
            pages = self.prefix_cache.alloc(n)
            if pages is None:
                return 0
            # Released registered (cached, reclaimable), or, when the
            # scatter raised, unregistered (freed).
            try:
                self.kv_plane.scatter(pages, k, v)
                self.prefix_cache.register_blocks(
                    hashes[start_block:start_block + n], pages)
            finally:
                self.prefix_cache.release_pages(pages)
        finally:
            self.prefix_cache.release_pages(lead)
        self.fetched_blocks += n
        return n

    # ------------------------------------------------------------------
    # The host spill tier
    # ------------------------------------------------------------------
    @_rejoins
    def _spill_page(self, h: bytes, pid: int) -> bool:
        """The prefix index's spill hook: copy page ``pid``, about to be
        reclaimed, into the host tier under digest ``h``. The copy is
        taken here, before the page's next owner is handed it, so it
        reads the content the page held: every KV head, gathered from
        the ranks under a mesh. The index takes a raise for a plain
        eviction, so the world re-forms here when it left it out of
        step."""
        if self.host_tier is None:
            return False
        k, v = self.kv_plane.gather([pid])
        return self.host_tier.put(h, k[:, 0], v[:, 0])

    def _restore_spilled(self, tokens: Seq[int], pages: List[int],
                         cached_tokens: int) -> Tuple[List[int], int]:
        """Extend an index hit past where ``match_prefix`` stopped, over
        blocks the host tier holds (copied back into fresh pages) and
        registered pages behind them (acquired as a hit would be). The
        tier's blocks are taken out before the allocation, so that the
        allocation's own spills cannot push them out; whatever fails
        (the allocation, the copy) unpins the acquired pages, releases
        the fresh ones and puts the blocks back."""
        ps = self.ecfg.page_size
        hashes = self.prefix_cache.block_hashes(tokens)
        i = len(pages)
        # ("tier", hash, blocks) | ("hbm", hash, page), in block order;
        # never the whole prompt (prefill needs one new token).
        plan: List[Tuple[str, bytes, Any]] = []
        n_tier = 0
        while i < len(hashes) and (i + 1) * ps < len(tokens):
            blk = self.host_tier.peek(hashes[i])
            if blk is not None:
                plan.append(("tier", hashes[i], blk))
                n_tier += 1
            else:
                pid = self.prefix_cache.page_of(hashes[i])
                if pid is None:
                    break
                plan.append(("hbm", hashes[i], pid))
            i += 1
        if not n_tier:
            return pages, cached_tokens
        hbm_pids = [p[2] for p in plan if p[0] == "hbm"]
        self.prefix_cache.acquire_pages(hbm_pids)
        restored = False
        new_pages = None
        try:
            for kind, h, _ in plan:
                if kind == "tier":
                    self.host_tier.pop(h)
            new_pages = self.prefix_cache.alloc(n_tier)
            if new_pages is not None:
                blocks = [b for kind, _, b in plan if kind == "tier"]
                self.kv_plane.scatter(
                    new_pages,
                    *(torch.stack([torch.as_tensor(b[i]) for b in blocks],
                                  dim=1) for i in range(2)))
                restored = True
        finally:
            if not restored:
                self.prefix_cache.release_pages(hbm_pids)
                if new_pages is not None:
                    # Unregistered: straight back to the free list.
                    self.prefix_cache.release_pages(new_pages)
                for kind, h, blk in plan:
                    if kind == "tier":
                        self.host_tier.put(h, *blk)
        if new_pages is None:
            return pages, cached_tokens
        new_iter = iter(new_pages)
        chain = [next(new_iter) if kind == "tier" else payload
                 for kind, _, payload in plan]
        all_pages = list(pages) + chain
        self.prefix_cache.register_full_pages(tokens[:i * ps], all_pages)
        return all_pages, i * ps

    def _finish_reason(self, seq: Sequence, tok: int) -> FinishReason:
        sp = seq.req.sampling
        if not sp.ignore_eos and (tok in seq.req.eos_token_ids or
                                  tok in sp.stop_token_ids):
            return FinishReason.STOP
        if seq.num_generated >= sp.max_tokens:
            return FinishReason.LENGTH
        if len(seq.tokens) >= self.ecfg.max_model_len:
            return FinishReason.LENGTH
        return FinishReason.NONE
