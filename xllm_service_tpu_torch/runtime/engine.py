"""Continuous-batching inference engine over the paged KV cache.

The counterpart of the JAX package's ``runtime/engine.py`` for one model
on one CUDA device (or on the CPU, where every kernel runs its plain
version). Each ``step()`` first decodes every running sequence in one
fixed-slot batch of ``max_batch_size`` rows, then spends what is left of
the ``max_prefill_tokens`` budget on prefill windows:

- a prompt prefills in windows of at most one bucket of
  ``prefill_buckets``; the window shrinks to the largest bucket that
  fits the step's remaining budget, so prompts longer than it prefill
  in chunks over several steps, each window starting where the last
  ended (a sum of bucket sizes, so page-aligned for page-multiple
  buckets);
- the prefill batch pads to a power of two rows and its window to the
  bucket that holds the longest window;
- tokens are sampled on the device inside the step; only the sampled
  ids and their logprobs cross to the host.

A sequence finishes on EOS, a stop token id, ``max_tokens`` or
``max_model_len``; its pages and slot are freed then.

Not in this package yet: the prefix cache, preemption (admission
reserves the pages of the whole sequence instead), fused multi-step
decode and its pipeline, the ragged mixed step, CUDA graphs, the step
fault boundary and the step trace.
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.config import EngineConfig, ModelConfig
from xllm_service_tpu_torch.models import transformer
from xllm_service_tpu_torch.ops.sampling import (compute_logprobs,
                                                 sample_tokens)
from xllm_service_tpu_torch.runtime.kv_cache import PageAllocator
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


@dataclasses.dataclass
class EngineRequest:
    """A tokenized generation request."""

    request_id: str
    token_ids: List[int]
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    eos_token_ids: Tuple[int, ...] = ()
    arrival_time: float = 0.0


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
    slot: int = -1                     # decode slot, -1 = none
    status: SeqStatus = SeqStatus.WAITING
    first_token_time: float = 0.0
    # Window the scheduler pinned for this step's prefill.
    sched_window: int = 0

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

    @property
    def finished(self) -> bool:
        return self.finish_reason != FinishReason.NONE


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class Engine:
    """Single-model continuous-batching engine. Not thread-safe: drive
    ``step()`` from one thread (the worker's engine loop)."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[transformer.Params] = None,
                 device="cuda", seed: int = 0) -> None:
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        transformer.check_supported(model_cfg)
        if params is None:
            init_gen = torch.Generator(device=self.device).manual_seed(0)
            params = transformer.init_params(model_cfg, init_gen,
                                             self.device)
        self.params = params
        self.kv = transformer.init_kv_cache(
            model_cfg, engine_cfg.num_pages, engine_cfg.page_size,
            self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.allocator = PageAllocator(engine_cfg.num_pages)
        self.waiting: List[Sequence] = []
        self.running: List[Sequence] = []
        self._by_id: Dict[str, Sequence] = {}
        self._slots: List[Optional[Sequence]] = \
            [None] * engine_cfg.max_batch_size
        self._cancelled: set = set()
        self.step_count = 0

    # ------------------------------------------------------------------
    # Request intake
    # ------------------------------------------------------------------
    def add_request(self, req: EngineRequest) -> None:
        if not req.token_ids:
            raise ValueError("empty prompt")
        max_prompt = self.ecfg.max_model_len - 1
        if len(req.token_ids) > max_prompt:
            raise ValueError(
                f"prompt of {len(req.token_ids)} tokens exceeds the "
                f"engine's limit of {max_prompt}")
        if len(req.token_ids) + req.sampling.max_tokens > \
                self.ecfg.max_model_len:
            req = dataclasses.replace(
                req, sampling=dataclasses.replace(
                    req.sampling,
                    max_tokens=max(
                        1, self.ecfg.max_model_len - len(req.token_ids))))
        # Admission reserves the whole sequence's pages: one that can
        # never fit the pool (page 0 is NULL, hence the -1) is refused.
        if self._pages_needed(self._reserve_tokens(req)) > \
                self.ecfg.num_pages - 1:
            raise ValueError(
                f"request of {len(req.token_ids)} prompt tokens and "
                f"{req.sampling.max_tokens} new tokens needs more KV pages "
                f"than the pool holds ({self.ecfg.num_pages - 1} x "
                f"{self.ecfg.page_size} tokens)")
        if req.arrival_time == 0.0:
            req.arrival_time = time.monotonic()
        seq = Sequence(req=req, tokens=list(req.token_ids))
        self._by_id[req.request_id] = seq
        self.waiting.append(seq)

    def cancel(self, request_id: str) -> None:
        self._cancelled.add(request_id)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._cancelled)

    # ------------------------------------------------------------------
    # Pages and slots
    # ------------------------------------------------------------------
    def _pages_needed(self, num_tokens: int) -> int:
        ps = self.ecfg.page_size
        return (num_tokens + ps - 1) // ps

    @staticmethod
    def _reserve_tokens(req: EngineRequest) -> int:
        # The last sampled token is never written to the pool.
        return len(req.token_ids) + max(req.sampling.max_tokens - 1, 0)

    def _try_admit(self, seq: Sequence) -> bool:
        """Take a free slot and the pages of the whole sequence."""
        slot = next((i for i, s in enumerate(self._slots) if s is None), -1)
        if slot < 0:
            return False
        pages = self.allocator.alloc(
            self._pages_needed(self._reserve_tokens(seq.req)))
        if pages is None:
            return False
        seq.pages = pages
        seq.slot = slot
        self._slots[slot] = seq
        return True

    def _finish_seq(self, seq: Sequence) -> None:
        seq.status = SeqStatus.FINISHED
        if seq.slot >= 0:
            self._slots[seq.slot] = None
            seq.slot = -1
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        self._by_id.pop(seq.req.request_id, None)
        self._cancelled.discard(seq.req.request_id)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------
    def step(self) -> List[StepOutput]:
        """One iteration: decode the running set, then prefill windows
        with the rest of the token budget."""
        self.step_count += 1
        outs = self._drain_cancelled()
        if self.running:
            outs.extend(self._run_decode())
        decoded = sum(len(o.new_token_ids) for o in outs)
        # The budget never drops below one smallest bucket, so prompts
        # keep moving while a full decode batch runs.
        budget = max(self.ecfg.max_prefill_tokens - decoded,
                     self.ecfg.prefill_buckets[0])
        batch = self._schedule_prefill(budget)
        if batch:
            outs.extend(self._run_prefill(batch))
        return outs

    def _drain_cancelled(self) -> List[StepOutput]:
        outs = []
        for rid in list(self._cancelled):
            seq = self._by_id.get(rid)
            self._cancelled.discard(rid)
            if seq is None:
                continue
            self._finish_seq(seq)
            outs.append(StepOutput(
                request_id=rid, new_token_ids=[], logprobs=[],
                finish_reason=FinishReason.CANCELLED,
                num_prompt_tokens=seq.num_prompt_tokens,
                num_generated=seq.num_generated))
        return outs

    def _window_cap(self, budget: int) -> int:
        """Largest prefill bucket not above ``budget`` (0 if none)."""
        i = bisect.bisect_right(self.ecfg.prefill_buckets, budget)
        return self.ecfg.prefill_buckets[i - 1] if i else 0

    def _schedule_prefill(self, budget: int) -> List[Sequence]:
        """Pick the prefill windows of this step, in queue order (a
        sequence between chunked windows keeps its place at the front)."""
        batch: List[Sequence] = []
        for seq in list(self.waiting):
            window = min(len(seq.tokens) - seq.num_computed,
                         self._window_cap(budget))
            if window <= 0:
                break
            if seq.slot < 0 and not self._try_admit(seq):
                break
            seq.sched_window = window
            budget -= window
            self.waiting.remove(seq)
            batch.append(seq)
            if len(batch) >= self.ecfg.max_batch_size:
                break
        return batch

    def _bucket(self, n: int) -> int:
        buckets = self.ecfg.prefill_buckets
        return buckets[bisect.bisect_left(buckets, n)]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _sample(self, logits: torch.Tensor, params: List[SamplingParams],
                positions: List[int]) -> Tuple[List[int], List[float]]:
        tok = sample_tokens(logits, params, self.generator, positions)
        lp = compute_logprobs(logits, tok)
        return tok.tolist(), lp.tolist()

    def _run_prefill(self, batch: List[Sequence]) -> List[StepOutput]:
        windows = [s.sched_window for s in batch]
        B = _pow2(len(batch))
        T = self._bucket(max(windows))
        MP = _pow2(max(max(len(s.pages) for s in batch),
                       max(self._pages_needed(s.num_computed + T)
                           for s in batch)))
        tokens = np.zeros((B, T), np.int64)
        start = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        table = np.zeros((B, MP), np.int32)
        for i, seq in enumerate(batch):
            new = seq.tokens[seq.num_computed:seq.num_computed + windows[i]]
            tokens[i, :len(new)] = new
            start[i] = seq.num_computed
            lengths[i] = len(new)
            table[i, :len(seq.pages)] = seq.pages
        logits, self.kv = transformer.forward_prefill(
            self.params, self.cfg, self._to_device(tokens),
            self._to_device(start), self._to_device(lengths), self.kv,
            self._to_device(table))
        positions = [int(start[i] + lengths[i] - 1) for i in range(B)]
        toks, lps = self._sample(logits, [s.req.sampling for s in batch],
                                 positions)
        now = time.monotonic()
        outs: List[StepOutput] = []
        resumed: List[Sequence] = []
        for i, seq in enumerate(batch):
            seq.sched_window = 0
            seq.num_computed += windows[i]
            if seq.num_computed < len(seq.tokens):
                # Mid-prompt window: its sampled token is discarded and
                # the sequence (slot and pages kept) waits for its next
                # window at the front of the queue.
                resumed.append(seq)
                continue
            seq.status = SeqStatus.RUNNING
            seq.first_token_time = now
            self.running.append(seq)
            outs.append(self._append_token(seq, toks[i], lps[i]))
        self.waiting[:0] = resumed
        return outs

    def _run_decode(self) -> List[StepOutput]:
        B = self.ecfg.max_batch_size
        MP = min(_pow2(max(len(s.pages) for s in self.running)),
                 self.ecfg.max_pages_per_seq)
        tokens = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int32)
        active = np.zeros((B,), np.bool_)
        table = np.zeros((B, MP), np.int32)
        params: List[SamplingParams] = [SamplingParams(temperature=0.0)] * B
        for seq in self.running:
            i = seq.slot
            tokens[i] = seq.tokens[-1]
            positions[i] = len(seq.tokens) - 1
            active[i] = True
            table[i, :min(len(seq.pages), MP)] = seq.pages[:MP]
            params[i] = seq.req.sampling
        logits, self.kv = transformer.forward_decode(
            self.params, self.cfg, self._to_device(tokens),
            self._to_device(positions), self._to_device(active), self.kv,
            self._to_device(table))
        toks, lps = self._sample(logits, params, positions.tolist())
        outs = []
        for seq in list(self.running):
            seq.num_computed = len(seq.tokens)
            outs.append(self._append_token(seq, toks[seq.slot],
                                           lps[seq.slot]))
        return outs

    def _append_token(self, seq: Sequence, tok: int,
                      logprob: float) -> StepOutput:
        seq.tokens.append(tok)
        reason = self._finish_reason(seq, tok)
        out = StepOutput(
            request_id=seq.req.request_id, new_token_ids=[tok],
            logprobs=[logprob], finish_reason=reason,
            num_prompt_tokens=seq.num_prompt_tokens,
            num_generated=seq.num_generated)
        if reason != FinishReason.NONE:
            self._finish_seq(seq)
        return out

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
