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
the step; only the sampled ids and their logprobs cross to the host.

Pages are allocated as the JAX engine allocates them: admission takes
only the pages of the first window (plus the first sampled token's when
that window completes the prompt), a later window extends the table to
cover it, and every decode grows it to cover the token it writes. When
the pool runs out, the sequence that needs the pages is preempted by
recompute: its slot and pages are freed and it requeues with its
generated tokens, to be prefilled again. (The JAX engine first evicts
offline requests; this package has no offline requests, so the needy
sequence is always its own victim, as in the JAX engine under online
traffic.) Only a prompt whose KV can never fit the pool is refused.

A sequence finishes on EOS, a stop token id, ``max_tokens`` or
``max_model_len``; its pages and slot are freed then.

Not in this package yet: the prefix cache, offline requests, fused
multi-step decode and its pipeline, CUDA graphs, the step fault boundary
and the step trace.
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
from xllm_service_tpu_torch.ops.kernels import ragged_attention
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


def resolve_write_then_attend(flag: Optional[bool],
                              device: torch.device) -> bool:
    """``EngineConfig.write_then_attend`` for an engine on ``device``:
    an explicit value wins; None means on where the CUDA kernels run."""
    return device.type == "cuda" if flag is None else bool(flag)


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
        # The interleaver's knobs and the ragged switch, resolved once.
        self.interleave = engine_cfg.interleave is not False
        self.step_token_budget = (engine_cfg.step_token_budget
                                  or engine_cfg.max_prefill_tokens)
        self.prefill_deadline_ms = float(engine_cfg.prefill_deadline_ms)
        # MLA models have no ragged mixed step (as in the JAX engine):
        # their mixed iterations run split.
        self.ragged = bool(engine_cfg.ragged_attn) and not model_cfg.mla
        if self.ragged:
            # The ragged kernel's largest bucket, refused here rather
            # than at the first mixed iteration that reaches it.
            ragged_attention.check_sizes(
                _pow2(engine_cfg.max_batch_size),
                max(engine_cfg.prefill_buckets),
                model_cfg.num_heads // model_cfg.num_kv_heads)
        self.write_then_attend = resolve_write_then_attend(
            engine_cfg.write_then_attend, self.device)
        # What the last step() did (the JAX engine's step ledger). A
        # forward is one attention dispatch: decode, prefill or ragged.
        self.last_step_kind = "idle"    # "prefill"|"decode"|"mixed"|"idle"
        self.last_step_tokens = 0
        self.last_step_prefill_tokens = 0
        self.last_step_decode_tokens = 0
        self.last_step_prefill_windows: Tuple[int, ...] = ()
        self.last_step_decode_deferred = False
        self.last_step_ragged = False
        self.last_step_attn_dispatches = 0
        self.ragged_steps = 0           # ragged forwards run so far
        self.num_preemptions = 0

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
        seq = Sequence(req=req, tokens=list(req.token_ids))
        self._by_id[req.request_id] = seq
        self.waiting.append(seq)
        self._sort_waiting()

    def _sort_waiting(self) -> None:
        # Sequences between chunked windows first (they hold a slot and
        # pages), then by arrival.
        self.waiting.sort(key=lambda s: (s.slot < 0, s.req.arrival_time))

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

    def _free_slot(self) -> int:
        return next((i for i, s in enumerate(self._slots) if s is None), -1)

    def _window_pages_covered(self, seq: Sequence, window: int) -> int:
        """Token positions the pages must cover for a prefill window of
        ``window`` tokens from ``seq.num_computed``: the window, plus the
        token it samples when it completes the prompt."""
        end = seq.num_computed + window
        return end + (1 if end >= len(seq.tokens) else 0)

    def _try_admit(self, seq: Sequence, window: int) -> bool:
        """Take a free slot and the pages of ``seq``'s first prefill
        window; later windows and decode grow the table."""
        slot = self._free_slot()
        if slot < 0:
            return False
        pages = self.allocator.alloc(self._pages_needed(
            self._window_pages_covered(seq, window)))
        if pages is None:
            return False
        seq.pages = pages
        seq.slot = slot
        self._slots[slot] = seq
        return True

    def _preempt_seq(self, seq: Sequence) -> None:
        """Preemption by recompute: free the slot and pages and requeue;
        the generated tokens are kept and prefilled again on
        readmission."""
        if seq.slot >= 0:
            self._slots[seq.slot] = None
            seq.slot = -1
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.num_computed = 0
        seq.sched_window = 0
        seq.status = SeqStatus.WAITING
        self.num_preemptions += 1
        if seq in self.running:
            self.running.remove(seq)
        if seq not in self.waiting:     # a partial prefill already waits
            self.waiting.append(seq)
        self._sort_waiting()

    def _grow_pages(self, seq: Sequence) -> bool:
        """Pages for ``seq``'s next token write (see ``_ensure_pages``)."""
        return self._ensure_pages(seq, len(seq.tokens))

    def _ensure_pages(self, seq: Sequence, covered: int) -> bool:
        """Extend ``seq``'s page table to cover ``covered`` token
        positions. When the pool is short, ``seq`` preempts itself (the
        JAX engine would first evict an offline request; this package
        has none) and False is returned."""
        need = self._pages_needed(covered) - len(seq.pages)
        if need <= 0:
            return True
        pages = self.allocator.alloc(need)
        if pages is None:
            self._preempt_seq(seq)
            return False
        seq.pages.extend(pages)
        return True

    def _grow_running(self) -> None:
        """Grow every running sequence's table for this step's decode
        write; growth may preempt, hence the snapshot."""
        for seq in list(self.running):
            self._grow_pages(seq)

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
        """One iteration, interleaved or prefill-first (see the module
        docstring); ``last_step_*`` describe it afterwards."""
        self.step_count += 1
        outs = self._drain_cancelled()
        self.last_step_prefill_tokens = 0
        self.last_step_decode_tokens = 0
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
        decoded = self._run_decode()
        self.last_step_decode_tokens = sum(len(o.new_token_ids)
                                           for o in decoded)
        outs.extend(decoded)

    def _prefill_section(self, batch: List[Sequence],
                         outs: List[StepOutput]) -> None:
        # Prefill occupancy is the prompt tokens computed, not the one
        # token sampled per window.
        self.last_step_prefill_windows = tuple(s.sched_window for s in batch)
        self.last_step_prefill_tokens = sum(self.last_step_prefill_windows)
        outs.extend(self._run_prefill(batch))

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
        decode_seqs = list(self.running)
        # A ragged decode row spends one token of the budget.
        budget = max(self.step_token_budget - len(decode_seqs),
                     self._starvation_quantum())
        if budget <= 0:
            return False
        batch = self._schedule_prefill(budget)
        if not batch:
            return False
        self._run_ragged(decode_seqs, batch, outs)
        return True

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

    # Bounded skip-ahead past refused admissions: a prompt behind one
    # whose pages do not fit still admits this step; the refused one
    # keeps its place and retries first on the next step.
    _ADMIT_SKIP_AHEAD = 4

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
        for seq in list(self.waiting):
            window = min(len(seq.tokens) - seq.num_computed,
                         self._window_cap(budget if interleaved else None))
            if window <= 0:
                break               # residual below the smallest bucket
            if batch and window > budget:
                break
            if seq.slot < 0:
                if not self._try_admit(seq, window):
                    if self._free_slot() < 0 or \
                            skipped >= self._ADMIT_SKIP_AHEAD:
                        break       # no slot at all, or the bound is hit
                    skipped += 1
                    continue        # pages short: try the next prompt
            elif not self._ensure_pages(
                    seq, self._window_pages_covered(seq, window)):
                continue            # preempted itself: waits, slotless
            seq.sched_window = window
            budget -= window
            self.waiting.remove(seq)
            batch.append(seq)
            if budget <= 0 or len(batch) >= self.ecfg.max_batch_size:
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

    def _forward_windows(self, rows: List[Sequence],
                         spans: List[Tuple[int, int]],
                         ragged: bool) -> Tuple[List[int], List[float]]:
        """One forward_prefill over ``rows``, row i taking the tokens
        [start, start + n) of ``spans[i]``; the batch pads to a power of
        two rows and to the bucket of the longest span. Returns the
        token sampled after each row's last token, and its logprob."""
        B = _pow2(len(rows))
        T = self._bucket(max(n for _, n in spans))
        # The writer and the attention kernels touch only [start,
        # start + n) of a row, inside its own pages.
        MP = min(_pow2(max(len(s.pages) for s in rows)),
                 self.ecfg.max_pages_per_seq)
        tokens = np.zeros((B, T), np.int64)
        start = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        table = np.zeros((B, MP), np.int32)
        for i, (seq, (st, n)) in enumerate(zip(rows, spans)):
            tokens[i, :n] = seq.tokens[st:st + n]
            start[i] = st
            lengths[i] = n
            table[i, :len(seq.pages)] = seq.pages
        logits, self.kv = transformer.forward_prefill(
            self.params, self.cfg, self._to_device(tokens),
            self._to_device(start), self._to_device(lengths), self.kv,
            self._to_device(table), ragged=ragged,
            write_then_attend=ragged or self.write_then_attend)
        self.last_step_attn_dispatches += 1
        positions = [int(start[i] + lengths[i] - 1) for i in range(B)]
        return self._sample(logits, [s.req.sampling for s in rows],
                            positions)

    def _run_prefill(self, batch: List[Sequence]) -> List[StepOutput]:
        windows = [s.sched_window for s in batch]
        toks, lps = self._forward_windows(
            batch, [(s.num_computed, w) for s, w in zip(batch, windows)],
            ragged=False)
        return self._finish_windows(batch, windows, toks, lps)

    def _run_ragged(self, decode_seqs: List[Sequence], batch: List[Sequence],
                    outs: List[StepOutput]) -> None:
        """One forward for a mixed iteration: the decode rows first, each
        a length-1 window at start = len(tokens) - 1 (mid-page as often
        as not), then the scheduled prefill windows. Rows are indexed by
        their place in the batch, not by decode slot."""
        windows = [s.sched_window for s in batch]
        rows = decode_seqs + batch
        nd = len(decode_seqs)
        self.last_step_ragged = True
        self.last_step_prefill_windows = tuple(windows)
        self.last_step_prefill_tokens = sum(windows)
        self.last_step_decode_tokens = nd
        spans = [(len(s.tokens) - 1, 1) for s in decode_seqs] + \
            [(s.num_computed, w) for s, w in zip(batch, windows)]
        toks, lps = self._forward_windows(rows, spans, ragged=True)
        self.ragged_steps += 1
        for i, seq in enumerate(decode_seqs):
            seq.num_computed = len(seq.tokens)
            outs.append(self._append_token(seq, toks[i], lps[i]))
        outs.extend(self._finish_windows(batch, windows, toks[nd:],
                                         lps[nd:]))

    def _finish_windows(self, batch: List[Sequence], windows: List[int],
                        toks: List[int], lps: List[float]
                        ) -> List[StepOutput]:
        now = time.monotonic()
        outs: List[StepOutput] = []
        for i, seq in enumerate(batch):
            seq.sched_window = 0
            seq.num_computed += windows[i]
            if seq.num_computed < len(seq.tokens):
                # Mid-prompt window: its sampled token is discarded and
                # the sequence (slot and pages kept) waits for its next
                # window at the front of the queue.
                self.waiting.append(seq)
                continue
            seq.status = SeqStatus.RUNNING
            seq.first_token_time = now
            self.running.append(seq)
            outs.append(self._append_token(seq, toks[i], lps[i]))
        self._sort_waiting()
        return outs

    def _run_decode(self) -> List[StepOutput]:
        self._grow_running()
        if not self.running:
            return []
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
            self._to_device(table), write_then_attend=self.write_then_attend)
        self.last_step_attn_dispatches += 1
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
        else:
            # Pages for the next token's write; may preempt ``seq``,
            # which keeps this token and prefills it again later.
            self._grow_pages(seq)
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
