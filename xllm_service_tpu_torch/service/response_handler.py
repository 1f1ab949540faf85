"""OpenAI chat/completion payload assembly for the worker's HTTP front.

A copy of the JAX package's ``service/response_handler.py`` assemblers,
so both workers send the same bytes:

  chat stream:  role chunk → content delta chunks → finish_reason chunk →
                (optional) usage chunk → ``data: [DONE]``
  completion stream: text delta chunks → finish chunk → usage → [DONE]
  non-stream:   one full JSON body

SSE framing is ``data: <json>\n\n``. The service relay's recovery-ledger
extension (per-frame token ids) is not part of this copy.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from xllm_service_tpu_torch.obs import profiler
from xllm_service_tpu_torch.utils.types import (
    FinishReason, LogProb, RequestOutput, Usage)

SSE_DONE = b"data: [DONE]\n\n"


def _now() -> int:
    return int(time.time())


def sse_frame(obj: Dict[str, Any]) -> bytes:
    with profiler.section("sse.assemble"):
        return b"data: " \
            + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def _chat_logprob_entry(lp: LogProb) -> Dict[str, Any]:
    return {
        "token": lp.token,
        "logprob": lp.logprob,
        "bytes": list(lp.token.encode("utf-8")),
        "top_logprobs": [
            {"token": t.get("token", ""), "logprob": t.get("logprob", 0.0),
             "bytes": list(str(t.get("token", "")).encode("utf-8"))}
            for t in lp.top_logprobs],
    }


def _chat_logprobs_json(lps: List[LogProb]) -> Optional[Dict[str, Any]]:
    if not lps:
        return None
    return {"content": [_chat_logprob_entry(lp) for lp in lps]}


class _CompletionLogprobs:
    """Accumulates the completion API's parallel-array logprobs shape."""

    def __init__(self) -> None:
        self.tokens: List[str] = []
        self.token_logprobs: List[float] = []
        self.top_logprobs: List[Dict[str, float]] = []
        self.text_offset: List[int] = []
        self._offset = 0

    def add(self, lps: List[LogProb]) -> None:
        for lp in lps:
            self.tokens.append(lp.token)
            self.token_logprobs.append(lp.logprob)
            self.top_logprobs.append(
                {t.get("token", ""): t.get("logprob", 0.0)
                 for t in lp.top_logprobs})
            self.text_offset.append(self._offset)
            self._offset += len(lp.token)

    def to_json(self) -> Optional[Dict[str, Any]]:
        if not self.tokens:
            return None
        return {"tokens": self.tokens,
                "token_logprobs": self.token_logprobs,
                "top_logprobs": self.top_logprobs,
                "text_offset": self.text_offset}


class ChatStreamAssembler:
    """Builds the chat-completion SSE chunk sequence for one request
    (every choice index streams role → deltas → finish).

    ``emit_token_ids``: the relay's token ledger (the master sets
    ``ledger_tokens`` on a forwarded body): every delta chunk carries its
    engine token ids under a top-level ``"xllm"`` key, and a delta is
    sent even when its text is empty, so that the master knows every
    token delivered and can resume a broken stream on another worker.
    The master strips the key before the client sees the chunk."""

    def __init__(self, request_id: str, model: str,
                 include_usage: bool = False,
                 emit_token_ids: bool = False) -> None:
        self.request_id = request_id
        self.model = model
        self.include_usage = include_usage
        self.emit_token_ids = emit_token_ids
        self.created = _now()
        self._sent_role: set = set()
        self._usage = Usage()

    def _chunk(self, delta: Dict[str, Any], index: int = 0,
               finish_reason: Optional[str] = None,
               logprobs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        choice: Dict[str, Any] = {"index": index, "delta": delta,
                                  "finish_reason": finish_reason}
        if logprobs is not None:
            choice["logprobs"] = logprobs
        return {
            "id": self.request_id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [choice],
        }

    def on_output(self, out: RequestOutput) -> List[bytes]:
        frames: List[bytes] = []
        if out.usage:
            self._usage = out.usage
        for seq in out.outputs:
            if seq.index not in self._sent_role:
                frames.append(sse_frame(
                    self._chunk({"role": "assistant"}, seq.index)))
                self._sent_role.add(seq.index)
            if seq.text or seq.logprobs or (self.emit_token_ids
                                            and seq.token_ids):
                # A token whose text delta is empty (UTF-8 or stop-string
                # holdback) still carries its logprob entry, and under
                # the ledger its token ids.
                chunk = self._chunk(
                    {"content": seq.text}, seq.index,
                    logprobs=_chat_logprobs_json(seq.logprobs))
                if self.emit_token_ids and seq.token_ids:
                    chunk["xllm"] = {"token_ids": list(seq.token_ids)}
                frames.append(sse_frame(chunk))
            if seq.finish_reason != FinishReason.NONE:
                frames.append(sse_frame(
                    self._chunk({}, seq.index, seq.finish_reason.openai)))
        if out.finished:
            if self.include_usage:
                frames.append(sse_frame({
                    "id": self.request_id,
                    "object": "chat.completion.chunk",
                    "created": self.created,
                    "model": self.model,
                    "choices": [],
                    "usage": self._usage.to_json(),
                }))
            frames.append(SSE_DONE)
        return frames


class CompletionStreamAssembler:
    """Text-completion SSE chunks (response_handler.cpp:218-278);
    ``emit_token_ids`` as in ``ChatStreamAssembler``."""

    def __init__(self, request_id: str, model: str,
                 include_usage: bool = False,
                 emit_token_ids: bool = False) -> None:
        self.request_id = request_id
        self.model = model
        self.include_usage = include_usage
        self.emit_token_ids = emit_token_ids
        self.created = _now()
        self._usage = Usage()
        self._lp: Dict[int, _CompletionLogprobs] = {}

    def _chunk(self, text: str, index: int = 0,
               finish_reason: Optional[str] = None,
               logprobs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return {
            "id": self.request_id,
            "object": "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": [{"index": index, "text": text,
                         "logprobs": logprobs,
                         "finish_reason": finish_reason}],
        }

    def on_output(self, out: RequestOutput) -> List[bytes]:
        frames: List[bytes] = []
        if out.usage:
            self._usage = out.usage
        for seq in out.outputs:
            lp_json = None
            if seq.logprobs:
                # Per-index accumulator keeps text_offset global across
                # the whole completion; each chunk ships only its new
                # entries.
                acc = self._lp.setdefault(seq.index, _CompletionLogprobs())
                before = len(acc.tokens)
                acc.add(seq.logprobs)
                lp_json = {
                    "tokens": acc.tokens[before:],
                    "token_logprobs": acc.token_logprobs[before:],
                    "top_logprobs": acc.top_logprobs[before:],
                    "text_offset": acc.text_offset[before:],
                }
            if seq.text or seq.logprobs or (self.emit_token_ids
                                            and seq.token_ids):
                chunk = self._chunk(seq.text, seq.index, logprobs=lp_json)
                if self.emit_token_ids and seq.token_ids:
                    chunk["xllm"] = {"token_ids": list(seq.token_ids)}
                frames.append(sse_frame(chunk))
            if seq.finish_reason != FinishReason.NONE:
                frames.append(sse_frame(
                    self._chunk("", seq.index,
                                seq.finish_reason.openai)))
        if out.finished:
            if self.include_usage:
                frames.append(sse_frame({
                    "id": self.request_id,
                    "object": "text_completion",
                    "created": self.created,
                    "model": self.model,
                    "choices": [],
                    "usage": self._usage.to_json(),
                }))
            frames.append(SSE_DONE)
        return frames


class ResponseCollector:
    """Aggregates streamed RequestOutputs into one non-stream OpenAI body
    (all ``n`` choices, logprobs, usage).

    ``target_n``: server-side ``best_of`` selection. When more candidate
    choices were generated than requested, the ``target_n`` with the
    highest mean token logprob (the finish delta's ``mean_logprob``;
    a candidate without one ranks last) are kept, renumbered 0 ..
    target_n - 1. Usage still counts every candidate's tokens."""

    def __init__(self, request_id: str, model: str, is_chat: bool,
                 target_n: Optional[int] = None) -> None:
        self.request_id = request_id
        self.model = model
        self.is_chat = is_chat
        self.target_n = target_n
        self.usage = Usage()
        self._texts: Dict[int, List[str]] = {}
        self._finish: Dict[int, FinishReason] = {}
        self._chat_lps: Dict[int, List[LogProb]] = {}
        self._cmpl_lps: Dict[int, _CompletionLogprobs] = {}
        self._mean_lp: Dict[int, float] = {}

    def add(self, out: RequestOutput) -> None:
        if out.usage:
            self.usage = out.usage
        for seq in out.outputs:
            self._texts.setdefault(seq.index, []).append(seq.text)
            if seq.finish_reason != FinishReason.NONE:
                self._finish[seq.index] = seq.finish_reason
            if seq.mean_logprob is not None:
                self._mean_lp[seq.index] = seq.mean_logprob
            if seq.logprobs:
                if self.is_chat:
                    self._chat_lps.setdefault(seq.index, []).extend(
                        seq.logprobs)
                else:
                    self._cmpl_lps.setdefault(
                        seq.index, _CompletionLogprobs()).add(seq.logprobs)

    def body(self) -> Dict[str, Any]:
        indices = sorted(self._texts) or [0]
        if self.target_n is not None and len(indices) > self.target_n:
            indices = sorted(
                indices,
                key=lambda i: self._mean_lp.get(i, float("-inf")),
                reverse=True)[:self.target_n]
        choices = []
        for rank, i in enumerate(indices):
            text = "".join(self._texts.get(i, []))
            finish = self._finish.get(i, FinishReason.STOP)
            if self.is_chat:
                choice: Dict[str, Any] = {
                    "index": rank,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish.openai or "stop",
                }
                lps = self._chat_lps.get(i)
                choice["logprobs"] = _chat_logprobs_json(lps or [])
            else:
                choice = {
                    "index": rank,
                    "text": text,
                    "logprobs": (self._cmpl_lps[i].to_json()
                                 if i in self._cmpl_lps else None),
                    "finish_reason": finish.openai or "stop",
                }
            choices.append(choice)
        return {
            "id": self.request_id,
            "object": "chat.completion" if self.is_chat
            else "text_completion",
            "created": _now(),
            "model": self.model,
            "choices": choices,
            "usage": self.usage.to_json(),
        }
