"""Request/response value types of the worker: sampling parameters,
finish reasons and the per-step output records the OpenAI assemblers
consume.

A copy of the JAX package's ``utils/types.py`` subset that the worker
serves, with the same field names and JSON shapes.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, List, Optional


class FinishReason(str, enum.Enum):
    NONE = ""
    STOP = "stop"
    LENGTH = "length"
    FUNCTION_CALL = "function_call"
    CANCELLED = "cancelled"

    @property
    def openai(self) -> Optional[str]:
        return self.value or None


@dataclasses.dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens

    def to_json(self) -> Dict[str, Any]:
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.total_tokens}


@dataclasses.dataclass
class LogProb:
    token: str = ""
    token_id: int = 0
    # None = OpenAI's null for the very first prompt token under
    # ``echo`` (no prefix to condition on).
    logprob: Optional[float] = 0.0
    top_logprobs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SequenceOutput:
    index: int = 0
    text: str = ""
    token_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: FinishReason = FinishReason.NONE
    logprobs: List[LogProb] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RequestOutput:
    """One generation update for a request (a token delta or the final
    chunk)."""

    request_id: str = ""
    service_request_id: str = ""
    outputs: List[SequenceOutput] = dataclasses.field(default_factory=list)
    usage: Optional[Usage] = None
    finished: bool = False
    cancelled: bool = False


@dataclasses.dataclass
class SamplingParams:
    """Full OpenAI sampling contract (reference carries these end to end:
    xllm/chat.proto:1-192, completion.proto:1-143). Every field here is
    honored by the engine — none are accepted-and-ignored."""

    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    # Completion API: generate ``best_of`` candidates server-side, return
    # the ``n`` with the highest mean token logprob (None → best_of == n).
    best_of: Optional[int] = None
    # Completion API: prepend the prompt to every choice's text; with
    # ``logprobs`` also score the prompt tokens (first one null).
    echo: bool = False
    # OpenAI logit_bias: token_id → additive bias (-100..100; -100 ≈ ban,
    # +100 ≈ force). The reference carries this as an unimplemented TODO
    # (completion.proto:82-84, chat.proto:90-92); here the engine applies
    # it inside the fused sampling step.
    logit_bias: Optional[Dict[int, float]] = None
    stop: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    seed: Optional[int] = None
    logprobs: bool = False
    top_logprobs: int = 0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    ignore_eos: bool = False

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "SamplingParams":
        if not d:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        out = cls(**{k: v for k, v in d.items() if k in known})
        if out.logit_bias:
            out.logit_bias = _parse_logit_bias(out.logit_bias)
        return out


def parse_openai_sampling(body: Dict[str, Any],
                          is_chat: bool) -> SamplingParams:
    """Normalize an OpenAI request body into SamplingParams.

    Field quirks handled here once (service and direct-to-worker paths
    share it): ``max_completion_tokens`` aliases ``max_tokens``; ``stop``
    may be a string or a list; the completion API's ``logprobs`` is an
    int (top-k count) while the chat API uses ``logprobs: bool`` +
    ``top_logprobs: int``."""
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    if is_chat:
        logprobs = bool(body.get("logprobs", False))
        top_logprobs = int(body.get("top_logprobs") or 0)
    else:
        lp = body.get("logprobs")
        logprobs = lp is not None and lp is not False
        top_logprobs = int(lp) if isinstance(lp, int) else 0
    best_of = body.get("best_of")
    return SamplingParams(
        max_tokens=int(body.get("max_tokens",
                                body.get("max_completion_tokens", 16))),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        n=int(body.get("n", 1)),
        # best_of / echo are completion-API fields (reference
        # completion.proto:21, :40)
        best_of=(int(best_of) if not is_chat and best_of is not None
                 else None),
        echo=bool(body.get("echo", False)) and not is_chat,
        logit_bias=_parse_logit_bias(body.get("logit_bias")),
        stop=[str(s) for s in stop],
        stop_token_ids=list(body.get("stop_token_ids") or []),
        seed=body.get("seed"),
        logprobs=logprobs,
        top_logprobs=top_logprobs,
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        ignore_eos=bool(body.get("ignore_eos", False)))


_LOGIT_BIAS_MAX_ENTRIES = 300      # OpenAI's documented cap


def _parse_logit_bias(lb: Any) -> Optional[Dict[int, float]]:
    """JSON logit_bias (object with string token-id keys) → {int: float}.
    Raises ValueError on malformed input — callers map to HTTP 400.

    Enforced here because every entry becomes device state: the entry
    cap bounds the engine's padded bias width (and its pow2 compile
    buckets), and the [-100, 100]/finite rule keeps a client from
    scatter-adding NaN/Inf into a shared batch's logits."""
    if not lb:
        return None
    if not isinstance(lb, dict):
        raise ValueError("logit_bias must be an object of "
                         "token_id -> bias")
    if len(lb) > _LOGIT_BIAS_MAX_ENTRIES:
        raise ValueError(f"logit_bias accepts at most "
                         f"{_LOGIT_BIAS_MAX_ENTRIES} entries")
    try:
        out = {int(k): float(v) for k, v in lb.items()}
    except (TypeError, ValueError) as e:
        raise ValueError(f"invalid logit_bias entry: {e}") from e
    for tid, val in out.items():
        if tid < 0:
            raise ValueError(f"logit_bias token id {tid} is negative")
        if not (math.isfinite(val) and -100.0 <= val <= 100.0):
            raise ValueError(
                f"logit_bias value for token {tid} must be a finite "
                f"number in [-100, 100]")
    return out


def validate_sampling(sp: SamplingParams, stream: bool) -> None:
    """OpenAI cross-field rules, shared by the service front door and the
    direct-to-worker path. Raises ValueError (callers map to HTTP 400)."""
    if sp.n < 1:
        raise ValueError("n must be >= 1")
    if sp.best_of is not None:
        if sp.best_of < sp.n:
            raise ValueError("best_of must be >= n")
        if stream and sp.best_of > sp.n:
            raise ValueError("best_of > n cannot be used with streaming")
