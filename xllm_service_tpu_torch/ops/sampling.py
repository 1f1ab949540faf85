"""Token sampling: greedy, temperature, top-k and top-p, batched.

Per-slot sampling parameters live in dense tensors (``SamplingTensors``,
the JAX package's packed sampling state), so one function serves every
request mix without branching on it: ``sample_packed`` always runs the
top-k / top-p filter (k = 0 and p = 1 are exact no-ops), draws every
row by Gumbel-max over ``torch.rand`` from the engine's one generator,
and picks greedy rows with ``where(temperature == 0, argmax, draw)``. It
makes no host read and builds no tensor from host lists, so a decode
step can be captured in a CUDA graph with it.

A row with a request ``seed`` draws from its own generator seeded by
(seed, position), so its stream does not depend on which other requests
share the batch; such rows are drawn eagerly after the packed draw
(``sample_seeded``). These streams differ from the JAX package's, whose
rows draw with threefry (``fold_in(PRNGKey(seed), position)``): the two
packages agree on greedy rows only.

Presence/frequency penalties, ``logit_bias`` and top-k alternative
logprobs are not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from xllm_service_tpu_torch.utils.types import SamplingParams

_NEG_INF = -1e30


@dataclasses.dataclass
class SamplingTensors:
    """Per-slot sampling state, [B] each."""

    temperature: torch.Tensor           # float32; 0.0 -> greedy
    top_p: torch.Tensor                 # float32 in (0, 1]
    top_k: torch.Tensor                 # int64; 0 -> disabled

    @staticmethod
    def pack_batch(params_list: Sequence[SamplingParams]) -> np.ndarray:
        """[B, 3] float64 host block (temperature, top_p, top_k): the
        form the engine keeps per slot and compares before an upload."""
        out = np.empty((len(params_list), 3), np.float64)
        for i, p in enumerate(params_list):
            out[i] = (p.temperature, p.top_p, p.top_k)
        return out

    @classmethod
    def from_packed(cls, packed: np.ndarray, device) -> "SamplingTensors":
        t = torch.from_numpy(np.ascontiguousarray(packed))
        return cls(temperature=t[:, 0].float().to(device),
                   top_p=t[:, 1].float().to(device),
                   top_k=t[:, 2].long().to(device))

    @classmethod
    def zeros(cls, B: int, device) -> "SamplingTensors":
        return cls(temperature=torch.zeros(B, device=device),
                   top_p=torch.ones(B, device=device),
                   top_k=torch.zeros(B, dtype=torch.int64, device=device))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _apply_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Joint top-k + nucleus filter from ONE descending sort. top_k == 0
    disables top-k and top_p >= 1 the nucleus (each then keeps every
    logit, exactly); the nucleus always keeps the top token."""
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    kth = torch.gather(sorted_logits, 1, (k[:, None] - 1).clamp(0, vocab - 1))
    # Nucleus: keep ranks whose exclusive cumulative mass is below top_p;
    # softmax is monotone, so the boundary rank maps back to a logit.
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    num_keep = torch.sum(cumulative - sorted_probs < top_p[:, None], dim=-1)
    # The rounded mass can reach 1 before the last rank: p >= 1 keeps all.
    num_keep = torch.where(top_p >= 1.0, torch.full_like(num_keep, vocab),
                           num_keep)
    nucleus_kth = torch.gather(sorted_logits, 1,
                               (num_keep[:, None] - 1).clamp(0, vocab - 1))
    return torch.where(logits >= torch.maximum(kth, nucleus_kth), logits,
                       torch.full_like(logits, _NEG_INF))


def filtered_scaled(logits: torch.Tensor,
                    st: SamplingTensors) -> torch.Tensor:
    """float32 logits over the rows' temperatures, top-k / top-p
    filtered."""
    temp = st.temperature.clamp(min=1e-6)[:, None]
    return _apply_top_k_top_p(logits.float() / temp, st.top_k, st.top_p)


def sample_packed(logits: torch.Tensor, st: SamplingTensors,
                  generator: torch.Generator, greedy_only: bool = False
                  ) -> torch.Tensor:
    """One token per row of ``logits`` [B, V]: argmax where the row's
    temperature is 0, else a Gumbel-max draw over the filtered, scaled
    logits from ``generator`` (which every call advances by the same
    amount for the same shape). ``greedy_only`` (every row greedy, known
    on the host) skips the filter and the draw."""
    logits = logits.float()
    greedy_tok = greedy(logits)
    if greedy_only:
        return greedy_tok
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    draw = greedy(filtered_scaled(logits, st) - torch.log(-torch.log(u)))
    return torch.where(st.temperature > 0.0, draw, greedy_tok)


def _row_seed(seed: int, position: int) -> int:
    return ((int(seed) & 0x7FFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))


def sample_seeded(tokens: torch.Tensor, logits: torch.Tensor,
                  st: SamplingTensors, rows: Sequence[int],
                  seeds: Sequence[int], positions: Sequence[int]) -> None:
    """Overwrite ``tokens[rows]`` with draws from per-row generators
    seeded by (seed, position): a request's stream then does not depend
    on its batch. Eager only (a generator per row)."""
    if not rows:
        return
    idx = list(rows)
    probs = torch.softmax(filtered_scaled(logits[idx], SamplingTensors(
        st.temperature[idx], st.top_p[idx], st.top_k[idx])), dim=-1)
    for j, (i, seed, pos) in enumerate(zip(idx, seeds, positions)):
        g = torch.Generator(device=logits.device)
        g.manual_seed(_row_seed(seed, pos))
        tokens[i] = torch.multinomial(probs[j:j + 1], 1, generator=g)[0, 0]


def sample_tokens(logits: torch.Tensor, params: Sequence[SamplingParams],
                  generator: torch.Generator,
                  positions: Optional[List[int]] = None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] (rows past ``params`` are
    padding and sampled greedily). ``positions`` [B] are the rows'
    generation positions, which seed per-request streams."""
    B = logits.shape[0]
    padded = list(params) + [SamplingParams(temperature=0.0)] * (
        B - len(params))
    st = SamplingTensors.from_packed(SamplingTensors.pack_batch(padded),
                                     logits.device)
    sampled = [i for i, p in enumerate(padded) if p.temperature > 0.0]
    out = sample_packed(logits, st, generator, greedy_only=not sampled)
    seeded = [i for i in sampled if padded[i].seed is not None]
    sample_seeded(out, logits, st, seeded, [padded[i].seed for i in seeded],
                  [positions[i] if positions else 0 for i in seeded])
    return out


def compute_logprobs(logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Log-prob of each chosen token: [B, V], [B] -> [B] float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, tokens.long()[:, None])[:, 0]
