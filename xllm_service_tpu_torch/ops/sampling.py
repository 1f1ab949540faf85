"""Token sampling: greedy, temperature, top-k and top-p, batched.

Randomness comes from explicit ``torch.Generator`` objects, never from
the global generator. A row with a request ``seed`` draws from its own
generator seeded by (seed, position), so its stream does not depend on
which other requests share the batch. These streams differ from the JAX
package's, whose seeded rows use threefry ``fold_in(PRNGKey(seed),
position)``: the two packages agree on greedy rows only.

Presence/frequency penalties, ``logit_bias`` and top-k alternative
logprobs are not part of this package yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from xllm_service_tpu_torch.utils.types import SamplingParams

_NEG_INF = -1e30


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _apply_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Joint top-k + nucleus filter from ONE descending sort. top_k == 0
    disables top-k; the nucleus always keeps the top token."""
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    kth = torch.gather(sorted_logits, 1, (k[:, None] - 1).clamp(0, vocab - 1))
    # Nucleus: keep ranks whose exclusive cumulative mass is below top_p;
    # softmax is monotone, so the boundary rank maps back to a logit.
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    num_keep = torch.sum(cumulative - sorted_probs < top_p[:, None], dim=-1)
    nucleus_kth = torch.gather(sorted_logits, 1,
                               (num_keep[:, None] - 1).clamp(0, vocab - 1))
    return torch.where(logits >= torch.maximum(kth, nucleus_kth), logits,
                       torch.full_like(logits, _NEG_INF))


def _row_seed(seed: int, position: int) -> int:
    return ((int(seed) & 0x7FFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))


def sample_tokens(logits: torch.Tensor, params: Sequence[SamplingParams],
                  generator: torch.Generator,
                  positions: Optional[List[int]] = None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] (rows past ``params`` are
    padding and sampled greedily). ``positions`` [B] are the rows'
    generation positions, which seed per-request streams."""
    logits = logits.float()
    B, dev = logits.shape[0], logits.device
    padded = list(params) + [SamplingParams(temperature=0.0)] * (
        B - len(params))
    greedy_tok = greedy(logits)
    sampled_rows = [i for i, p in enumerate(padded) if p.temperature > 0.0]
    if not sampled_rows:
        return greedy_tok
    temp = torch.tensor([max(p.temperature, 1e-6) for p in padded],
                        device=dev)[:, None]
    scaled = logits / temp
    if any(padded[i].top_k > 0 or padded[i].top_p < 1.0
           for i in sampled_rows):
        top_k = torch.tensor([p.top_k for p in padded], device=dev)
        top_p = torch.tensor([p.top_p for p in padded], device=dev)
        scaled = _apply_top_k_top_p(scaled, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    out = greedy_tok.clone()
    unseeded = [i for i in sampled_rows if padded[i].seed is None]
    if unseeded:
        idx = torch.tensor(unseeded, device=dev)
        draw = torch.multinomial(probs[idx], 1, generator=generator)[:, 0]
        out[idx] = draw
    for i in sampled_rows:
        if padded[i].seed is None:
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(_row_seed(padded[i].seed,
                                positions[i] if positions else 0))
        out[i] = torch.multinomial(probs[i:i + 1], 1, generator=g)[0, 0]
    return out


def compute_logprobs(logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Log-prob of each chosen token: [B, V], [B] -> [B] float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, tokens.long()[:, None])[:, 0]
