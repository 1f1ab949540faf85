"""Token sampling: greedy, temperature, top-k, top-p, presence and
frequency penalties, ``logit_bias`` and per-request seeds, batched.

The counterpart of the JAX package's ``ops/sampling.py``. Per-slot
sampling parameters live in dense tensors (``SamplingTensors``, packed as
the JAX package packs them: float32 [B, 4] and int32 [B, 2]), so one
function serves every request mix without branching on it:
``sample_packed`` adds the sparse ``logit_bias`` ([B, K] ids and values,
padding (0, +0.0)), subtracts the penalties over the output-token counts
[B, V] when it is given them, always runs the top-k / top-p filter (k = 0
and p = 1 are exact no-ops), draws every sampled row by Gumbel-max and
picks greedy rows with ``where(temperature == 0, argmax, draw)``. It
makes no host read and builds no tensor from host lists, so a step can
be captured in a CUDA graph with it.

The noise of a row whose request carries a ``seed`` (>= 0) is the JAX
package's: ``gumbel(fold_in(PRNGKey(seed), position), (V,))``, with the
threefry2x32 hash as jax 0.9 runs it (``jax_threefry_partitionable``),
computed here in plain torch on uint32 values carried in int64 (``_M32``
masks every sum and rotation). Its token therefore equals the JAX
engine's, whatever else shares the batch. Unseeded rows draw from the
engine's generator (``torch.rand``): their streams are not the JAX
package's, whose unseeded rows split a key chain.

The top-p filter differs from the JAX package's in one corner: there a
``lax.cond`` skips the filter unless some sampled row sets top_k or
top_p, and a row with top_p = 1 inside a filtered batch keeps only the
ranks whose exclusive cumulative mass rounds below 1; here top_p >= 1
always keeps the whole vocabulary. The two differ only in a tail of
tokens whose mass is below float32 rounding of the cumulative sum.

Reported logprobs (``compute_logprobs``, ``compute_top_logprobs``) come
from the raw logits, before bias, penalties or temperature.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from xllm_service_tpu_torch.utils.types import SamplingParams

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
# threefry2x32's rotations: rounds alternate between the two sets.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass
class SamplingTensors:
    """Per-slot sampling state, [B] each."""

    temperature: torch.Tensor           # float32; 0.0 -> greedy
    top_p: torch.Tensor                 # float32 in (0, 1]
    top_k: torch.Tensor                 # int; 0 -> disabled
    presence: torch.Tensor              # float32; 0.0 -> off
    frequency: torch.Tensor             # float32; 0.0 -> off
    seed: torch.Tensor                  # int; -1 (any < 0) -> unseeded

    @staticmethod
    def pack_batch(params_list: Sequence[SamplingParams]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The JAX package's packed pair: float32 [B, 4] (temperature,
        top_p, presence, frequency) and int32 [B, 2] (top_k, seed; -1
        when unseeded). A seed outside int32 raises OverflowError, as
        there."""
        f32 = np.empty((len(params_list), 4), np.float32)
        i32 = np.empty((len(params_list), 2), np.int32)
        for i, p in enumerate(params_list):
            f32[i, 0] = p.temperature
            f32[i, 1] = p.top_p
            f32[i, 2] = p.presence_penalty
            f32[i, 3] = p.frequency_penalty
            i32[i, 0] = p.top_k
            i32[i, 1] = -1 if p.seed is None else int(p.seed)
        return f32, i32

    @classmethod
    def unpack(cls, f32: torch.Tensor, i32: torch.Tensor
               ) -> "SamplingTensors":
        """Views of the packed pair's columns (no copy)."""
        return cls(temperature=f32[:, 0], top_p=f32[:, 1],
                   presence=f32[:, 2], frequency=f32[:, 3],
                   top_k=i32[:, 0], seed=i32[:, 1])

    @classmethod
    def from_packed(cls, packed: Tuple[np.ndarray, np.ndarray],
                    device) -> "SamplingTensors":
        f32, i32 = packed
        return cls.unpack(torch.from_numpy(np.ascontiguousarray(f32))
                          .to(device),
                          torch.from_numpy(np.ascontiguousarray(i32))
                          .to(device))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# threefry2x32 (jax.random's default PRNG) on uint32 values held in int64
# ---------------------------------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 hash of counts (x1, x2) under key (k1,
    k2): int64 tensors holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey(seed)`` of non-negative int64 seeds: the
    key's two words (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = seed.long()
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Tuple[torch.Tensor, torch.Tensor], data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: the hash of the counts (0, data)."""
    data = data.long() & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def split(key: Tuple[torch.Tensor, torch.Tensor], num: int
          ) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key (partitionable form):
    [num, 2] int64 words."""
    counts = torch.arange(num, dtype=torch.int64, device=key[0].device)
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: Tuple[torch.Tensor, torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, partitionable form) for
    keys of any batch shape K: [*K, *shape] int64. The counts are the
    row-major index over ``shape`` as a uint64 (hi, lo) pair."""
    k1, k2 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    n = int(np.prod(shape)) if len(shape) else 1
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    counts = counts.reshape(tuple(shape))
    lead = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(k1[lead], k2[lead], counts >> 32, counts & _M32)
    return b1 ^ b2


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` in its default mode ("low") from its 32
    random bits: uniform in [tiny, 1) by the mantissa trick (bits >> 9
    under the exponent of 1.0, minus 1), then -log(-log(u))."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = torch.clamp_min(mant.view(torch.float32) - 1.0 + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def seeded_gumbel(seed: torch.Tensor, positions: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """[B, vocab] Gumbel noise of each row's key ``fold_in(PRNGKey(
    max(seed, 0)), position)`` (the JAX package's ``_row_keys``)."""
    key = fold_in(prng_key(seed.long().clamp(min=0)), positions)
    return gumbel_from_bits(random_bits(key, (vocab,)))


# ---------------------------------------------------------------------------
# Penalties, bias and the filter
# ---------------------------------------------------------------------------

def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    st: SamplingTensors) -> torch.Tensor:
    """OpenAI presence/frequency penalties over the output-token
    ``counts`` [B, V] (generated tokens only, the prompt excluded)."""
    logits = logits.float()
    return logits - st.frequency[:, None] * counts.float() \
        - st.presence[:, None] * (counts > 0).float()


def update_counts(counts: torch.Tensor, tokens: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Add this step's sampled ``tokens`` [B] to the histogram, in
    place; inactive rows are unchanged. Returns ``counts``."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    counts.index_put_((rows, tokens.long()), active.to(counts.dtype),
                      accumulate=True)
    return counts


def apply_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
               bias_vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add the padded sparse ``logit_bias`` ([B, K] ids and
    values; padding (0, +0.0) adds nothing)."""
    return logits.float().scatter_add(1, bias_ids.long(), bias_vals)


def _apply_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Joint top-k + nucleus filter from ONE descending sort. top_k == 0
    disables top-k and top_p >= 1 the nucleus (each then keeps every
    logit, exactly); the nucleus always keeps the top token."""
    vocab = logits.shape[-1]
    top_k = top_k.long()
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    kth = torch.gather(sorted_logits, 1, (k[:, None] - 1).clamp(0, vocab - 1))
    # Nucleus: keep ranks whose exclusive cumulative mass is below top_p;
    # softmax is monotone, so the boundary rank maps back to a logit.
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    num_keep = torch.sum(cumulative - sorted_probs < top_p[:, None], dim=-1)
    # The rounded mass can reach 1 before the last rank: p >= 1 keeps
    # all (the JAX package keeps only the ranks below the rounded 1
    # there; see the module docstring).
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


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_packed(logits: torch.Tensor, st: SamplingTensors,
                  generator: torch.Generator, greedy_only: bool = False,
                  seeded: bool = False,
                  positions: Optional[torch.Tensor] = None,
                  counts: Optional[torch.Tensor] = None,
                  bias_ids: Optional[torch.Tensor] = None,
                  bias_vals: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One token per row of ``logits`` [B, V]: argmax where the row's
    temperature is 0, else a Gumbel-max draw over the filtered, scaled
    logits. ``logit_bias`` (``bias_ids``/``bias_vals``) and the
    penalties over ``counts`` apply to every row, greedy ones too.

    ``greedy_only`` (every row greedy, known on the host) skips the
    filter and the draw. Otherwise ``generator`` draws every row's noise
    (every call advances it by the same amount for the same shape), and
    with ``seeded`` the rows whose seed is >= 0 take the threefry noise
    of (seed, ``positions``) instead."""
    logits = logits.float()
    if bias_ids is not None:
        logits = apply_bias(logits, bias_ids, bias_vals)
    if counts is not None:
        logits = apply_penalties(logits, counts, st)
    greedy_tok = greedy(logits)
    if greedy_only:
        return greedy_tok
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    noise = -torch.log(-torch.log(u))
    if seeded:
        noise = torch.where((st.seed >= 0)[:, None],
                            seeded_gumbel(st.seed, positions,
                                          logits.shape[-1]),
                            noise)
    draw = greedy(filtered_scaled(logits, st) + noise)
    return torch.where(st.temperature > 0.0, draw, greedy_tok)


def batch_mode(params: Sequence[SamplingParams]) -> Tuple[bool, bool]:
    """(greedy_only, seeded) of a batch: no row samples; some sampled
    row carries a seed >= 0 (a negative seed is unseeded, as in the JAX
    package's packing)."""
    sampled = [p for p in params if p.temperature > 0.0]
    return (not sampled,
            any(p.seed is not None and p.seed >= 0 for p in sampled))


def bias_width(params: Sequence[SamplingParams], base: int = 8) -> int:
    """Columns of a batch's padded ``logit_bias``: ``base``, doubled
    until it holds the longest request's entries (the JAX engine's
    pow2 buckets above ``_BIAS_K``)."""
    mx = max((len(p.logit_bias) for p in params if p.logit_bias),
             default=0)
    k = base
    while k < mx:
        k <<= 1
    return k


def batch_bias(params: Sequence[SamplingParams], B: int, V: int,
               K: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The padded sparse ``logit_bias`` of ``params`` (rows past them
    padding): int32 [B, K] ids and float32 [B, K] values, (0, +0.0)
    where unused; ids outside [0, V) are dropped (the JAX engine's
    ``_batch_bias``)."""
    K = bias_width(params) if K is None else K
    ids = np.zeros((B, K), np.int32)
    vals = np.zeros((B, K), np.float32)
    for i, p in enumerate(params):
        if not p.logit_bias:
            continue
        j = 0
        for tid, val in p.logit_bias.items():
            if 0 <= tid < V:
                ids[i, j] = tid
                vals[i, j] = val
                j += 1
    return ids, vals


def sample_tokens(logits: torch.Tensor, params: Sequence[SamplingParams],
                  generator: torch.Generator,
                  positions: Optional[List[int]] = None,
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] (rows past ``params`` are
    padding and sampled greedily): the plain call of ``sample_packed``
    from host parameters. ``positions`` [B] are the rows' positions
    (the seeded rows' fold-in data); ``counts`` [B, V] turns the
    penalties on."""
    B, V = logits.shape
    padded = list(params) + [SamplingParams(temperature=0.0)] * (
        B - len(params))
    st = SamplingTensors.from_packed(SamplingTensors.pack_batch(padded),
                                     logits.device)
    greedy_only, seeded = batch_mode(padded)
    ids, vals = batch_bias(padded, B, V)
    pos = torch.tensor(positions if positions is not None else [0] * B,
                       dtype=torch.int64, device=logits.device)
    return sample_packed(
        logits, st, generator, greedy_only, seeded, pos, counts,
        torch.from_numpy(ids).to(logits.device),
        torch.from_numpy(vals).to(logits.device))


def compute_logprobs(logits: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Log-prob of each chosen token: [B, V], [B] -> [B] float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, tokens.long()[:, None])[:, 0]


def compute_top_logprobs(logits: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` alternative logprobs of the model distribution: [B, V]
    -> (ids [B, k] int64, logprobs [B, k] float32), best first."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    top_lps, top_ids = torch.topk(logp, k, dim=-1)
    return top_ids, top_lps
